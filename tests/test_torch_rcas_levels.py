"""B2's inside kernel on the texels' 256 levels (csrc/rcas_sharpen.cu, the
RGBA8 specialization of rcas_sharpen_inside_kernel, full precision), its
algebra held on the CPU to the port's plain RCAS core
(ops/rcas.py::rcas_core), with NumPy float32 standing in for the card's
IEEE single ops.

The kernel takes RCAS's min4 and max4 of the cross as the byte min and max
of the packed taps (in 16-bit lanes), and its two correctly rounded
reciprocals, rcp(4 mx4) and rcp(4 mn4 - 4), with min4 and 1 - mx4, from two
256-entry tables of the levels that each CTA makes with ffx::rcas's own
ops on rgba8::channel's decode. Held here, exhaustively over every pair of
tap levels and at two sharpnesses: byte order is decoded order, and the
lanes' min and max give each channel's; hit_min, hit_max and each
channel's lobe from the tables equal the core's bit for bit and NaN for
NaN (its 0 * inf at flat black and white crosses among them), and so does
the whole output, whose exact pack (codec.cuh) gives the plain pack's
bytes; the max.NaN form of max3 keeps the lobe. The launch records count
those outputs (`levels`). The CUDA kernel itself runs only on the card:
`python3 chip_smoke.py` holds it to its plain torch version, texel for
texel.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openvr_fsr_tpu_torch.core import constants as C
from openvr_fsr_tpu_torch.kernels import _common, rcas
from openvr_fsr_tpu_torch.ops import common as ops_common
from openvr_fsr_tpu_torch.ops import rcas as ops_rcas
from openvr_fsr_tpu_torch.utils import trace

F32 = np.float32
CSRC = Path(__file__).resolve().parents[1] / "openvr_fsr_tpu_torch" / "csrc"
INV255 = F32(1.0) / F32(255.0)          # ffx::kInv255
TWO23 = F32(8388608.0)
LEVELS = np.arange(256, dtype=np.uint32)
SHARPNESS = (0.9, 0.2)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _decode(k):
    """rgba8::channel of level k: its integer times f32(1/255)."""
    return np.asarray(k).astype(np.float32) * INV255


def _tables():
    """(rcp_max, rcp_min) as the kernel's CTAs make them, one level per
    thread: rcp(4 v) and rcp(4 v - 4) of the decode v, each op rounded on
    its own (--fmad=false), the reciprocal correctly rounded."""
    v = _decode(LEVELS)
    with np.errstate(divide="ignore"):
        return (F32(1.0) / (F32(4.0) * v),
                F32(1.0) / (F32(4.0) * v + F32(-4.0)))


def _same(a, b):
    """Bit for bit where neither is NaN, and NaN where either is."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(
        _bits(a)[~nan], _bits(b)[~nan])


def test_byte_order_is_decoded_order():
    """The decode k -> k * (1/255) is strictly increasing over the 256
    levels and never NaN, so the byte min / max of the taps decode to
    min_nan / max_nan of the decoded taps; it is the port's unpack and the
    exact decode (2^23's bits with the byte in the low bits, one FMA)."""
    v = _decode(LEVELS)
    assert not np.isnan(v).any() and np.all(np.diff(v) > 0)
    assert (v[0], v[255]) == (0.0, 1.0)
    packed = torch.from_numpy((LEVELS * 0x00010101).view(np.int32))
    rgba = _common.unpack(packed.reshape(1, 16, 16), 4).numpy()
    for c in range(3):
        assert np.array_equal(_bits(rgba[0, c].ravel()), _bits(v))
    # exact::decode: the byte in the low bits of 2^23's is the float
    # 2^23 + k; fma(2^23 + k, inv, -2^23 inv) rounds once a value float64
    # holds exactly
    biased = (np.uint32(0x4B000000) | LEVELS).view(np.float32)
    assert np.array_equal(biased, TWO23 + LEVELS.astype(np.float32))
    fma = (biased.astype(np.float64) * float(INV255)
           - float(TWO23) * float(INV255)).astype(np.float32)
    assert np.array_equal(_bits(fma), _bits(v))


def _grid():
    """Per channel, every ordered pair (a, c) of tap levels once over a
    256x256 grid (the channels' pairs rolled against each other): the
    cross b = f = a, d = h = c, and a centre level e."""
    a, c = np.meshgrid(LEVELS, LEVELS, indexing="ij")
    taps = {"a": [], "c": [], "e": []}
    for ch in range(3):
        ac = np.roll(a, 85 * ch, axis=1)
        cc = np.roll(c, 37 * ch, axis=0)
        taps["a"].append(ac)
        taps["c"].append(cc)
        taps["e"].append((ac * 7 + cc * 13 + ch) % 256)
    return {k: np.stack(v) for k, v in taps.items()}      # (3, 256, 256)


def _levels_pixel(a, c, e, sharp):
    """The kernel's body on levels (rcas_levels), in NumPy float32:
    (hit_min, hit_max, lobe per channel, the output)."""
    rcp_max, rcp_min = _tables()
    mn, mx = np.minimum(a, c), np.maximum(a, c)          # byte order
    with np.errstate(invalid="ignore"):
        hit_min = _decode(mn) * rcp_max[mx]
        hit_max = (F32(1.0) - _decode(mx)) * rcp_min[mn]
        lobe_c = np.where(-hit_min > hit_max, -hit_min, hit_max)
        m = np.maximum(lobe_c[0], np.maximum(lobe_c[1], lobe_c[2]))
    limit = F32(-C.RCAS_LIMIT)
    m = np.where(m < F32(0.0), m, F32(0.0))
    lobe = np.where(limit > m, limit, m) * F32(sharp)
    x = F32(4.0) * lobe + F32(1.0)
    r = (np.uint32(0x7EF19FFF) - _bits(x)).view(np.float32)
    rcp_l = r * (-(r * x) + F32(2.0))
    b, d, ec = _decode(a), _decode(c), _decode(e)
    out = ((((lobe * b + lobe * d) + lobe * d) + lobe * b) + ec) * rcp_l
    return hit_min, hit_max, lobe_c, out


@pytest.mark.parametrize("sharpness", SHARPNESS)
def test_level_tables_give_the_plain_core_bit_for_bit(sharpness,
                                                      monkeypatch):
    """hit_min = mn4 * T[mx], hit_max = (1 - mx4) * T'[mn], each channel's
    lobe and the output equal rcas_core's, fed the decoded taps, bit for
    bit and NaN for NaN, over all 65,536 pairs of tap levels per
    channel."""
    sharp = float(C.fsr_rcas_con(C.rcas_stops_from_slider(sharpness)))
    g = _grid()
    seen = []
    real = ops_common.hlsl_max

    def spy(x, y):
        z = real(x, y)
        seen.append((x, y, z))
        return z
    monkeypatch.setattr(ops_rcas, "hlsl_max", spy)
    b = torch.from_numpy(_decode(g["a"]))[None]
    d = torch.from_numpy(_decode(g["c"]))[None]
    e = torch.from_numpy(_decode(g["e"]))[None]
    core = ops_rcas.rcas_core(b, d, e, b, d, sharp).numpy()[0]
    neg_hit_min, hit_max, lobe_c = (t.numpy()[0] for t in seen[0])

    t_min, t_max, t_lobe, out = _levels_pixel(g["a"], g["c"], g["e"], sharp)
    assert _same(-t_min, neg_hit_min)
    assert _same(t_max, hit_max)
    assert _same(t_lobe, lobe_c)
    assert _same(out, core)
    # the flat crosses' 0 * inf: black (hit_min) and white (hit_max)
    flat = g["a"] == g["c"]
    assert np.isnan(t_min[flat & (g["a"] == 0)]).all()
    assert np.isnan(t_max[flat & (g["a"] == 255)]).all()
    assert np.isfinite(out).all()


@pytest.mark.parametrize("sharpness", SHARPNESS)
def test_exact_pack_of_the_levels_output_is_the_plain_pack(sharpness):
    """The output is finite, so Rgba8::exact_pack (__saturatef, times 255
    plus 2^23 rounded to nearest even, the low byte) gives the plain
    pack's bytes (sat, times 255, rintf) for every value it takes here."""
    sharp = float(C.fsr_rcas_con(C.rcas_stops_from_slider(sharpness)))
    g = _grid()
    out = _levels_pixel(g["a"], g["c"], g["e"], sharp)[3]
    plain = np.rint(np.clip(out, F32(0.0), F32(1.0)) * F32(255.0))
    exact = _bits((np.clip(out, F32(0.0), F32(1.0)) * F32(255.0)) + TWO23)
    assert np.array_equal(exact >> 8, np.full(out.shape, 0x4B0000, np.uint32))
    assert np.array_equal(exact & 0xFF, plain.astype(np.uint32))
    assert out.min() < 0.0 < 1.0 < out.max()     # both clamps are taken


def _byte_perm(x, y, s):
    """__byte_perm (PTX prmt, default mode) for selectors without sign
    replication: byte i of the result is byte (s >> 4i) & 7 of {y, x}."""
    v = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(v.shape, np.uint64)
    for i in range(4):
        n = (s >> (4 * i)) & 15
        assert n < 8
        out |= ((v >> np.uint64(8 * n)) & np.uint64(255)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _lanes_min_max(words, fn):
    """fn (np.minimum / np.maximum) over the words' unsigned 16-bit lanes,
    as __vimin3_u16x2 / __vimax3_u16x2 take them."""
    lo = [w & np.uint32(0xFFFF) for w in words]
    hi = [w >> np.uint32(16) for w in words]
    return (fn.reduce(lo) | (fn.reduce(hi) << np.uint32(16))).astype(
        np.uint32)


def test_byte_lanes_order_each_channel():
    """The kernel's Pair (csrc/rcas_sharpen.cu): the byte permutes that
    spread a packed texel over two words of 16-bit lanes (R and B, G and
    A), the lanes' unsigned min and max over the cross's four taps, and
    the permutes that take a channel's byte back (level) give each
    channel's byte min and max, for seeded random crosses and the flat and
    extreme ones; the selectors are read from the source."""
    text = (CSRC / "rcas_sharpen.cu").read_text()
    ev, od = (int(s, 16) for s in re.search(
        r"__byte_perm\(word, 0u, (0x[0-9a-f]+)u\), "
        r"__byte_perm\(word, 0u, (0x[0-9a-f]+)u\)", text).groups())
    at_c2, at_c = (int(s, 16) for s in re.search(
        r"c == 2 \? (0x[0-9a-f]+)u : (0x[0-9a-f]+)u", text).groups())
    rng = np.random.default_rng(25)
    taps = rng.integers(0, 2**32, (4, 100_000), dtype=np.uint64).astype(
        np.uint32)
    taps[:, :256] = (LEVELS * 0x01010101)[None]            # flat crosses
    taps[:, 256:258] = [[0x00FF00FF], [0xFF00FF00], [0x00FF00FF],
                        [0xFF00FF00]]
    zero = np.zeros(taps.shape[1], np.uint32)
    pairs = [(_byte_perm(w, zero, ev), _byte_perm(w, zero, od)) for w in taps]
    for fn in (np.minimum, np.maximum):
        m_ev = _lanes_min_max([q[0] for q in pairs], fn)
        m_od = _lanes_min_max([q[1] for q in pairs], fn)
        for c in range(3):
            got = _byte_perm(m_od if c == 1 else m_ev, zero,
                             at_c2 if c == 2 else at_c)
            want = fn.reduce([(w >> np.uint32(8 * c)) & np.uint32(255)
                              for w in taps])
            assert np.array_equal(got, want)


def test_max_nan_instruction_keeps_the_lobe():
    """The kernel's max3_nan (PTX max.NaN: NaN if any operand is) differs
    from ffx::max3 (NaN-carrying selects) at most in the sign of a zero
    max, which the hlsl_min with 0 after it maps to 0 either way: the lobe
    keeps its bits over every lobe_c triple of the exhaustive grid."""
    g = _grid()
    lobe_c = _levels_pixel(g["a"], g["c"], g["e"], 1.0)[2]
    flat = lobe_c.reshape(3, -1)
    zero = flat == 0
    assert zero.any() and np.isnan(flat).any()
    limit = F32(-C.RCAS_LIMIT)

    def lobe(m):
        m = np.where(m < F32(0.0), m, F32(0.0))
        return np.where(limit > m, limit, m)
    ref = lobe(np.maximum(flat[0], np.maximum(flat[1], flat[2])))
    for sign in (F32(0.0), F32(-0.0)):
        with np.errstate(invalid="ignore"):
            m = np.maximum(flat[0], np.maximum(flat[1], flat[2]))
        m = np.where(m == 0, sign, m)
        m = np.where(np.isnan(flat).any(axis=0), F32(np.nan), m)
        assert _same(lobe(m), ref)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: kernel_fn takes its launch
    branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("color_bits,precision", [
    (8, "full"), (10, "full"), (8, "half"), (10, "half")])
@pytest.mark.parametrize("radius", [0.5, 2.0])
def test_launch_records_count_the_outputs_on_levels(color_bits, precision,
                                                    radius, monkeypatch):
    """Each launch record's `levels` is its inside outputs at RGBA8 and
    full precision (the body on the levels runs them all) and 0 at 10 bits
    and at half precision; the counters leave it out."""
    real = _common.kernel_fn

    def fake_kernel_fn(name, batch, shape, pad_to, reference, launch, *a,
                       **k):
        return real(name, batch, shape, pad_to, reference,
                    lambda img: (torch.zeros(1, dtype=torch.int32), 0),
                    *a, **k)
    monkeypatch.setattr(rcas, "kernel_fn", fake_kernel_fn)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    h, w = 72, 84
    cen = C.centres_payload(w, h, radius, ((0.5, 0.5), (0.5, 0.5)), [0, 1])
    fn = rcas.build_rcas_sharpen(2, h, w, sharpness=0.9, centres=cen,
                                 color_bits=color_bits, precision=precision)
    shape = (2, h, w, 4) if color_bits == 10 else (2, h, w)
    dtype = torch.uint16 if color_bits == 10 else torch.int32
    img = torch.Tensor._make_subclass(_FakeCuda, torch.zeros(shape,
                                                             dtype=dtype))
    trace.clear()
    try:
        fn(img)
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("process"):
                fn(img)
        launches = [r for r in trace.records() if r.name == "launch"]
        counts = trace.counters()
    finally:
        trace.clear()
    assert len(launches) == 2
    inside = int(_common.circle_mask(torch.as_tensor(cen), h, w,
                                     (16, 16)).sum())
    assert 0 < inside <= 2 * h * w
    want = inside if (color_bits, precision) == (8, "full") else 0
    for r in launches:
        assert r.info["inside"] == inside
        assert r.info["levels"] == want
    assert counts["inside_outputs"] == 2 * inside
    assert "levels" not in counts
