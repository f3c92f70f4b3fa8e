"""The row-band strips of the fused FSR kernel (B1) and CAS upscale (B5) at
precision="half", and every strip's DMA geometry with the band form of the
floor (B7), on the CPU.

The JAX builders take band_range and precision="half" together; so do the
port's. Their plain half strips are held bit for bit to the plain half
whole output (FSR and CAS, 8 and 10 bits, 24- and 32-row bands, split 3
ways and every band alone), and, strip by strip, to the JAX package's half
strip kernels in Pallas interpret mode. Each strip build publishes the strip
kernels' DMA geometry (kernels/_maps.py::band_geometry); the floor runs it
in its band form (kernels/sol.py, csrc/dma_floor.cu), stated here in numpy
from the tables the kernel launches with.

The CUDA strips and floors run only on the card: `python3 chip_smoke.py`
(phase 2b) holds the half strips to the half single launch and to their
plain bf16 versions there, and each strip's floor to its plain version.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu_torch import Config  # noqa: E402
from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.kernels import cas, fsr, sol  # noqa: E402
from openvr_fsr_tpu_torch.kernels._maps import input_padding  # noqa: E402
from openvr_fsr_tpu_torch.ops.common import HALF, lit  # noqa: E402
from openvr_fsr_tpu_torch.parallel import split_bands  # noqa: E402
from openvr_fsr_tpu_torch.utils import frames as FR  # noqa: E402

from torch_entry_calls import entry_calls  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
OFF_CENTRE = ((0.3, 0.6), (0.7, 0.4))
# kernel -> (its build function, band layout)
KERNELS = {
    "fsr_fused": (fsr.build_fsr_fused, fsr.fsr_band_layout),
    "cas_upscale": (cas.build_cas_upscale, cas.cas_band_layout),
}


def _frame(h, w, bits, seed=0):
    """(2, h, w) random packed RGBA8 as int32, or at 10 bits (2, h, w, 4)
    uint16 R10G10B10A2 with alpha in {0..3}."""
    rng = np.random.default_rng(seed)
    if bits == 10:
        x = rng.integers(0, 1024, (2, h, w, 4)).astype(np.uint16)
        x[..., 3] = rng.integers(0, 4, (2, h, w))
        return torch.from_numpy(x)
    return torch.from_numpy(rng.integers(0, 2**32, (2, h, w),
                                         dtype=np.uint32).view(np.int32))


def _builds(kernel, h, w, band_rows, n, bits=8, precision="half",
            radius=0.6, eyes=OFF_CENTRE, rs=0.75):
    """(the whole build, [strip builds]) of `kernel`: n equal splits of the
    bands, or every band alone where n is None."""
    build, layout = KERNELS[kernel][:2]
    ow, oh = Config(render_scale=rs).output_size(w, h)
    cen = C.centres_payload(ow, oh, radius, eyes, (0, 1))
    kw = dict(sharpness=0.9, centres=cen, color_bits=bits,
              band_rows=band_rows, precision=precision)
    _, gy = layout(ow, oh, band_rows)
    return build(2, h, w, ow, oh, **kw), [
        build(2, h, w, ow, oh, band_range=r, **kw)
        for r in split_bands(gy, gy if n is None else n)]


def _strip(img, fn):
    return img[:, fn.in_row_base:fn.in_row_base + fn.in_rows].contiguous()


# ---- the plain half strips ---------------------------------------------------

@pytest.mark.parametrize("split", [3, None], ids=["split3", "alone"])
@pytest.mark.parametrize("band_rows", [24, 32])
@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_plain_half_strips_are_the_half_whole_output(kernel, bits,
                                                     band_rows, split):
    """At 2 x 60x72 -> 2 x 80x96 (off-centre eyes at radius 0.6: inside and
    outside tiles in every band), the half strips, concatenated, equal the
    half whole output bit for bit: RCAS's stage 1 one row beyond a band is
    rounded as in the whole output. 24-row bands cut 32-row tiles."""
    whole, strips = _builds(kernel, 72, 60, band_rows, split, bits)
    img = _frame(72, 60, bits)
    want = whole(img)
    outs = [fn(_strip(img, fn)) for fn in strips]
    assert all(fn.precision == "half" for fn in strips)
    assert [o.shape[1] for o in outs] == [fn.out_rows for fn in strips]
    assert torch.equal(torch.cat(outs, 1), want)
    full = _builds(kernel, 72, 60, band_rows, split, bits, "full")[0]
    assert not torch.equal(full(img), want)      # half is not full


# One process builds the JAX package's half whole output and half strips of
# B1 and B5 (Pallas interpret mode) over the bands argv[2] and runs them on
# the padded frames argv[1]; writes each one's output rows (argv[3]) and
# prints each strip's fn attributes.
JAX_STRIPS = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from openvr_fsr_tpu.kernels.cas import build_cas_upscale
from openvr_fsr_tpu.kernels.fsr import build_fsr_fused
h, w, ow, oh, bands, cen = json.loads(sys.argv[2])
padded = np.load(sys.argv[1])
out, meta = {}, {}
for name, build in (("fsr_fused", build_fsr_fused),
                    ("cas_upscale", build_cas_upscale)):
    kw = dict(sharpness=0.9, centres=np.array(cen), band_rows=32,
              precision="half", interpret=True)
    out[f"{name}:whole"] = np.asarray(build(2, h, w, ow, oh, **kw)(
        padded))[:, :oh, :ow]
    for g0, g1 in bands:
        fn = build(2, h, w, ow, oh, band_range=(g0, g1), **kw)
        x = padded[:, fn.in_row_base:fn.in_row_base + fn.in_rows]
        out[f"{name}:{g0}"] = np.asarray(fn(x))[:, :fn.out_rows]
        meta[f"{name}:{g0}"] = [int(fn.in_row_base), int(fn.in_rows),
                                int(fn.out_rows)]
np.savez(sys.argv[3], **out)
print(json.dumps(meta))
"""
# 2 x 70x90 (w x h) -> 2 x 93x120: 32-row bands, 4 of them, split 3 ways
JAX_SHAPE = (90, 70)


@pytest.fixture(scope="module")
def jax_half_strips(tmp_path_factory):
    """{(kernel, g0 or "whole"): the JAX half output rows}, {(kernel, g0):
    (in_row_base, in_rows, out_rows)}, and the case: one subprocess with
    XLA_FLAGS=--xla_allow_excess_precision=false (per-op rounding)."""
    h, w = JAX_SHAPE
    ow, oh = Config(render_scale=0.75).output_size(w, h)
    cen = C.centres_payload(ow, oh, 2.0, ((0.5, 0.5),) * 2, (0, 1))
    _, gy = fsr.fsr_band_layout(ow, oh, 32)
    bands = split_bands(gy, 3)
    rng = np.random.default_rng(17)
    frames = np.stack([FR.zone_plate_frame(h, w), FR.noise_frame(h, w, 5)])
    frames[..., 3] = rng.integers(0, 256, (2, h, w))
    packed = np.ascontiguousarray(frames).view(np.uint32)[..., 0]
    hp, wp = input_padding(h, w)
    tmp = tmp_path_factory.mktemp("jax_half_strips")
    np.save(tmp / "padded.npy",
            np.pad(packed, ((0, 0), (0, hp - h), (0, wp - w))))
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    r = subprocess.run(
        [sys.executable, "-c", JAX_STRIPS, str(tmp / "padded.npy"),
         json.dumps([h, w, ow, oh, bands, np.asarray(cen).tolist()]),
         str(tmp / "out.npz")], env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    meta = {tuple(k.split(":")): v for k, v in
            json.loads(r.stdout.splitlines()[-1]).items()}
    with np.load(tmp / "out.npz") as z:
        out = {tuple(k.split(":")): z[k] for k in z.files}
    return out, meta, dict(h=h, w=w, ow=ow, oh=oh, cen=cen, bands=bands,
                           packed=packed)


def _lsb(a, b):
    return np.abs(a.view(np.uint8).astype(np.int16)
                  - b.view(np.uint8).astype(np.int16))


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_half_strips_match_the_jax_half_strips(kernel, jax_half_strips):
    """The port's plain half strips against the JAX package's half strip
    kernels (Pallas interpret, per-op rounding), strip by strip, at 2 x
    70x90 -> 2 x 93x120, radius 2.0, band_rows 32, 4 bands split 3 ways:
    the same output rows per strip, each strip of either
    package its own half whole output's rows bit for bit, and per strip at
    most 2 LSB on at most 0.1% of values. Measured: CAS 0 unequal values;
    FSR 8 of 89,280 RGBA values (2 LSB at most), the same 8 in the whole
    outputs, so the strips add no difference of their own. The whole
    outputs' 8 are traced in tests/test_torch_half.py::
    test_half_fsr_ties_at_90x70 (ROADMAP Queue C 6): ties of the UNORM
    store that the JAX program, whose XLA CPU build fuses multiplies and
    adds, rounds the other way; RCAS doubles the 1 LSB. So the bar here is
    2 LSB and not the 1 LSB of test_half_pipeline_per_op at 2 x 48x56,
    where no tie flips."""
    out, meta, case = jax_half_strips
    build = KERNELS[kernel][0]
    kw = dict(sharpness=0.9, centres=case["cen"], band_rows=32,
              precision="half")
    whole = build(2, case["h"], case["w"], case["ow"], case["oh"], **kw)
    x = torch.from_numpy(np.ascontiguousarray(case["packed"]).view(np.int32))
    port_whole = whole(x).numpy().view(np.uint32)
    jax_whole = out[kernel, "whole"]
    d_whole = _lsb(port_whole, jax_whole)
    for g0, g1 in case["bands"]:
        fn = build(2, case["h"], case["w"], case["ow"], case["oh"],
                   band_range=(g0, g1), **kw)
        # the same output rows; the input strips differ by design (the
        # JAX one's rows aligned to 8, the port's the rows its kernels
        # read), so each runs on its own
        assert fn.out_rows == meta[kernel, str(g0)][2]
        r0 = g0 * 32
        rows = slice(r0, r0 + fn.out_rows)
        got = fn(_strip(x, fn)).numpy().view(np.uint32)
        want = out[kernel, str(g0)]
        assert got.shape == want.shape == (2, fn.out_rows, case["ow"])
        assert np.array_equal(got, port_whole[:, rows])
        assert np.array_equal(want, jax_whole[:, rows])
        d = _lsb(got, want)
        assert np.array_equal(d, d_whole[:, rows])
        assert d.max() <= 2 and (d > 0).mean() <= 1e-3, (g0, d.max(),
                                                          (d > 0).sum())
    assert int((d_whole > 0).sum()) == (8 if kernel == "fsr_fused" else 0)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_half_strips_build_and_publish_their_precision(kernel):
    """A half strip build publishes precision "half" and the strip
    attributes a full one does, and SpatialFsrPipeline stays at full
    precision (it passes none to the builders, as the JAX one)."""
    from openvr_fsr_tpu_torch.parallel import SpatialFsrPipeline
    _, half = _builds(kernel, 72, 60, 32, 3)
    _, full = _builds(kernel, 72, 60, 32, 3, precision="full")
    assert [fn.precision for fn in half] == ["half"] * 3
    for a, b in zip(half, full):
        assert (a.band_range, a.in_row_base, a.in_rows, a.out_rows) == (
            b.band_range, b.in_row_base, b.in_rows, b.out_rows)
    cfg = Config(enabled=True, render_scale=0.75, radius=0.5,
                 use_cas=kernel == "cas_upscale")
    sp = SpatialFsrPipeline(cfg, devices=[torch.device("cpu")] * 2)
    placed = sp.place(_frame(72, 60, 8).numpy().view(np.uint8).reshape(
        2, 72, 60, 4), eyes=(0, 1))
    sp.process_placed(placed)
    assert {fn.precision for fn in sp.kernels} == {"full"}


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_half_strip_launches_the_half_entry(kernel, bits, entry_calls):
    """On a CUDA tensor a half strip would call the half entry point of its
    texel format (fsr_fused_launch_h, _launch10_h; cas_upscale_launch_h,
    _launch10_h) with its strip's base and rows and the band's out_row0 and
    out_row1, the sharpness rounded to bf16: driven here through fn.launch
    with the entry point stubbed."""
    _, strips = _builds(kernel, 72, 60, 24, 3, bits)
    fn = strips[1]                 # a middle strip: both edges cut tiles
    out, err = fn.launch(_strip(_frame(72, 60, bits), fn))
    ((library, entry, args),) = entry_calls
    assert err == 0 and fn.launches == 0
    assert (library, entry) == (
        kernel, f"{kernel}_launch{'10' if bits == 10 else ''}_h")
    ints = list(args[13:23])
    # batch, in_h, in_w, in_row_base, in_rows, pitch, out_h, out_w,
    # out_row0, out_row1
    r0 = fn.band_range[0] * 24
    assert ints == [2, 72, 60, fn.in_row_base, fn.in_rows, 60, 96, 80, r0,
                    r0 + fn.out_rows]
    assert r0 % 32 and (r0 + fn.out_rows) % 32
    assert out.shape[1] == fn.out_rows
    if kernel == "fsr_fused":
        sharp = C.fsr_rcas_con(C.rcas_stops_from_slider(0.9))
    else:
        from openvr_fsr_tpu_torch.ops.cas import cas_setup
        sharp = cas_setup(0.9)
    assert args[23] == lit(sharp, HALF) != float(sharp)


# ---- the strips' DMA geometry and the band form of the floor -----------------

GEO_CASES = [(k, h, w, rs, br, n) for k in KERNELS
             for h, w, rs in ((187, 168, 0.75), (150, 120, 1.3))
             for br, n in ((24, 3), (24, None), (32, None), (128, 3))]
GEO_IDS = [f"{k}-{w}x{h}-rs{rs}-{br}rows-{'alone' if n is None else n}"
           for k, h, w, rs, br, n in GEO_CASES]


def _emulate_band(img, g):
    """The floor kernel in numpy from the tables it launches with
    (floor_tiles, floor_boxes), item by item: each tile's box zero-filled
    outside the strip's rows and columns (TMA), each grid row gy of the
    tile stored as output row gy - row0 where that is a row of the band,
    the box word at its box-relative tap (rel_y per grid row)."""
    b = sol.floor_boxes(g)
    H, W, (tw, th) = g["in_h"], g["in_w"], g["tile"]
    row0, _ = sol.band_rows(g)
    out = np.full((g["batch"], g["out_h"], g["out_w"]), -7, np.int32)
    for bi, ty, tx, kind in sol.floor_tiles(g):
        assert kind >= 0                       # the list form: no spans
        c = int(kind)
        (bw, bh), x0, y0 = b.box[c], b.x0[c][tx], b.y0[c][ty]
        y, x = y0 + np.arange(bh), x0 + np.arange(bw)
        valid = (((y >= 0) & (y < H))[:, None]
                 & ((x >= 0) & (x < W))[None, :])
        box = np.where(valid, img[bi][np.ix_(np.clip(y, 0, H - 1),
                                             np.clip(x, 0, W - 1))], 0)
        gy = np.arange(ty * th, ty * th + th)
        oy = gy - row0
        keep = (oy >= 0) & (oy < g["out_h"])
        ox = np.arange(tx * tw, min(tx * tw + tw, g["out_w"]))
        out[bi][np.ix_(oy[keep], ox)] = box[np.ix_(b.rel_y[c][gy[keep]],
                                                   b.rel_x[c][ox])]
    return out


@pytest.mark.parametrize("kernel,h,w,rs,band_rows,n", GEO_CASES, ids=GEO_IDS)
def test_strip_geometry_is_a_band_of_the_whole(kernel, h, w, rs, band_rows,
                                               n):
    """Every strip build, full and half, 8 and 10 bits, publishes a DMA
    geometry the floor accepts (check_geometry); the half strip's equals
    the full strip's. The floor of each strip, in plain torch and in the
    numpy statement of its band form, gives the strip's output rows; the
    strips' outputs, concatenated, equal the whole image's floor bit for
    bit."""
    for bits in (8, 10):
        whole, strips = _builds(kernel, h, w, band_rows, n, bits, "full",
                                rs=rs)
        _, half = _builds(kernel, h, w, band_rows, n, bits, "half", rs=rs)
        img = _frame(h, w, bits, seed=3)
        words = img if bits == 8 else img.view(torch.int32).reshape(2, h, -1)
        want = sol.build_dma_floor(whole.dma_geometry)(img)
        outs = []
        for fn, fh in zip(strips, half):
            g = fn.dma_geometry
            sol.check_geometry(g)
            assert g.keys() == fh.dma_geometry.keys()
            for key, v in g.items():
                assert np.array_equal(np.asarray(v, dtype=object),
                                      np.asarray(fh.dma_geometry[key],
                                                 dtype=object)), key
            assert (g["batch"], g["in_h"], g["out_h"]) == (
                2, fn.in_rows, fn.out_rows)
            row0, row1 = sol.band_rows(g)
            assert row0 == fn.band_range[0] * band_rows % 32
            floor = sol.build_dma_floor(g)
            strip = _strip(img, fn)
            got = floor(strip)
            assert got.shape == fn(strip).shape
            emul = _emulate_band(_strip(words, fn).numpy(), g)
            got_words = got if bits == 8 else got.view(torch.int32).reshape(
                2, fn.out_rows, -1)
            assert np.array_equal(emul, got_words.numpy())
            outs.append(got)
        assert torch.equal(torch.cat(outs, 1), want)
        if band_rows == 24:                    # edges that cut tiles
            assert any(sol.band_rows(fn.dma_geometry)[0] for fn in strips)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_strip_loads_against_the_whole(kernel):
    """What the strips' floors load against the whole image's floor, tile
    by tile: a tile that stages loads its window, the same words in a strip
    as in the whole image; so the strips' staged loads sum to the whole's
    plus the windows of the tiles a band edge cuts, loaded by both strips.
    A tile that does not stage loads a box as high as the largest bilinear
    footprint of its own floor's tile rows: no more in a strip than in the
    whole image. So the summed loads can fall below the whole's, by the
    outside boxes (here at most 0.7%: 32-row bands alone)."""
    h, w = 187, 168
    for band_rows, n in ((24, 3), (24, None), (32, None)):
        whole, strips = _builds(kernel, h, w, band_rows, n)
        gw = whole.dma_geometry
        per_tile = sol.tile_loads(gw)
        staged = np.asarray(gw["staged"], bool)
        cut = np.zeros(staged.shape[1], np.int64)     # strips per tile row
        total = 0
        for fn in strips:
            g = fn.dma_geometry
            t0 = (fn.band_range[0] * band_rows) // 32
            mine = sol.tile_loads(g)
            rows = slice(t0, t0 + mine.shape[1])
            s = np.asarray(g["staged"], bool)
            assert np.array_equal(s, staged[:, rows])
            assert np.array_equal(mine[s], per_tile[:, rows][s])
            assert (mine[~s] <= per_tile[:, rows][~s]).all()
            cut[rows] += 1
            total += sol.floor_loads(g)
        assert (cut >= 1).all()
        twice = (cut[None, :, None] - 1) * staged * per_tile
        staged_sum = sum(int(sol.tile_loads(fn.dma_geometry)[
            np.asarray(fn.dma_geometry["staged"], bool)].sum())
            for fn in strips)
        assert staged_sum == int(per_tile[staged].sum() + twice.sum())
        if band_rows == 24:
            assert twice.sum() > 0
        assert total >= 0.99 * sol.floor_loads(gw)


def test_floor_launch_takes_the_band_row(entry_calls):
    """On a CUDA tensor a strip's floor would hand dma_floor_launch the
    band's row0 in the grid of its tile rows (the band form where it is
    above 0), and a whole image's floor row0 0; each with its strip's rows
    and the band's output rows."""
    from openvr_fsr_tpu_torch.kernels import _build
    whole, strips = _builds("fsr_fused", 72, 60, 24, 3)
    for fn in (whole, strips[1]):
        floor = sol.build_dma_floor(fn.dma_geometry)
        hp, wp = floor.pad_to
        out, err = floor.launch(torch.zeros((2, hp, wp), dtype=torch.int32))
        assert err == 0 and out.shape[1] == fn.dma_geometry["out_h"]
    assert {c[:2] for c in entry_calls} == {("dma_floor", "dma_floor_launch")}
    (a, b) = (c[2] for c in entry_calls)
    assert len(a) == len(b) == len(_build.prototype(
        "dma_floor_launch", (_build.CSRC / "dma_floor.cu").read_text()))
    assert a[22] == 0 and a[10] == 72 and a[14] == 96
    g = strips[1].dma_geometry
    assert b[22] == sol.band_rows(g)[0] > 0
    assert b[10] == strips[1].in_rows and b[14] == strips[1].out_rows


def test_band_geometry_refusals():
    """The floor refuses a band that is not its out_h rows from a row0
    inside the first tile row over its tile rows, and a band of the copy
    form."""
    _, strips = _builds("fsr_fused", 72, 60, 24, 3)
    g = strips[1].dma_geometry
    row0, row1 = g["band"]
    for bad in ((row0, row1 + 1), (row0 + 32, row1 + 32),
                (-1, row1 - row0 - 1)):
        with pytest.raises(ValueError, match="band"):
            sol.check_geometry(dict(g, band=bad))
    with pytest.raises(ValueError, match="band form"):
        sol.check_geometry(dict(g, stage="copy", quad_x=None, quad_y=None))


def test_band_occupancy_asks_the_band_entry(monkeypatch):
    """band_occupancy(name, bits, precision) asks <name>_band_occupancy
    with the texel format and 1 for half; fsr_fused.cu and cas_upscale.cu
    export it with one prototype."""
    import re
    from openvr_fsr_tpu_torch.kernels import _build, _common
    asked = []

    class Lib:
        def __getattr__(self, name):
            def f(bits, half, out):
                asked.append((name, bits, half))
                out._obj.value = 3
                return 0
            return f
    monkeypatch.setattr(_build, "load_library", lambda name: Lib())
    assert _common.band_occupancy("fsr_fused", 10, "half") == 3
    assert _common.band_occupancy("cas_upscale") == 3
    assert asked == [("fsr_fused_band_occupancy", 10, 1),
                     ("cas_upscale_band_occupancy", 8, 0)]
    with pytest.raises(ValueError, match="color_bits"):
        _common.band_occupancy("fsr_fused", 12)
    for kernel in KERNELS:
        text = (_build.CSRC / f"{kernel}.cu").read_text()
        (params,) = re.findall(
            rf'extern "C" int {kernel}_band_occupancy\((.*?)\)', text, re.S)
        assert " ".join(params.split()) == \
            "int color_bits, int half, int* inside"


# ---- which form of the floor a strip runs -----------------------------------

@pytest.mark.parametrize("band_rows,row0", [(128, [0, 0, 0]),
                                            (24, [0, 8, 24])],
                         ids=["128", "24"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_floor_form_at_the_headline(kernel, band_rows, row0):
    """At the headline size (2 x 1683x1869 -> 2 x 2244x2492) the 128-row
    bands split 3 ways (the spatial path's strips) start on 32-row tiles,
    so their floors run the whole form (band_form False: dma_floor_kernel);
    24-row bands split 3 ways start 8 and 24 rows into a tile after the
    first, whose floors run the band form (dma_floor_band_kernel).
    chip_smoke.py times the latter as dma_floor_band; the whole image's
    floor runs the whole form."""
    build, layout = KERNELS[kernel][:2]
    h, w = 1869, 1683
    ow, oh = Config(render_scale=0.75).output_size(w, h)
    kw = dict(sharpness=0.9, band_rows=band_rows,
              centres=C.centres_payload(ow, oh, 0.5, ((0.5, 0.5),) * 2,
                                        (0, 1)))
    _, gy = layout(ow, oh, band_rows)
    fns = [build(2, h, w, ow, oh, band_range=r, **kw)
           for r in split_bands(gy, 3)]
    assert [sol.band_rows(fn.dma_geometry)[0] for fn in fns] == row0
    assert [sol.build_dma_floor(fn.dma_geometry).band_form
            for fn in fns] == [r > 0 for r in row0]
    assert not sol.build_dma_floor(build(2, h, w, ow, oh, **kw)
                                   .dma_geometry).band_form
