"""The exact forms of the bilinear pass's codec (csrc/codec.cuh, namespace
exact; csrc/bilinear_pass.cuh), held on the CPU to the plain forms they
replace, with NumPy float32 standing in for the card's IEEE single ops.

The pass decodes a channel as one byte permute into 2^23's bits and one
FMA, saturates with __saturatef, rounds by adding 2^23 and encodes by
byte permutes of the sum's bits; it splits its tile ids with host-made
multiply-high divisors. Each form is an identity on the pass's finite
operands; these tests try every input where the inputs are few (every
16-bit value, every integer of the grid, every tie and its neighbours)
and a million seeded ones where they are not. A mirror of the pass's
helpers, parametrised over both codecs, is held to the plain decode,
round trip and encode of codec.cuh (rgba8.cuh, ffx_math.cuh), and its
constants to the source's. The CUDA pass itself runs only on the card:
`python3 chip_smoke.py` holds it to its plain torch version, texel for
texel.
"""

import re
from pathlib import Path

import numpy as np
import pytest

F32 = np.float32
CSRC = Path(__file__).resolve().parents[1] / "openvr_fsr_tpu_torch" / "csrc"
TWO23_BITS = 0x4B000000
TWO23 = F32(8388608.0)
ALPHA8_BIAS = F32(8453888.0)           # 2^23 + 0xFF00
INV255 = F32(1.0) / F32(255.0)
INV1023 = F32(1.0) / F32(1023.0)
# codec -> (scale, inv, the texel's channel fields as (word, shift))
CODECS = {"rgba8": (F32(255.0), INV255, ((0, 0), (0, 8), (0, 16))),
          "rgb10a2": (F32(1023.0), INV1023, ((0, 0), (0, 16), (1, 0)))}


def as_f32(bits):
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def as_u32(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def fma32(a, b, c):
    """The FMA's single rounding of a * b + c for float32 operands whose
    exact result float64 holds: the product of two float32 is exact in
    float64, and the sum is checked exact (TwoSum's error term is 0)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = np.asarray(c, dtype=np.float64)
    s = p + c64
    bp = s - c64
    err = (p - bp) + (c64 - (s - bp))
    assert not np.any(err), "a * b + c is not exact in float64"
    return s.astype(np.float32)


def byte_perm(x, y, s):
    """__byte_perm (PTX prmt, default mode): byte i of the result is byte
    (s >> 4i) & 7 of the 8 bytes {y, x}, its sign replicated where bit 3
    of that nibble is set."""
    v = (np.asarray(y, dtype=np.uint64) << np.uint64(32)) | \
        np.asarray(x, dtype=np.uint64)
    out = np.zeros(np.broadcast(v, s).shape, dtype=np.uint64)
    for i in range(4):
        n = (int(s) >> (4 * i)) & 15
        b = (v >> np.uint64(8 * (n & 7))) & np.uint64(255)
        if n & 8:
            b = np.where(b & np.uint64(128), np.uint64(255), np.uint64(0))
        out |= b << np.uint64(8 * i)
    return out.astype(np.uint32)


def saturatef(v):
    """__saturatef: v clamped to [0, 1], a NaN to 0."""
    v = np.asarray(v, dtype=np.float32)
    return np.where(np.isnan(v), F32(0), np.minimum(np.maximum(v, F32(0)),
                                                    F32(1)))


def sat_nan(a):
    """ffx::sat: min_nan(1, max_nan(0, a)); a NaN is kept, -0 too."""
    a = np.asarray(a, dtype=np.float32)
    m = np.where(F32(0) > a, F32(0), a)
    return np.where(F32(1) < m, F32(1), m)


def round_bits(v, scale, bias=TWO23):
    """exact::round_bits: the bits of bias + rint(sat(v) * scale)."""
    y = (saturatef(v) * scale).astype(np.float32)
    return as_u32((y + bias).astype(np.float32))


def decode(bits, inv):
    """exact::decode: u * inv from 2^23's bits with u in the low bits."""
    return fma32(as_f32(bits), np.full(np.shape(bits), inv, np.float32),
                 F32(-TWO23 * inv))


# ---- the mirror of the codecs' exact forms (codec.cuh) ---------------------

def exact_channel(codec, t, c):
    """Codec::exact_channel on texels t: (N,) uint32 RGBA8 or (N, 2) uint32
    words of R10G10B10A2 (x = R | G << 16, y = B | A << 16)."""
    scale, inv, _ = CODECS[codec]
    if codec == "rgba8":
        return decode(byte_perm(t, TWO23_BITS, 0x7440 | c), inv)
    w = t[:, 0] if c < 2 else t[:, 1]
    return decode(byte_perm(w, TWO23_BITS, 0x7432 if c & 1 else 0x7410), inv)


def exact_roundtrip(codec, v):
    scale, inv, _ = CODECS[codec]
    return decode(round_bits(v, scale), inv)


def exact_pack(codec, r, g, b):
    scale = CODECS[codec][0]
    if codec == "rgba8":
        rg = byte_perm(round_bits(r, scale), round_bits(g, scale), 0x0040)
        return byte_perm(rg, round_bits(b, scale, ALPHA8_BIAS), 0x5410)
    return np.stack([byte_perm(round_bits(r, scale), round_bits(g, scale),
                               0x5410),
                     byte_perm(round_bits(b, scale), np.uint32(3), 0x5410)],
                    axis=-1)


# ---- the plain forms (rgba8.cuh, codec.cuh, ffx_math.cuh) -------------------

def plain_channel(codec, t, c):
    scale, inv, fields = CODECS[codec]
    word, shift = fields[c]
    w = t if codec == "rgba8" else t[:, word]
    mask = 255 if codec == "rgba8" else 0xFFFF
    return ((w >> np.uint32(shift)) & np.uint32(mask)).astype(np.float32) * inv


def plain_round(codec, v):
    return np.rint((sat_nan(v) * CODECS[codec][0]).astype(np.float32))


def plain_roundtrip(codec, v):
    return (plain_round(codec, v) * CODECS[codec][1]).astype(np.float32)


def plain_pack(codec, r, g, b):
    q = [plain_round(codec, x).astype(np.uint32) for x in (r, g, b)]
    if codec == "rgba8":
        return q[0] | q[1] << np.uint32(8) | q[2] << np.uint32(16) | \
            np.uint32(255 << 24)
    return np.stack([q[0] | q[1] << np.uint32(16),
                     q[2] | np.uint32(3 << 16)], axis=-1)


def random_texels(codec, rng, n):
    if codec == "rgba8":
        return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    v = rng.integers(0, 1024, (n, 4), dtype=np.uint32)
    wide = rng.random((n, 4)) < 0.02        # whole 16-bit values saturate
    v = np.where(wide, rng.integers(0, 65536, (n, 4), dtype=np.uint32), v)
    return np.stack([v[:, 0] | v[:, 1] << np.uint32(16),
                     v[:, 2] | v[:, 3] << np.uint32(16)], axis=-1)


# ---- the identities ---------------------------------------------------------

@pytest.mark.parametrize("inv", [INV255, INV1023, F32(1.0) / F32(3.0)],
                         ids=["inv255", "inv1023", "inv3"])
def test_decode_every_16_bit_value(inv):
    """2^23's bits with u in the low 16 bits: the float 2^23 + u, less 2^23
    u exactly; the FMA form gives static_cast<float>(u) * inv, every u (so
    every byte too)."""
    u = np.arange(65536, dtype=np.uint32)
    bits = np.uint32(TWO23_BITS) | u
    assert np.array_equal((as_f32(bits) - TWO23).astype(np.float32),
                          u.astype(np.float32))
    assert (F32(-TWO23 * inv)).astype(np.float64) == -8388608.0 * float(inv)
    got = decode(bits, inv)
    want = (u.astype(np.float32) * inv).astype(np.float32)
    assert np.array_equal(as_u32(got), as_u32(want))


def _ties_and_neighbours(kmax):
    """k + 0.5 for k in 0..kmax - 1 and four float32 neighbours on each
    side, plus every integer k and its neighbours, inside [0, kmax]."""
    centres = np.concatenate([np.arange(kmax, dtype=np.float32) + F32(0.5),
                              np.arange(kmax + 1, dtype=np.float32)])
    out = [centres]
    up = down = centres
    for _ in range(4):
        up = np.nextafter(up, F32(np.inf))
        down = np.nextafter(down, F32(-np.inf))
        out += [up, down]
    y = np.concatenate(out).astype(np.float32)
    return y[(y >= 0) & (y <= kmax)]


@pytest.mark.parametrize("bias,kmax", [(TWO23, 1023), (TWO23, 255),
                                       (TWO23, 3), (ALPHA8_BIAS, 255)],
                         ids=["two23-1023", "two23-255", "two23-3",
                              "alpha8-255"])
def test_round_ties_neighbours_and_seeded(bias, kmax):
    """y + bias - bias == rint(y) (half to even), and the sum's low bits
    are rint(y): at every tie, every integer and four neighbours of each,
    0 and kmax, and a million seeded y in [0, kmax]."""
    rng = np.random.default_rng(20261018 + kmax)
    y = np.concatenate([_ties_and_neighbours(kmax),
                        np.array([0.0, -0.0, 255.0, kmax], np.float32),
                        (rng.random(1_000_000) * kmax).astype(np.float32)])
    y = y[y <= kmax].astype(np.float32)
    s = (y + bias).astype(np.float32)
    want = np.rint(y)
    assert np.array_equal((s - bias).astype(np.float32), want)
    low = as_u32(s) & np.uint32(0x3FF if kmax > 255 else 0xFF)
    assert np.array_equal(low, want.astype(np.uint32))
    if bias == ALPHA8_BIAS:
        assert np.all((as_u32(s) >> np.uint32(8)) & np.uint32(255) == 255)
    else:
        assert np.all(as_u32(s) >> np.uint32(10) == TWO23_BITS >> 10)


def test_saturate_against_nan_carrying_sat():
    """__saturatef equals ffx::sat on every operand that is not a NaN, the
    signs of zero, denormals, 1's neighbours and the infinities too; where
    only a zero's sign differs, the round's bits agree."""
    rng = np.random.default_rng(7)
    special = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 1e-45,
                        -1e-45, 1e-38, -1e-38, 0.5, 2.0, 65535.0 / 1023.0],
                       np.float32)
    near1 = np.array([np.nextafter(F32(1), F32(2)),
                      np.nextafter(F32(1), F32(0))], np.float32)
    v = np.concatenate([special, near1,
                        rng.normal(0.5, 1.0, 1_000_000).astype(np.float32)])
    a, b = saturatef(v), sat_nan(v)
    assert np.array_equal(a, b)              # -0 == 0
    for scale in (F32(255.0), F32(1023.0), F32(3.0)):
        ya = (a * scale).astype(np.float32) + TWO23
        yb = (b * scale).astype(np.float32) + TWO23
        assert np.array_equal(as_u32(ya), as_u32(yb))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_encode_of_a_round_trip_is_the_encode(codec):
    """sat(rint(y) * inv) * scale rounds to rint(y) for every integer of
    the grid, so B1's R skips its round trip."""
    scale, inv, _ = CODECS[codec]
    k = np.arange(int(scale) + 1, dtype=np.float32)
    rt = (k * inv).astype(np.float32)
    assert np.array_equal(plain_round(codec, rt), k)
    v = np.random.default_rng(11).random(200_000).astype(np.float32) * F32(1.2)
    assert np.array_equal(plain_pack(codec, plain_roundtrip(codec, v), v, v),
                          plain_pack(codec, v, v, v))


# ---- the mirror against the plain forms, per codec --------------------------

@pytest.mark.parametrize("codec", sorted(CODECS))
def test_exact_channel_is_the_plain_decode(codec):
    rng = np.random.default_rng(3)
    t = random_texels(codec, rng, 200_000)
    for c in range(3):
        assert np.array_equal(as_u32(exact_channel(codec, t, c)),
                              as_u32(plain_channel(codec, t, c)))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_exact_roundtrip_and_pack_are_the_plain_forms(codec):
    """On values from the pass's range and past it (a 10-bit channel's
    whole 16-bit value decodes to at most 64), both signs of zero, the
    grid's ties and their neighbours; the pass's values are never -0 (its
    products and sums of non-negative operands give +0)."""
    scale, inv, _ = CODECS[codec]
    rng = np.random.default_rng(5)
    ties = (_ties_and_neighbours(int(scale)) / scale).astype(np.float32)
    v = np.concatenate([ties, np.array([0.0, -0.0, 1.0, 64.06], np.float32),
                        (rng.random(1_000_000) * 1.3 - 0.1)
                        .astype(np.float32)])
    exact, plain = exact_roundtrip(codec, v), plain_roundtrip(codec, v)
    # -0 (which the pass never forms) round-trips to +0 here, -0 there
    assert np.array_equal(exact, plain)
    signed = np.signbit(v) & (v == 0)
    assert np.array_equal(as_u32(exact[~signed]), as_u32(plain[~signed]))
    g, b = np.roll(v, 1), np.roll(v, 2)
    assert np.array_equal(exact_pack(codec, v, g, b),
                          plain_pack(codec, v, g, b))


def _bilerp(c00, c10, c01, c11, fx, fy):
    """ffx::bilerp in float32, op for op."""
    gx, gy = (F32(1) - fx).astype(np.float32), (F32(1) - fy).astype(np.float32)
    top = ((c00 * gx).astype(np.float32) + (c10 * fx).astype(np.float32))
    bot = ((c01 * gx).astype(np.float32) + (c11 * fx).astype(np.float32))
    return ((top.astype(np.float32) * gy).astype(np.float32)
            + (bot.astype(np.float32) * fy).astype(np.float32)) \
        .astype(np.float32)


@pytest.mark.parametrize("round_trip", [True, False], ids=["b1", "b3-b5"])
@pytest.mark.parametrize("tint", [1.0, 0.7])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_pass_output_is_the_plain_texel(codec, tint, round_trip):
    """bilinear_pass::exact_texel (the exact codec; B1's R without its
    round trip) against bilinear_pass::texel (the plain codec) from the
    same four taps and fractions."""
    rng = np.random.default_rng(17)
    n = 200_000
    taps = [random_texels(codec, rng, n) for _ in range(4)]
    fx = rng.random(n).astype(np.float32)
    fy = rng.random(n).astype(np.float32)
    fx[::7], fy[::11], fx[::13] = 0.0, 1.0, 0.5
    tint = F32(tint)
    want, got = [], []
    for c in range(3):
        q = _bilerp(*(plain_channel(codec, t, c) for t in taps), fx, fy)
        want.append(plain_roundtrip(codec, q) if round_trip else q)
        e = _bilerp(*(exact_channel(codec, t, c) for t in taps), fx, fy)
        got.append(exact_roundtrip(codec, e) if round_trip and c else e)
    plain = plain_pack(codec, want[0], (want[1] * tint).astype(np.float32),
                       (want[2] * tint).astype(np.float32))
    exact = exact_pack(codec, got[0], (got[1] * tint).astype(np.float32),
                       (got[2] * tint).astype(np.float32))
    assert np.array_equal(exact, plain)


# ---- the tile ids' divisors (bilinear_pass::Divisor) ------------------------

def divisor_of(d):
    """Divisor::of: (m, shift), m 0 for d == 1."""
    log2 = 0
    while (1 << log2) < d:
        log2 += 1
    if d == 1:
        return 0, 0
    return ((1 << (31 + log2)) + d - 1) // d, log2 - 1


@pytest.mark.parametrize("lo,hi", [(1, 300), (300, 70_000), (70_000, 2**31)],
                         ids=["small", "tiles", "wide"])
def test_divisor_is_integer_division(lo, hi):
    """umulhi(n, m) >> shift == n // d for 0 <= n < 2^31: seeded divisors
    of each range, every n near a multiple and a thousand seeded n each."""
    rng = np.random.default_rng(lo)
    ds = np.unique(np.concatenate([np.arange(lo, min(hi, lo + 64)),
                                   rng.integers(lo, hi, 200)]))
    for d in ds.tolist():
        m, shift = divisor_of(d)
        assert m < 2**32
        n = np.concatenate([rng.integers(0, 2**31, 1000),
                            np.array([0, 1, d - 1, d, d + 1, 2**31 - 1]),
                            (d * rng.integers(0, (2**31 - 1) // d, 50))])
        n = n[(n >= 0) & (n < 2**31)].astype(np.uint64)
        q = (n * np.uint64(m) >> np.uint64(32)) >> np.uint64(shift) if m \
            else n
        assert np.array_equal(q, n // np.uint64(d)), d


# ---- the mirror's constants are the source's --------------------------------

def test_mirror_constants_match_the_source():
    codec = (CSRC / "codec.cuh").read_text()
    npass = (CSRC / "bilinear_pass.cuh").read_text()
    assert "kTwo23Bits = 0x4B000000u" in codec
    assert "kTwo23 = 8388608.0f" in codec
    assert "kAlpha8Bias = 8453888.0f" in codec
    for sel in ("0x7440u | c", "(c & 1) ? 0x7432u : 0x7410u", "0x0040u",
                "0x5410u", "3u, 0x5410u"):
        assert sel in codec, sel
    assert re.search(r"__fmaf_rn\(__uint_as_float\(bits\), inv, "
                     r"-kTwo23 \* inv\)", codec)
    assert "((1ull << (31 + log2)) + d - 1) / d), log2 - 1}" in npass
    assert "if (kRoundTrip && c > 0) q[c] = C::exact_roundtrip(q[c]);" in npass
