"""The port's plain torch ops against the NumPy oracle (bit-exact) and the
JAX ops (within tolerance).

Eager torch rounds every f32 op once, in the order written, like the
oracle; so the torch ops must equal it bit for bit. XLA:CPU contracts
mul+add into FMAs, so against the JAX ops the bar is the JAX package's own
quantized tier: at least 99.9% of UNORM8 texels equal, max 2 LSB.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openvr_fsr_tpu.oracle import intrinsics as oi  # noqa: E402
from openvr_fsr_tpu.oracle.bilinear import bilinear_fallback_fsr as bil_oracle  # noqa: E402
from openvr_fsr_tpu.oracle.easu import easu_oracle  # noqa: E402
from openvr_fsr_tpu.oracle.rcas import rcas_oracle  # noqa: E402
from openvr_fsr_tpu.ops.bilinear import bilinear_fallback_fsr_jax  # noqa: E402
from openvr_fsr_tpu.ops.easu import easu_jax  # noqa: E402
from openvr_fsr_tpu.ops.rcas import rcas_jax  # noqa: E402
from openvr_fsr_tpu.utils.frames import quantize_unorm  # noqa: E402

from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.ops import common as tc  # noqa: E402
from openvr_fsr_tpu_torch.ops.bilinear import bilinear_fallback_fsr  # noqa: E402
from openvr_fsr_tpu_torch.ops.easu import easu  # noqa: E402
from openvr_fsr_tpu_torch.ops.rcas import rcas  # noqa: E402

# (in_h, in_w, render_scale): the three test sizes
SIZES = [(48, 56, 0.75), (96, 128, 0.75), (64, 72, 1.3)]


def _out_size(h, w, rs):
    return (int(w / rs), int(h / rs)) if rs < 1 else (int(w * rs), int(h * rs))


def _bitwise(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _assert_quantized_close(got, ref, frac=0.999, worst=2):
    """At least `frac` of UNORM8 texels equal and none more than `worst`
    LSB apart (the JAX package's tier against XLA:CPU's FMA contraction)."""
    q = [np.rint(np.clip(np.asarray(x, np.float32), 0, 1) * 255).astype(int)
         for x in (got, ref)]
    d = np.abs(q[0] - q[1])
    assert (d == 0).mean() >= frac, (d == 0).mean()
    assert d.max() <= worst, d.max()


def _image(h, w, seed, kind="noise"):
    """(H, W, 3) f32 UNORM8-decoded texels from a numpy seed."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        u = rng.integers(0, 256, (h, w, 3))
    elif kind == "white":
        u = np.full((h, w, 3), 255)
    elif kind == "black":
        u = np.zeros((h, w, 3), int)
    else:   # smooth gradient with a few hard edges
        yy, xx = np.mgrid[0:h, 0:w]
        u = np.stack([(xx * 255) // max(w - 1, 1), (yy * 255) // max(h - 1, 1),
                      ((xx + yy) % 17 > 8) * 255], -1)
    return u.astype(np.float32) * (np.float32(1.0) / np.float32(255.0))


def _planar(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))


class TestIntrinsics:
    """The cases of tests/test_intrinsics.py, on the torch intrinsics."""

    @pytest.fixture(scope="class")
    def xs(self):
        rng = np.random.default_rng(7)
        x = np.abs(rng.standard_normal(4096).astype(np.float32)) + 1e-3
        extra = np.array([0.0, -0.0, 1.0, 2.0, 3.0, 4.0, 1e-30, 3e38,
                          np.inf, 1e-40], np.float32)
        return np.concatenate([x, -x, extra])

    @pytest.mark.parametrize("name", ["aprx_lo_rcp", "aprx_med_rcp",
                                      "aprx_lo_rsq", "rcp", "sat"])
    def test_bitwise_vs_oracle(self, xs, name):
        with np.errstate(all="ignore"):
            want = getattr(oi, name)(xs)
        got = getattr(tc, name)(torch.from_numpy(xs)).numpy()
        assert _bitwise(got, want)

    def test_magic_constants(self):
        two = torch.tensor([2.0, 3.0, 4.0])
        bits = two.numpy().view(np.uint32)
        assert np.array_equal(tc.aprx_lo_rcp(two).numpy().view(np.uint32),
                              np.uint32(0x7EF07EBB) - bits)
        assert np.array_equal(tc.aprx_lo_rsq(two).numpy().view(np.uint32),
                              np.uint32(0x5F347D74) - (bits >> np.uint32(1)))

    def test_lo_rsq_shift_is_logical(self):
        # a set sign bit must not smear into the shifted exponent
        neg = np.array([-1.0, -2.5, -0.0], np.float32)
        with np.errstate(all="ignore"):
            want = oi.aprx_lo_rsq(neg)
        assert _bitwise(tc.aprx_lo_rsq(torch.from_numpy(neg)).numpy(), want)

    def test_hlsl_minmax_nan(self):
        nan = torch.tensor([float("nan")])
        z, q = torch.tensor([0.0]), torch.tensor([-0.25])
        assert tc.hlsl_min(nan, z).item() == 0.0
        assert tc.hlsl_max(nan, q).item() == np.float32(-0.25)
        assert torch.isnan(tc.hlsl_min(torch.tensor([1.0]), nan)).all()
        assert torch.isnan(tc.hlsl_max(torch.tensor([1.0]), nan)).all()

    def test_min3_max3_sat_propagate_nan(self):
        nan, one = torch.tensor([float("nan")]), torch.tensor([1.0])
        assert torch.isnan(tc.min3(one, nan, one)).all()
        assert torch.isnan(tc.max3(one, one, nan)).all()
        assert torch.isnan(tc.sat(nan)).all()

    def test_unorm_quantize(self, xs):
        # equal values; the sign of a zero may differ (np.clip(-0.0, 0, 1)
        # is +0.0, torch.clamp keeps -0.0), which no UNORM store can see
        x = xs[np.isfinite(xs)]
        for bits in (8, 10):
            got = tc.unorm_quantize(torch.from_numpy(x), bits).numpy()
            assert np.array_equal(got, quantize_unorm(x, bits))
            assert _bitwise(got[x != 0], quantize_unorm(x[x != 0], bits))

    def test_float32_discipline(self):
        x = torch.tensor([1.5])
        for fn in (tc.rcp, tc.sat, tc.aprx_lo_rcp, tc.aprx_med_rcp,
                   tc.aprx_lo_rsq, tc.unorm_quantize):
            assert fn(x).dtype == torch.float32


class TestEasu:
    @pytest.mark.parametrize("h,w,rs", SIZES)
    @pytest.mark.parametrize("kind", ["noise", "edges"])
    def test_bitwise_vs_oracle(self, h, w, rs, kind):
        img = _image(h, w, seed=h + w, kind=kind)
        ow, oh = _out_size(h, w, rs)
        con = C.fsr_easu_con(w, h, w, h, ow, oh)
        got = easu(_planar(img), ow, oh, con).numpy().transpose(1, 2, 0)
        assert _bitwise(got, easu_oracle(img, ow, oh))

    def test_batched_equals_per_frame(self):
        imgs = [_image(48, 56, seed=s) for s in (1, 2)]
        con = C.fsr_easu_con(56, 48, 56, 48, 74, 64)
        both = easu(torch.stack([_planar(i) for i in imgs]), 74, 64, con)
        for k, img in enumerate(imgs):
            assert _bitwise(both[k].numpy(),
                            easu(_planar(img), 74, 64, con).numpy())

    @pytest.mark.parametrize("h,w,rs", SIZES)
    def test_close_to_jax(self, h, w, rs):
        img = _image(h, w, seed=3)
        ow, oh = _out_size(h, w, rs)
        con = C.fsr_easu_con(w, h, w, h, ow, oh)
        got = easu(_planar(img), ow, oh, con).numpy()
        ref = np.asarray(easu_jax(jnp.asarray(img.transpose(2, 0, 1)),
                                  ow, oh, con))
        _assert_quantized_close(got, ref)


class TestRcas:
    SHARP = C.fsr_rcas_con(C.rcas_stops_from_slider(0.9))

    @pytest.mark.parametrize("kind", ["noise", "edges", "white", "black"])
    @pytest.mark.parametrize("h,w", [(48, 56), (96, 128)])
    def test_bitwise_vs_oracle(self, kind, h, w):
        img = _image(h, w, seed=5, kind=kind)
        got = rcas(_planar(img), self.SHARP).numpy().transpose(1, 2, 0)
        with np.errstate(all="ignore"):
            want = rcas_oracle(img, self.SHARP)
        assert _bitwise(got, want)

    @pytest.mark.parametrize("s", [0.0, 0.5, 1.0])
    def test_sharpness_sweep_bitwise(self, s):
        img = _image(48, 56, seed=9)
        lin = C.fsr_rcas_con(C.rcas_stops_from_slider(s))
        got = rcas(_planar(img), lin).numpy().transpose(1, 2, 0)
        assert _bitwise(got, rcas_oracle(img, lin))

    @pytest.mark.parametrize("kind", ["noise", "edges"])
    def test_close_to_jax(self, kind):
        img = _image(96, 128, seed=6, kind=kind)
        got = rcas(_planar(img), self.SHARP).numpy()
        ref = np.asarray(rcas_jax(jnp.asarray(img.transpose(2, 0, 1)),
                                  self.SHARP))
        _assert_quantized_close(got, ref)


class TestBilinear:
    @pytest.mark.parametrize("h,w,rs", SIZES)
    def test_bitwise_vs_oracle(self, h, w, rs):
        img = _image(h, w, seed=8)
        ow, oh = _out_size(h, w, rs)
        got = bilinear_fallback_fsr(_planar(img), ow, oh).numpy()
        assert _bitwise(got.transpose(1, 2, 0), bil_oracle(img, ow, oh))

    @pytest.mark.parametrize("h,w,rs", SIZES)
    def test_close_to_jax(self, h, w, rs):
        img = _image(h, w, seed=8, kind="edges")
        ow, oh = _out_size(h, w, rs)
        got = bilinear_fallback_fsr(_planar(img), ow, oh).numpy()
        ref = np.asarray(bilinear_fallback_fsr_jax(
            jnp.asarray(img.transpose(2, 0, 1)), ow, oh))
        _assert_quantized_close(got, ref)
