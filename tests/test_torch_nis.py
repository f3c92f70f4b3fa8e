"""The port's NIS ops (openvr_fsr_tpu_torch/ops/nis.py) against the NumPy
oracle (openvr_fsr_tpu/oracle/nis.py) and the JAX package's XLA ops: the
same f32 inputs, made with numpy, through both.

The torch ops are eager and do every f32 op in the oracle's order, so the
bar against the oracle is max abs 0. XLA:CPU contracts mul+add into FMAs,
so against the JAX ops the bar is a few f32 ulps of the [0, 1] output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu.core import constants as JC  # noqa: E402
from openvr_fsr_tpu.oracle import nis as O  # noqa: E402

from openvr_fsr_tpu_torch.core import constants as TC  # noqa: E402
from openvr_fsr_tpu_torch.ops import nis as N  # noqa: E402

H_IN, W_IN = 48, 56


def _img(seed, h, w, hdr_mode=0, alpha=True):
    """Decoded RGBA8 texels (hdr 0/2), or scRGB-style values up to 4
    (linear HDR), f32 (H, W, 4)."""
    rng = np.random.default_rng(seed)
    if hdr_mode == 1:
        img = (rng.random((h, w, 4)) * 4.0).astype(np.float32)
    else:
        img = (rng.integers(0, 256, (h, w, 4)) / 255.0).astype(np.float32)
    if not alpha:
        img[..., 3] = 1.0
    return img


def _planar(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))


def _hwc(t):
    return t.numpy().transpose(1, 2, 0)


def _scaler_cfg(sharpness, w, h, ow, oh, hdr_mode=0):
    return TC.nvscaler_update_config(sharpness, w, h, w, h, ow, oh, ow, oh,
                                     hdr_mode=hdr_mode)


class TestScalerAgainstOracle:
    @pytest.mark.parametrize("scale", [0.75, 0.77, 0.5])
    @pytest.mark.parametrize("hdr_mode", [0, 1, 2])
    def test_bit_exact(self, scale, hdr_mode):
        ow, oh = int(W_IN / scale), int(H_IN / scale)
        img = _img(11, H_IN, W_IN, hdr_mode)
        cfg = _scaler_cfg(0.66, W_IN, H_IN, ow, oh, hdr_mode)
        got = _hwc(N.nvscaler(_planar(img), ow, oh, cfg))
        want = O.nvscaler_oracle(img, ow, oh, cfg)
        assert got.shape == want.shape == (oh, ow, 4)
        assert np.abs(got - want).max() == 0.0

    @pytest.mark.parametrize("sharpness", [0.0, 0.3, 1.0])
    def test_invalid_scale_and_sharpness_bit_exact(self, sharpness):
        """A scale outside 0.5..1 (valid=False) runs all the same, and the
        slider on both sides of 0.5 picks other constants."""
        ow, oh = int(W_IN / 0.3), int(H_IN / 0.3)
        img = _img(12, H_IN, W_IN)
        cfg = _scaler_cfg(sharpness, W_IN, H_IN, ow, oh)
        assert not cfg.valid
        got = _hwc(N.nvscaler(_planar(img), ow, oh, cfg))
        assert np.abs(got - O.nvscaler_oracle(img, ow, oh, cfg)).max() == 0.0

    def test_batched_equals_per_frame(self):
        ow, oh = int(W_IN / 0.75), int(H_IN / 0.75)
        imgs = [_img(s, H_IN, W_IN) for s in (1, 2)]
        cfg = _scaler_cfg(0.9, W_IN, H_IN, ow, oh)
        both = N.nvscaler(torch.stack([_planar(i) for i in imgs]), ow, oh, cfg)
        for b, img in enumerate(imgs):
            assert torch.equal(both[b], N.nvscaler(_planar(img), ow, oh, cfg))


class TestSharpenAgainstOracle:
    @pytest.mark.parametrize("sharpness", [0.25, 0.9])
    @pytest.mark.parametrize("hdr_mode", [0, 1, 2])
    def test_bit_exact(self, sharpness, hdr_mode):
        img = _img(21, 44, 52, hdr_mode)
        cfg = TC.nvsharpen_update_config(sharpness, 52, 44, 52, 44,
                                         hdr_mode=hdr_mode)
        got = _hwc(N.nvsharpen(_planar(img), cfg))
        want = O.nvsharpen_oracle(img, cfg)
        assert np.abs(got - want).max() == 0.0

    @pytest.mark.parametrize("value", [0.0, 0.5, 1.0])
    def test_flat_fields_bit_exact(self, value):
        """Flat fields: every gradient is 0, so the edge ratio divides 0 by
        0 and is selected away."""
        img = np.full((24, 28, 4), value, np.float32)
        cfg = TC.nvsharpen_update_config(0.9, 28, 24, 28, 24)
        got = _hwc(N.nvsharpen(_planar(img), cfg))
        assert np.abs(got - O.nvsharpen_oracle(img, cfg)).max() == 0.0


class TestPieces:
    @pytest.mark.parametrize("hdr_mode", [0, 1, 2])
    def test_get_y(self, hdr_mode):
        img = _img(31, 20, 24, hdr_mode)
        got = N.get_y(_planar(img), hdr_mode).numpy()
        assert np.array_equal(got, O.get_y(img, hdr_mode))
        assert np.array_equal(N.get_y_linear(_planar(img)).numpy(),
                              O.get_y_linear(img))

    def test_sqrt_rn_is_correctly_rounded(self):
        """The linear-HDR luma's square root equals numpy's (IEEE) one on
        random and on tiny (subnormal) inputs."""
        rng = np.random.default_rng(33)
        x = np.concatenate([
            (rng.random(200_000) * 16).astype(np.float32),
            np.arange(1, 1 << 16, dtype=np.uint32).view(np.float32)])
        got = N.sqrt_rn(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, np.sqrt(x))

    @pytest.mark.parametrize("hdr_mode", [0, 2])
    def test_edge_map_plane(self, hdr_mode):
        img = _img(32, 30, 34, hdr_mode)
        cfg = TC.nvsharpen_update_config(0.9, 34, 30, 34, 30,
                                         hdr_mode=hdr_mode)
        y = O.get_y(img, hdr_mode)
        got = np.stack([w.numpy() for w in
                        N.edge_map_plane(torch.from_numpy(y), cfg)], -1)
        assert np.array_equal(got, O.edge_map_plane(y, cfg))

    def test_source_maps_match_jax(self):
        from openvr_fsr_tpu.ops.nis import nis_source_maps as j_maps
        for scale in (0.75, 0.5, 0.3):
            ow, oh = int(W_IN / scale), int(H_IN / scale)
            cfg = _scaler_cfg(0.9, W_IN, H_IN, ow, oh)
            jcfg = JC.nvscaler_update_config(0.9, W_IN, H_IN, W_IN, H_IN, ow,
                                             oh, ow, oh)
            for a, b in zip(N.nis_source_maps(ow, oh, cfg),
                            j_maps(ow, oh, jcfg)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


class TestAgainstJaxOps:
    """The JAX package's XLA ops on the same inputs (XLA:CPU contracts
    FMAs: a few f32 ulps)."""

    def test_scaler(self):
        import jax.numpy as jnp
        from openvr_fsr_tpu.ops.nis import nvscaler_jax
        ow, oh = int(W_IN / 0.75), int(H_IN / 0.75)
        img = _img(41, H_IN, W_IN)
        cfg = _scaler_cfg(0.9, W_IN, H_IN, ow, oh)
        jcfg = JC.nvscaler_update_config(0.9, W_IN, H_IN, W_IN, H_IN, ow, oh,
                                         ow, oh)
        got = N.nvscaler(_planar(img), ow, oh, cfg).numpy()
        ref = np.asarray(nvscaler_jax(jnp.asarray(img.transpose(2, 0, 1)),
                                      ow, oh, jcfg))
        assert np.abs(got - ref).max() <= 1e-5

    def test_sharpen(self):
        import jax.numpy as jnp
        from openvr_fsr_tpu.ops.nis import nvsharpen_jax
        img = _img(42, 44, 52)
        cfg = TC.nvsharpen_update_config(0.9, 52, 44, 52, 44)
        jcfg = JC.nvsharpen_update_config(0.9, 52, 44, 52, 44)
        got = N.nvsharpen(_planar(img), cfg).numpy()
        ref = np.asarray(nvsharpen_jax(jnp.asarray(img.transpose(2, 0, 1)),
                                       jcfg))
        assert np.abs(got - ref).max() <= 1e-5
