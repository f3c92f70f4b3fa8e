"""The fused FSR kernel module on the CPU: its plain version against the
NumPy pipeline oracle (bit-exact) and the JAX Pallas kernel in interpret
mode (within tolerance), its host tables, and its input checks.

The CUDA kernel itself runs only on the card: `python3 chip_smoke.py`
holds it against this plain version there, texel for texel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu.core import constants as JC  # noqa: E402
from openvr_fsr_tpu.core import foveation as JF  # noqa: E402
from openvr_fsr_tpu.oracle.pipeline import pipeline_oracle  # noqa: E402
from openvr_fsr_tpu.utils import frames as JFR  # noqa: E402

from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.kernels import _build  # noqa: E402
from openvr_fsr_tpu_torch.kernels._maps import IN_TILE, TILE, fsr_maps  # noqa: E402
from openvr_fsr_tpu_torch.kernels.fsr import (build_fsr_fused,  # noqa: E402
                                              circle_mask)

CENTERS = ((0.5, 0.5), (0.5, 0.5))


def _out_size(h, w, rs):
    return (int(w / rs), int(h / rs)) if rs < 1 else (int(w * rs), int(h * rs))


def _frames(h, w, kind="zone"):
    if kind == "zone":
        return np.stack([JFR.zone_plate_frame(h, w),
                         JFR.noise_frame(h, w, seed=3)])
    rng = np.random.default_rng(h * w)
    return rng.integers(0, 256, (2, h, w, 4)).astype(np.uint8)


def _packed(frames):
    return np.ascontiguousarray(frames).view(np.int32)[..., 0]


def _build_for(h, w, rs, radius, debug=False, sharpness=0.9):
    ow, oh = _out_size(h, w, rs)
    cen = C.centres_payload(ow, oh, radius, CENTERS, (0, 1))
    return build_fsr_fused(2, h, w, ow, oh, sharpness=sharpness, centres=cen,
                           debug=debug)


def _run(fn, frames):
    out = fn(torch.from_numpy(_packed(frames)))
    return out.numpy().view(np.uint8).reshape(out.shape + (4,))


# (in_h, in_w, rs, radius, debug, frames): radius 0.5 / 2.0 / 0.0, debug,
# supersample, at the three test sizes
CASES = [
    (96, 128, 0.75, 0.5, False, "zone"),
    (96, 128, 0.75, 2.0, False, "zone"),
    (96, 128, 0.75, 0.0, False, "noise"),
    (48, 56, 0.75, 0.3, True, "zone"),
    (64, 72, 1.3, 0.5, False, "noise"),
    (64, 72, 1.3, 2.0, True, "zone"),
]


class TestAgainstOracle:
    @pytest.mark.parametrize("h,w,rs,radius,debug,kind", CASES)
    def test_bit_exact(self, h, w, rs, radius, debug, kind):
        frames = _frames(h, w, kind)
        got = _run(_build_for(h, w, rs, radius, debug), frames)
        want = np.stack([pipeline_oracle(frames[i], rs, 0.9, radius=radius,
                                         debug=debug, eye=i)
                         for i in range(2)])
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("value", [0, 137, 255])
    def test_flat_fields_bit_exact(self, value):
        """Flat fields divide by zero inside RCAS (NaN limiters)."""
        frames = np.full((2, 48, 56, 4), value, np.uint8)
        got = _run(_build_for(48, 56, 0.75, 0.5), frames)
        want = np.stack([pipeline_oracle(frames[i], 0.75, 0.9, radius=0.5,
                                         eye=i) for i in range(2)])
        assert np.array_equal(got, want)


class TestAgainstPallasInterpret:
    """The JAX package's Pallas kernel in interpret mode, as its own CPU
    tests run it; XLA:CPU contracts FMAs, so the bar is its quantized tier."""

    @pytest.mark.parametrize("h,w,rs,radius,debug", [
        (96, 128, 0.75, 0.5, False), (64, 72, 1.3, 2.0, True)])
    def test_close(self, h, w, rs, radius, debug):
        from openvr_fsr_tpu.kernels.fsr import build_fsr_fused as jax_build
        ow, oh = _out_size(h, w, rs)
        cen = JC.centres_payload(ow, oh, radius, CENTERS, (0, 1))
        frames = _frames(h, w)
        jfn = jax_build(2, h, w, ow, oh, sharpness=0.9, centres=cen,
                        debug=debug, interpret=True)
        ref = np.asarray(jfn(_packed(frames).view(np.uint32)))
        got = _run(_build_for(h, w, rs, radius, debug), frames)
        d = np.abs(got.astype(int) - ref.view(np.uint8).reshape(got.shape))
        assert (d == 0).mean() >= 0.999 and d.max() <= 2


class TestBuild:
    def test_ring_pitch_reads_in_place(self):
        assert _build_for(96, 128, 0.75, 0.5).pad_to == (96, 128)
        fn = _build_for(93, 131, 0.75, 0.5)
        frames = _frames(93, 131)
        hp, wp = fn.pad_to
        assert (hp, wp) == (96, 256)
        ring = np.zeros((2, hp, wp), np.int32)
        ring[:, :93, :131] = _packed(frames)
        a = fn(torch.from_numpy(_packed(frames)))
        b = fn(torch.from_numpy(ring))
        assert torch.equal(a, b)

    def test_cpu_never_counts_a_launch(self):
        fn = _build_for(48, 56, 0.75, 0.5)
        fn(torch.from_numpy(_packed(_frames(48, 56))))
        assert fn.launches == 0
        assert torch.equal(fn(torch.from_numpy(_packed(_frames(48, 56)))),
                           fn.reference(torch.from_numpy(
                               _packed(_frames(48, 56)))))

    @pytest.mark.parametrize("bad,err", [
        (lambda x: x.to(torch.int64), TypeError),
        (lambda x: x.numpy(), TypeError),
        (lambda x: x[:, :, :-1].contiguous(), ValueError),
        (lambda x: x[:1], ValueError),
        (lambda x: x.transpose(1, 2).contiguous().transpose(1, 2),
         ValueError),
        (lambda x: x.to("meta"), ValueError),
    ])
    def test_rejects_what_the_kernel_does_not_take(self, bad, err):
        fn = _build_for(48, 56, 0.75, 0.5)
        with pytest.raises(err):
            fn(bad(torch.from_numpy(_packed(_frames(48, 56)))))

    def test_no_nvcc_raises(self, monkeypatch):
        monkeypatch.setenv("PATH", "")
        import torch.utils.cpp_extension as ext
        monkeypatch.setattr(ext, "CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc"):
            _build._nvcc()


class TestMaps:
    @pytest.mark.parametrize("h,w,rs", [(96, 128, 0.75), (48, 56, 0.75),
                                        (64, 72, 1.3), (1869, 1683, 0.75),
                                        (100, 100, 0.99), (60, 90, 0.5)])
    def test_footprints_cover_every_tap(self, h, w, rs):
        """Every texel a tile's pixels (halo included) read lies inside the
        IN_TILE x IN_TILE window the kernel stages for that tile."""
        ow, oh = _out_size(h, w, rs)
        m = fsr_maps(1, h, w, ow, oh, np.zeros((1, 5), np.int64))
        for axis_i, origins, n_out, n_in in ((m.col_i, m.tile_x0, ow, w),
                                             (m.row_i, m.tile_y0, oh, h)):
            fi, b0 = axis_i
            for t, o in enumerate(origins):
                lo, hi = max(t * TILE - 1, 0), min(t * TILE + TILE, n_out - 1)
                idx = np.concatenate([
                    np.clip(fi[lo:hi + 1, None] + np.arange(-1, 3), 0,
                            n_in - 1).ravel(),
                    np.clip(b0[lo:hi + 1, None] + np.arange(0, 2), 0,
                            n_in - 1).ravel()])
                assert idx.min() >= o and idx.max() < o + IN_TILE

    @pytest.mark.parametrize("radius", [0.0, 0.3, 0.5, 2.0])
    @pytest.mark.parametrize("single_eye", [True, False])
    def test_circle_mask_matches_pixel_mask(self, radius, single_eye):
        ow, oh = 170, 128
        cen = C.centres_payload(ow, oh, radius, ((0.45, 0.5), (0.56, 0.47)),
                                (0, 1), single_eye)
        got = circle_mask(torch.from_numpy(cen), oh, ow).numpy()
        for b in range(2):
            want = JF.pixel_mask(ow, oh, JF.TILE_FSR,
                                 ((cen[b, 0], cen[b, 1]),
                                  (cen[b, 2], cen[b, 3])), int(cen[b, 4]))
            assert np.array_equal(got[b], want)
