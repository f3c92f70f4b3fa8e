"""The renderScale-1 and NIS kernel modules on the CPU: RCAS sharpen-only
(kernels/rcas.py), NVSharpen and NVScaler (kernels/nis.py). Each builder's
plain path (fn on CPU tensors) is held bit for bit against the NumPy
pipeline oracle and within the quantized tier (>= 99.9% equal texels, max
2 LSB) of the JAX package's Pipeline(backend="xla"), whose XLA:CPU
contracts FMAs; plus their host tables and input checks.

Every frame carries alpha that is not all 255: the three plans route alpha
differently (RCAS: 1 inside the circle, source outside; NVSharpen: source
inside, 1 outside; NVScaler: the bilinear tap's inside, 1 outside).

The CUDA kernels themselves run only on the card: `python3 chip_smoke.py`
holds them against these plain versions there, texel for texel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import openvr_fsr_tpu as J  # noqa: E402
from openvr_fsr_tpu.ops.bilinear import bilinear_axis_maps  # noqa: E402
from openvr_fsr_tpu.ops.nis import nis_source_maps as j_source_maps  # noqa: E402
from openvr_fsr_tpu.oracle.pipeline import pipeline_oracle  # noqa: E402
from openvr_fsr_tpu.utils import frames as JFR  # noqa: E402

from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.kernels._maps import (NIS_IN_TILE,  # noqa: E402
                                                nvscaler_maps)
from openvr_fsr_tpu_torch.kernels.nis import (build_nvscaler,  # noqa: E402
                                              build_nvsharpen)
from openvr_fsr_tpu_torch.kernels.rcas import build_rcas_sharpen  # noqa: E402

CENTERS = ((0.47, 0.52), (0.55, 0.49))
SHARPNESS = 0.9


def _out_size(h, w, rs):
    if rs == 1.0:
        return w, h
    return (int(w / rs), int(h / rs)) if rs < 1 else (int(w * rs), int(h * rs))


def _frames(h, w, kind="zone"):
    rng = np.random.default_rng(h * w + len(kind))
    if kind == "zone":
        f = np.stack([JFR.zone_plate_frame(h, w),
                      JFR.noise_frame(h, w, seed=3)])
        f[..., 3] = rng.integers(0, 256, (2, h, w))
        return f
    return rng.integers(0, 256, (2, h, w, 4)).astype(np.uint8)


def _packed(frames):
    return np.ascontiguousarray(frames).view(np.int32)[..., 0]


def _build(plan, h, w, rs=1.0, radius=0.5, debug=False, hdr=0,
           single_eye=True, sharpness=SHARPNESS):
    ow, oh = _out_size(h, w, rs)
    cen = C.centres_payload(ow, oh, radius, CENTERS, (0, 1), single_eye)
    if plan == "rcas":
        return build_rcas_sharpen(2, h, w, sharpness=sharpness, centres=cen,
                                  debug=debug)
    if plan == "nvsharpen":
        cfg = C.nvsharpen_update_config(sharpness, w, h, w, h, hdr_mode=hdr)
        return build_nvsharpen(2, h, w, nis_cfg=cfg, centres=cen, debug=debug)
    cfg = C.nvscaler_update_config(sharpness, w, h, w, h, ow, oh, ow, oh,
                                   hdr_mode=hdr)
    return build_nvscaler(2, h, w, ow, oh, nis_cfg=cfg, centres=cen,
                          debug=debug)


def _run(fn, frames):
    out = fn(torch.from_numpy(_packed(frames)))
    return out.numpy().view(np.uint8).reshape(out.shape + (4,))


def _oracle(frames, plan, rs, radius, debug, hdr, single_eye,
            sharpness=SHARPNESS):
    return np.stack([pipeline_oracle(
        frames[i], rs, sharpness, use_nis=plan != "rcas", radius=radius,
        debug=debug, hdr_mode=hdr, eye_centers=CENTERS,
        single_eye=single_eye, eye=i) for i in range(2)])


# (plan, in_h, in_w, rs, radius, debug, hdr_mode, frames, single_eye)
CASES = [
    ("rcas", 48, 56, 1.0, 0.5, False, 0, "zone", True),
    ("rcas", 48, 56, 1.0, 2.0, False, 0, "noise", True),
    ("rcas", 40, 45, 1.0, 0.0, True, 0, "zone", True),
    ("rcas", 64, 72, 1.0, 0.3, True, 0, "noise", False),
    ("nvsharpen", 70, 75, 1.0, 0.5, False, 0, "zone", True),
    ("nvsharpen", 64, 70, 1.0, 2.0, False, 0, "noise", True),
    ("nvsharpen", 64, 70, 1.0, 2.0, False, 1, "zone", True),
    ("nvsharpen", 64, 70, 1.0, 2.0, False, 2, "noise", True),
    ("nvsharpen", 70, 75, 1.0, 0.0, True, 0, "zone", True),
    ("nvsharpen", 96, 130, 1.0, 0.4, True, 0, "noise", False),
    ("nvscaler", 48, 56, 0.75, 0.5, False, 0, "zone", True),
    ("nvscaler", 48, 56, 0.75, 2.0, False, 1, "noise", True),
    ("nvscaler", 48, 56, 0.75, 2.0, False, 2, "zone", True),
    ("nvscaler", 40, 45, 0.75, 0.0, True, 0, "noise", True),
    ("nvscaler", 30, 33, 0.5, 2.0, False, 0, "zone", True),
    ("nvscaler", 48, 56, 0.77, 2.0, False, 0, "noise", True),
    ("nvscaler", 24, 28, 0.3, 2.0, False, 0, "zone", True),
    ("nvscaler", 40, 45, 1.3, 0.5, True, 0, "noise", True),
    ("nvscaler", 72, 96, 0.75, 0.5, True, 0, "zone", False),
]


class TestAgainstOracle:
    @pytest.mark.parametrize(
        "plan,h,w,rs,radius,debug,hdr,kind,single_eye", CASES)
    def test_bit_exact(self, plan, h, w, rs, radius, debug, hdr, kind,
                       single_eye):
        frames = _frames(h, w, kind)
        got = _run(_build(plan, h, w, rs, radius, debug, hdr, single_eye),
                   frames)
        want = _oracle(frames, plan, rs, radius, debug, hdr, single_eye)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("plan,rs", [("rcas", 1.0), ("nvsharpen", 1.0),
                                         ("nvscaler", 0.75)])
    @pytest.mark.parametrize("value", [0, 137, 255])
    def test_flat_fields_bit_exact(self, plan, rs, value):
        """Flat fields divide 0 by 0 in RCAS's limiters and NIS's edge
        ratio; the selects swallow the NaN."""
        frames = np.full((2, 40, 45, 4), value, np.uint8)
        frames[..., 3] = 190
        got = _run(_build(plan, 40, 45, rs, radius=2.0), frames)
        assert np.array_equal(got, _oracle(frames, plan, rs, 2.0, False, 0,
                                           True))

    @pytest.mark.parametrize("plan,rs", [("nvsharpen", 1.0),
                                         ("nvscaler", 0.75)])
    def test_sharpness_below_half_bit_exact(self, plan, rs):
        frames = _frames(40, 45)
        got = _run(_build(plan, 40, 45, rs, radius=2.0, sharpness=0.2),
                   frames)
        assert np.array_equal(got, _oracle(frames, plan, rs, 2.0, False, 0,
                                           True, sharpness=0.2))


class TestAlphaRouting:
    """Alpha inside and outside the circle, per plan, at radius 2.0 (all
    inside) and 0.0 (all outside)."""

    @pytest.mark.parametrize("plan,rs", [("rcas", 1.0), ("nvsharpen", 1.0),
                                         ("nvscaler", 0.75)])
    def test_alpha(self, plan, rs):
        frames = _frames(48, 56)
        frames[..., 3] = 77
        inside = _run(_build(plan, 48, 56, rs, radius=2.0), frames)[..., 3]
        outside = _run(_build(plan, 48, 56, rs, radius=0.0), frames)[..., 3]
        want_in, want_out = {"rcas": (255, 77), "nvsharpen": (77, 255),
                             "nvscaler": (77, 255)}[plan]
        assert (inside == want_in).all() and (outside == want_out).all()


class TestAgainstJaxXla:
    """The JAX package's Pipeline(backend="xla") on the same frames."""

    @pytest.mark.parametrize("plan,h,w,rs,radius,debug,hdr,single_eye", [
        ("rcas", 48, 56, 1.0, 0.5, False, 0, True),
        ("rcas", 64, 72, 1.0, 0.3, True, 0, False),
        ("nvsharpen", 70, 75, 1.0, 0.5, True, 0, True),
        ("nvsharpen", 64, 70, 1.0, 2.0, False, 1, True),
        ("nvsharpen", 96, 130, 1.0, 0.4, False, 2, False),
        ("nvscaler", 48, 56, 0.75, 2.0, False, 0, True),
        ("nvscaler", 72, 96, 0.75, 0.5, True, 1, False),
        ("nvscaler", 48, 56, 0.75, 0.0, False, 2, True),
    ])
    def test_close(self, plan, h, w, rs, radius, debug, hdr, single_eye):
        frames = _frames(h, w)
        jp = J.Pipeline(J.Config(enabled=True, use_nis=plan != "rcas",
                                 render_scale=rs, sharpness=SHARPNESS,
                                 radius=radius, debug_mode=debug),
                        eye_centers=CENTERS, single_eye_per_frame=single_eye,
                        backend="xla", hdr_mode=hdr)
        ref = np.asarray(jp.process(frames))
        got = _run(_build(plan, h, w, rs, radius, debug, hdr, single_eye),
                   frames)
        d = np.abs(got.astype(int) - ref.astype(int))
        assert got.shape == ref.shape
        assert (d == 0).mean() >= 0.999 and d.max() <= 2


PLANS = [("rcas", 1.0), ("nvsharpen", 1.0), ("nvscaler", 0.75)]


class TestBuild:
    @pytest.mark.parametrize("plan,rs", PLANS)
    def test_ring_pitch_reads_in_place(self, plan, rs):
        fn = _build(plan, 93, 131, rs)
        assert fn.pad_to == (96, 256)
        frames = _frames(93, 131)
        ring = np.zeros((2, 96, 256), np.int32)
        ring[:, :93, :131] = _packed(frames)
        assert torch.equal(fn(torch.from_numpy(_packed(frames))),
                           fn(torch.from_numpy(ring)))

    @pytest.mark.parametrize("plan,rs", PLANS)
    def test_cpu_never_counts_a_launch(self, plan, rs):
        fn = _build(plan, 40, 45, rs)
        img = torch.from_numpy(_packed(_frames(40, 45)))
        assert torch.equal(fn(img), fn.reference(img))
        assert fn.launches == 0

    @pytest.mark.parametrize("plan,rs", PLANS)
    @pytest.mark.parametrize("bad,err", [
        (lambda x: x.to(torch.int64), TypeError),
        (lambda x: x.numpy(), TypeError),
        (lambda x: x[:, :, :-1].contiguous(), ValueError),
        (lambda x: x[:1], ValueError),
        (lambda x: x.transpose(1, 2).contiguous().transpose(1, 2),
         ValueError),
        (lambda x: x.to("meta"), ValueError),
    ])
    def test_rejects_what_the_kernel_does_not_take(self, plan, rs, bad, err):
        fn = _build(plan, 40, 45, rs)
        with pytest.raises(err):
            fn(bad(torch.from_numpy(_packed(_frames(40, 45)))))


class TestScalerMaps:
    @pytest.mark.parametrize("h,w,rs", [(1869, 1683, 0.75), (48, 56, 0.75),
                                        (30, 33, 0.5), (48, 56, 0.77),
                                        (24, 28, 0.3), (40, 45, 1.3),
                                        (93, 131, 0.59)])
    def test_maps_match_jax_and_footprints_cover_every_tap(self, h, w, rs):
        ow, oh = _out_size(h, w, rs)
        cfg = C.nvscaler_update_config(0.9, w, h, w, h, ow, oh, ow, oh)
        m = nvscaler_maps(1, h, w, ow, oh, cfg, np.zeros((1, 5), np.int64))
        jcfg = J.core.constants.nvscaler_update_config(0.9, w, h, w, h, ow,
                                                       oh, ow, oh)
        pxi, pyi, fx, fy = j_source_maps(ow, oh, jcfg)
        for ints, floats, src, frac, n_out, n_in, norm in (
                (m.col_i, m.col_f, pxi, fx, ow, w, jcfg.kDstNormX),
                (m.row_i, m.row_f, pyi, fy, oh, h, jcfg.kDstNormY)):
            # the JAX kernel's static maps (kernels/nis.py:443-455)
            u = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * norm
            t0, tf = bilinear_axis_maps(u * np.float32(n_in) - np.float32(0.5))
            b0, bf = bilinear_axis_maps(
                np.arange(n_out, dtype=np.float32) / np.float32(n_out)
                * np.float32(n_in) - np.float32(0.5))
            assert np.array_equal(ints[0], src) and np.array_equal(
                floats[0], frac)
            assert np.array_equal(ints[1], (frac * np.float32(64))
                                  .astype(np.int32))
            assert np.array_equal(ints[2], t0) and np.array_equal(
                floats[1], tf)
            assert np.array_equal(ints[3], b0) and np.array_equal(
                floats[2], bf)
        for src, origins, tile, n_in, cap in (
                (m.col_i[0], m.tile_x0, 32, w, NIS_IN_TILE[0]),
                (m.row_i[0], m.tile_y0, 24, h, NIS_IN_TILE[1])):
            for t, o in enumerate(origins):
                taps = np.clip(src[t * tile:(t + 1) * tile, None]
                               + np.arange(-2, 4), 0, n_in - 1)
                edges = np.clip(np.clip(src[t * tile:(t + 1) * tile, None]
                                        + np.arange(0, 2), 0, n_in - 1)
                                [..., None] + np.arange(-1, 2), 0, n_in - 1)
                for idx in (taps, edges):
                    assert idx.min() >= o and idx.max() < o + cap

    def test_footprint_beyond_the_tile_raises(self):
        """A downscale (scale 2) needs a wider footprint than the kernel
        stages."""
        cfg = C.nvscaler_update_config(0.9, 128, 96, 128, 96, 64, 48, 64, 48)
        with pytest.raises(ValueError, match="footprint"):
            build_nvscaler(1, 96, 128, 64, 48, nis_cfg=cfg,
                           centres=np.zeros((1, 5), np.int64))
