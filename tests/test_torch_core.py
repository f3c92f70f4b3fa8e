"""The port's host layers against the JAX package's: config, constant tables,
foveation, projection, frames, timer — and the port's import boundary.

The port carries numpy copies of these layers (the JAX package's __init__
imports jax, which the GPU machine lacks); every table must equal the
original exactly.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import openvr_fsr_tpu as J  # noqa: E402
from openvr_fsr_tpu.core import constants as JC  # noqa: E402
from openvr_fsr_tpu.core import foveation as JF  # noqa: E402
from openvr_fsr_tpu.core import projection as JP  # noqa: E402
from openvr_fsr_tpu.ops.easu import easu_index_maps as j_easu_index_maps  # noqa: E402
from openvr_fsr_tpu.utils import frames as JFR  # noqa: E402

import openvr_fsr_tpu_torch as T  # noqa: E402
from openvr_fsr_tpu_torch.core import constants as TC  # noqa: E402
from openvr_fsr_tpu_torch.core import foveation as TF  # noqa: E402
from openvr_fsr_tpu_torch.core import projection as TP  # noqa: E402
from openvr_fsr_tpu_torch.ops.bilinear import bilinear_axis  # noqa: E402
from openvr_fsr_tpu_torch.ops.easu import easu_index_maps  # noqa: E402
from openvr_fsr_tpu_torch.utils import frames as TFR  # noqa: E402
from openvr_fsr_tpu_torch.utils.timing import GpuTimer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (in_w, in_h, render_scale): the main path, the test sizes, a supersample
SIZES = [(1683, 1869, 0.75), (128, 96, 0.75), (56, 48, 0.75), (72, 64, 1.3),
         (2244, 2492, 1.3), (100, 80, 0.5), (64, 64, 0.67)]


def _bits_equal(a, b):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


class TestConfig:
    @pytest.mark.parametrize("kw", [
        {},
        dict(enabled=True, render_scale=0.75, sharpness=0.9, radius=0.5),
        dict(enabled=True, use_nis=True, render_scale=0.59, debug_mode=True),
        dict(use_cas=True, render_scale=1.3, sharpness=0.0, radius=2.0,
             apply_mip_bias=False),
    ])
    def test_config_from_dict_round_trip(self, kw):
        jcfg = J.Config(**kw).with_(hotkeys=dataclasses.replace(
            J.Config().hotkeys, require_alt=True, capture_output=99))
        tcfg = T.Config.config_from_dict(dataclasses.asdict(jcfg))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert T.Config.config_from_dict(dataclasses.asdict(tcfg)) == tcfg

    @pytest.mark.parametrize("rs", [0.5, 0.59, 0.67, 0.75, 0.77, 1.0, 1.3, 2.0])
    @pytest.mark.parametrize("use_nis,use_cas", [(False, False), (True, False),
                                                 (False, True)])
    def test_output_size_and_stage_plan(self, rs, use_nis, use_cas):
        jcfg = J.Config(render_scale=rs, use_nis=use_nis, use_cas=use_cas)
        tcfg = T.Config.config_from_dict(dataclasses.asdict(jcfg))
        assert tcfg.stage_plan() == jcfg.stage_plan()
        for w, h, _ in SIZES:
            assert tcfg.output_size(w, h) == jcfg.output_size(w, h)

    @pytest.mark.parametrize("text", [
        """{ "fsr": { // comment
              "enabled": true, "renderScale": 0.77, "sharpness": 0.9,
              "radius": 0.5, "debugMode": false,
              "hotkeys": { "enabled": true, "toggleUseNIS": 112 } } }""",
        '{"fsr": {"sharpness": -2}}',
        "not json {",
        '{"fsr": {"useCAS": true, "renderScale": 1.3, "applyMIPBias": false}}',
    ])
    def test_load_config_matches(self, text):
        assert (dataclasses.asdict(T.load_config(text=text))
                == dataclasses.asdict(J.load_config(text=text)))

    def test_missing_file_gives_defaults(self, tmp_path):
        assert T.load_config(path=tmp_path / "absent.cfg") == T.Config()


class TestConstantTables:
    @pytest.mark.parametrize("w,h,rs", SIZES)
    def test_easu_con_and_index_maps(self, w, h, rs):
        ow, oh = J.Config(render_scale=rs).output_size(w, h)
        jcon = JC.fsr_easu_con(w, h, w, h, ow, oh)
        tcon = TC.fsr_easu_con(w, h, w, h, ow, oh)
        for a, b in zip(jcon, tcon):
            assert _bits_equal(a, b)
        con0 = np.asarray(tcon[0], np.float32)
        for a, b in zip(j_easu_index_maps(w, h, ow, oh, con0),
                        easu_index_maps(w, h, ow, oh, con0)):
            assert _bits_equal(a, b)

    @pytest.mark.parametrize("w,h,rs", SIZES)
    def test_bilinear_axis_maps(self, w, h, rs):
        from openvr_fsr_tpu.kernels.fsr import _bilinear_axis
        ow, oh = J.Config(render_scale=rs).output_size(w, h)
        for n_out, n_in in ((ow, w), (oh, h)):
            for a, b in zip(_bilinear_axis(n_out, n_in),
                            bilinear_axis(n_out, n_in)):
                assert _bits_equal(a, b)

    @pytest.mark.parametrize("s", [0.0, 0.25, 0.5, 0.75, 0.9, 1.0, 1.5, -0.3])
    def test_rcas_con(self, s):
        assert _bits_equal(JC.rcas_stops_from_slider(s),
                           TC.rcas_stops_from_slider(s))
        assert _bits_equal(JC.fsr_rcas_con(JC.rcas_stops_from_slider(s)),
                           TC.fsr_rcas_con(TC.rcas_stops_from_slider(s)))
        assert _bits_equal(JC.RCAS_LIMIT, TC.RCAS_LIMIT)

    @pytest.mark.parametrize("radius", [0.0, 0.3, 0.5, 1.0, 2.0])
    @pytest.mark.parametrize("single_eye", [True, False])
    def test_centres_payload(self, radius, single_eye):
        centers = ((0.47, 0.52), (0.55, 0.49))
        for w, h, rs in SIZES:
            ow, oh = J.Config(render_scale=rs).output_size(w, h)
            for eyes in ((0, 1), (1,), (0, 1, 1, 0)):
                assert _bits_equal(
                    JC.centres_payload(ow, oh, radius, centers, eyes,
                                       single_eye),
                    TC.centres_payload(ow, oh, radius, centers, eyes,
                                       single_eye))
            for eye in (0, 1):
                assert (dataclasses.astuple(JC.foveation_constants(
                    ow, oh, radius, *centers, single_eye, eye))
                        == dataclasses.astuple(TC.foveation_constants(
                            ow, oh, radius, *centers, single_eye, eye)))

    @pytest.mark.parametrize("radius", [0.0, 0.3, 0.5, 2.0])
    def test_pixel_and_tile_masks(self, radius):
        for w, h, rs in SIZES:
            ow, oh = J.Config(render_scale=rs).output_size(w, h)
            fc = JC.foveation_constants(ow, oh, radius, (0.5, 0.5),
                                        (0.5, 0.5))
            args = (ow, oh, TF.TILE_FSR, (fc.centre_left, fc.centre_right),
                    fc.radius_sq)
            assert _bits_equal(JF.tile_mask(*args), TF.tile_mask(*args))
            assert _bits_equal(JF.pixel_mask(*args), TF.pixel_mask(*args))
        assert TF.TILE_FSR == JF.TILE_FSR

    @pytest.mark.parametrize("radius", [0.0, 0.4, 2.0])
    @pytest.mark.parametrize("tile", ["TILE_NIS_SCALER", "TILE_NIS_SHARPEN"])
    def test_nis_tile_masks(self, radius, tile):
        assert getattr(TF, tile) == getattr(JF, tile)
        for w, h, rs in SIZES:
            ow, oh = J.Config(render_scale=rs).output_size(w, h)
            fc = JC.foveation_constants(ow, oh, radius, (0.45, 0.5),
                                        (0.55, 0.5))
            args = (ow, oh, getattr(TF, tile),
                    (fc.centre_left, fc.centre_right), fc.radius_sq)
            assert _bits_equal(JF.tile_mask(*args), TF.tile_mask(*args))
            assert _bits_equal(JF.pixel_mask(*args), TF.pixel_mask(*args))

    @pytest.mark.parametrize("upscaling", [True, False])
    @pytest.mark.parametrize("arch", ["nvidia", "amd", "intel"])
    def test_nis_optimal_block(self, upscaling, arch):
        assert (TF.nis_optimal_block(upscaling, arch)
                == JF.nis_optimal_block(upscaling, arch))
        with pytest.raises(ValueError):
            TF.nis_optimal_block(upscaling, "other")

    def test_projection(self):
        assert TP.default_centers() == JP.default_centers()
        for args in ((-1.2, 1.0, -1.1, 0.9, 0.0), (-1.0, 1.0, -1.0, 1.0, 0.1)):
            assert TP.projection_center(*args) == JP.projection_center(*args)

    @pytest.mark.parametrize("eye", [0, 1])
    def test_canted_angle(self, eye):
        """Over a grid of forward axes: unit ones canted in yaw and pitch,
        unnormalised ones (the dot clamps to [-1, 1]), opposite ones."""
        rng = np.random.default_rng(7)
        axes = [(0.0, 0.0, -1.0), (0.0, 0.0, 1.0), (0.2, 0.0, -1.0),
                (-0.3, 0.1, -2.0)]
        for a in np.linspace(-0.6, 0.6, 7):
            axes.append((np.sin(a), 0.0, -np.cos(a)))
            axes.append((0.0, np.sin(a), -np.cos(a)))
        axes += [tuple(v) for v in rng.normal(size=(8, 3))]
        for fl in axes:
            for fr in axes:
                assert TP.canted_angle(fl, fr, eye) == \
                    JP.canted_angle(fl, fr, eye)

    def test_mip_lod_bias(self):
        for in_w in (640, 1683, 2016, 2244, 5760):
            for out_w in (640, 1024, 2244, 2917, 7680):
                got = TP.mip_lod_bias(in_w, out_w)
                assert got == JP.mip_lod_bias(in_w, out_w)
                assert type(got) is float


def _nis_cfg_equal(a, b):
    """Every NisConfig field equal, bit for bit (floats) or by value."""
    for f in dataclasses.fields(JC.NisConfig):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, (np.floating, float)):
            assert _bits_equal(np.float32(x), np.float32(y)), f.name
            assert type(x) is type(y), f.name
        else:
            assert x == y, f.name


class TestNisConstants:
    """The copied NVScalerUpdateConfig / NVSharpenUpdateConfig and filter
    tables: the NIS "weights" of the port."""

    @pytest.mark.parametrize("sharpness", [0.0, 0.3, 0.5, 0.66, 0.9, 1.0,
                                           1.4, -0.2])
    @pytest.mark.parametrize("hdr_mode", [0, 1, 2])
    @pytest.mark.parametrize("w,h,rs", SIZES + [(64, 48, 0.3), (40, 30, 1.0)])
    def test_nvscaler_update_config(self, sharpness, hdr_mode, w, h, rs):
        ow, oh = J.Config(render_scale=rs).output_size(w, h)
        args = (sharpness, w, h, w, h, ow, oh, ow, oh)
        j = JC.nvscaler_update_config(*args, hdr_mode=hdr_mode)
        t = TC.nvscaler_update_config(*args, hdr_mode=hdr_mode)
        _nis_cfg_equal(j, t)
        assert t.valid == (0.5 <= w / ow <= 1.0 and 0.5 <= h / oh <= 1.0) \
            or rs == 1.0

    @pytest.mark.parametrize("sharpness", [0.2, 0.5, 0.9])
    @pytest.mark.parametrize("hdr_mode", [0, 1, 2])
    def test_nvsharpen_update_config(self, sharpness, hdr_mode):
        for w, h in ((2244, 2492), (56, 48), (0, 48)):
            _nis_cfg_equal(
                JC.nvsharpen_update_config(sharpness, w, h, w, h,
                                           hdr_mode=hdr_mode),
                TC.nvsharpen_update_config(sharpness, w, h, w, h,
                                           hdr_mode=hdr_mode))

    def test_tables_and_sizes(self):
        from openvr_fsr_tpu.core import nis_tables as JT
        from openvr_fsr_tpu_torch.core import nis_tables as TT
        assert _bits_equal(JT.COEF_SCALE, TT.COEF_SCALE)
        assert _bits_equal(JT.COEF_USM, TT.COEF_USM)
        assert TT.COEF_SCALE.shape == TT.COEF_USM.shape == (64, 8)
        assert (TC.NIS_PHASE_COUNT, TC.NIS_FILTER_SIZE) == (
            JC.NIS_PHASE_COUNT, JC.NIS_FILTER_SIZE)

    def test_use_nis_survives_config_from_dict(self):
        jcfg = J.Config(enabled=True, use_nis=True, render_scale=0.75)
        tcfg = T.Config.config_from_dict(dataclasses.asdict(jcfg))
        assert tcfg.use_nis and tcfg.stage_plan() == jcfg.stage_plan()
        assert not T.Config.config_from_dict(dataclasses.asdict(
            jcfg.with_(use_nis=False))).use_nis


class TestFrames:
    @pytest.mark.parametrize("name", ["gradient_frame", "checkerboard_frame",
                                      "zone_plate_frame", "noise_frame"])
    def test_synthetic_frames_equal(self, name):
        for h, w in ((48, 56), (96, 128), (1869 // 8, 1683 // 8)):
            assert _bits_equal(getattr(JFR, name)(h, w),
                               getattr(TFR, name)(h, w))

    @pytest.mark.parametrize("dtype,bits,channels", [
        (np.uint8, 8, 4), (np.uint8, 8, 3), (np.uint16, 10, 4),
        (np.uint16, 10, 3)])
    def test_planar_round_trip_matches_jax(self, dtype, bits, channels):
        rng = np.random.default_rng(11)
        top = (1 << bits) - 1
        frames = rng.integers(0, top + 1, (2, 12, 20, channels)).astype(dtype)
        if channels == 4 and bits == 10:
            frames[..., 3] = rng.integers(0, 4, (2, 12, 20))
        jp = np.asarray(JFR.to_planar(frames, bits))
        tp = TFR.to_planar(torch.from_numpy(frames), bits)
        assert _bits_equal(jp, tp.numpy())
        assert _bits_equal(np.asarray(JFR.from_planar(jp, bits)),
                           TFR.from_planar(tp, bits).numpy())


class TestGpuTimer:
    def test_rolling_average_logs_at_window(self):
        t = GpuTimer(window=4)
        x = torch.zeros(8)
        for _ in range(3):
            t.measure(torch.neg, x)
        assert t.last_avg_ms is None and t.count == 3
        out = t.measure(torch.neg, x, pairs=0.5)
        assert torch.equal(out, -x)
        assert t.last_avg_ms is not None and t.last_avg_ms > 0
        assert t.count == 0 and t.summed == 0.0


def test_port_never_imports_jax():
    """`import openvr_fsr_tpu_torch` (the GPU machine has no jax) pulls in
    neither jax nor the JAX package, with every submodule imported,
    the DMA floor, the rate probes, the two bench entries, the audit, the
    A/B tool, the oracle copy, capture, the parity tool, the throughput
    tool, parallel/, the spatial strips' tool, the half tool, the native
    runtime bindings and the stream, 8K and demo tools included;
    the half precision code needs no ml_dtypes either (torch.bfloat16)."""
    code = ("import sys, openvr_fsr_tpu_torch, openvr_fsr_tpu_torch.kernels, "
            "openvr_fsr_tpu_torch.oracle, openvr_fsr_tpu_torch.oracle.pipeline, "
            "openvr_fsr_tpu_torch.api.capture, "
            "openvr_fsr_tpu_torch.tools.parity, "
            "openvr_fsr_tpu_torch.tools.throughput_bench, "
            "openvr_fsr_tpu_torch.kernels._build, openvr_fsr_tpu_torch.ops, "
            "openvr_fsr_tpu_torch.utils, openvr_fsr_tpu_torch.api, "
            "openvr_fsr_tpu_torch.kernels.sol, openvr_fsr_tpu_torch.bench, "
            "openvr_fsr_tpu_torch.tools.bench_paths, "
            "openvr_fsr_tpu_torch.tools.vpu_audit, "
            "openvr_fsr_tpu_torch.tools.sass, openvr_fsr_tpu_torch.tools.ab, "
            "openvr_fsr_tpu_torch.kernels.cas, "
            "openvr_fsr_tpu_torch.kernels.nis, "
            "openvr_fsr_tpu_torch.kernels.fsr, "
            "openvr_fsr_tpu_torch.parallel, "
            "openvr_fsr_tpu_torch.parallel.sharding, "
            "openvr_fsr_tpu_torch.parallel.spatial, "
            "openvr_fsr_tpu_torch.tools.spatial_onchip, "
            "openvr_fsr_tpu_torch.tools.half_bench, "
            "openvr_fsr_tpu_torch.native_rt, "
            "openvr_fsr_tpu_torch.tools.stream_bench, "
            "openvr_fsr_tpu_torch.tools.bench_8k, "
            "openvr_fsr_tpu_torch.tools.demo;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'openvr_fsr_tpu', 'ml_dtypes'));"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
