"""The port end to end on the CPU: `Pipeline.process` and `upscale` against
the JAX package's `Pipeline(backend="xla")` and the NumPy oracle, over the
four stage plans the port runs (FSR upscale, FSR at renderScale 1, NIS
upscale, NIS at renderScale 1), and the plans and options it refuses.

Against XLA:CPU (which contracts FMAs) the bar is the JAX package's
quantized tier: at least 99.9% of texels equal, max 2 LSB. Against the
oracle the port is bit-exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import openvr_fsr_tpu as J  # noqa: E402
from openvr_fsr_tpu.oracle.pipeline import pipeline_oracle  # noqa: E402
from openvr_fsr_tpu.utils import frames as JFR  # noqa: E402

import openvr_fsr_tpu_torch as T  # noqa: E402

MAIN = dict(enabled=True, render_scale=0.75, sharpness=0.9, radius=0.5)
# the stage plans beyond the FSR upscale: FSR sharpen-only, NVScaler,
# NVSharpen
PLANS = [dict(MAIN, render_scale=1.0), dict(MAIN, use_nis=True),
         dict(MAIN, use_nis=True, render_scale=1.0)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, ref, frac=0.999, worst=2):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.view(np.uint8).astype(int) - ref.view(np.uint8).astype(int))
    assert (d == 0).mean() >= frac, (d == 0).mean()
    assert d.max() <= worst, d.max()


def _stereo(h, w, alpha=None):
    f = np.stack([JFR.zone_plate_frame(h, w), JFR.noise_frame(h, w, seed=3)])
    if alpha is not None:
        f[..., 3] = alpha
    return f


def _pair(hdr_mode=0, **kw):
    return (T.Pipeline(T.Config(**kw), hdr_mode=hdr_mode, device="cpu"),
            J.Pipeline(J.Config(**kw), backend="xla", hdr_mode=hdr_mode))


class TestAgainstJax:
    @pytest.mark.parametrize("h,w,kw", [
        (96, 128, MAIN),
        (48, 56, dict(MAIN, radius=2.0)),
        (64, 72, dict(MAIN, render_scale=1.3, radius=0.0)),
        (48, 56, dict(MAIN, radius=0.3, debug_mode=True)),
    ])
    def test_uint8_nhwc(self, h, w, kw):
        tp, jp = _pair(**kw)
        frames = _stereo(h, w)
        got = tp.process(frames)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
        _assert_close(got, jp.process(frames))

    def test_packed_u32_zero_copy(self):
        tp, jp = _pair(**MAIN)
        packed = np.ascontiguousarray(_stereo(48, 56)).view(np.uint32)[..., 0]
        got = tp.process(packed)
        assert got.dtype == torch.uint32 and got.shape == (2, 64, 74)
        _assert_close(got, jp.process(packed))
        # the same texels as the uint8 path, and int32 planes work too
        u8 = tp.process(_stereo(48, 56))
        assert np.array_equal(_np(got).view(np.uint8).reshape(u8.shape),
                              u8.numpy())
        i32 = tp.process(torch.from_numpy(packed.view(np.int32)))
        assert i32.dtype == torch.int32
        assert np.array_equal(i32.numpy().view(np.uint32), _np(got))

    def test_single_frame_and_eyes(self):
        tp, jp = _pair(**MAIN)
        frame = JFR.zone_plate_frame(48, 56)
        for eyes in (None, (1,)):
            got = tp.process(frame, eyes=eyes)
            assert got.shape == (64, 74, 4)
            _assert_close(got, jp.process(frame, eyes=eyes))

    def test_rgb_input_gets_opaque_alpha(self):
        tp, jp = _pair(**MAIN)
        rgb = _stereo(48, 56)[..., :3]
        got = tp.process(rgb)
        assert (got.numpy()[..., 3] == 255).all()
        _assert_close(got, jp.process(rgb))

    def test_bounds_switch_layout_and_crop(self):
        tp, jp = _pair(**MAIN)
        frames = _stereo(48, 112)
        half = (0.0, 0.0, 0.5, 1.0)          # double-wide: one eye per half
        got = tp.process(frames, bounds=half, crop=True)
        assert not tp.single_eye_per_frame
        _assert_close(got, jp.process(frames, bounds=half, crop=True))
        # flipped full bounds switch back to single-eye frames
        full = [(0.0, 1.0, 1.0, 0.0)] * 2
        got = tp.process(frames, bounds=full, crop=True)
        assert tp.single_eye_per_frame
        _assert_close(got, jp.process(frames, bounds=full, crop=True))

    def test_mutators_and_reset(self):
        tp, jp = _pair(**MAIN)
        frames = _stereo(48, 56)
        tp.process(frames)
        assert len(tp._cache) == 1 and len(tp.kernels) == 1
        tp.process(frames)
        assert len(tp._cache) == 1            # the build cache hit
        for mutate in (lambda p: p.adjust_sharpness(-0.4),
                       lambda p: p.adjust_radius(0.5),
                       lambda p: p.toggle_debug(),
                       lambda p: p.adjust_radius(-10.0)):
            mutate(tp)
            mutate(jp)
            assert tp._cache == {}
            assert (tp.config.sharpness, tp.config.radius,
                    tp.config.debug_mode) == (jp.config.sharpness,
                                              jp.config.radius,
                                              jp.config.debug_mode)
            _assert_close(tp.process(frames), jp.process(frames))
        tp.reset()
        assert tp._cache == {}

    def test_upscale(self):
        frame = JFR.zone_plate_frame(48, 56)
        got = T.upscale(frame, render_scale=0.75, sharpness=0.9, radius=0.5,
                        device="cpu")
        _assert_close(got, J.upscale(frame, render_scale=0.75, sharpness=0.9,
                                     radius=0.5, backend="xla"))

    @pytest.mark.parametrize("kw", PLANS, ids=["rcas", "nvscaler",
                                               "nvsharpen"])
    def test_new_plans_uint8_and_packed(self, kw):
        tp, jp = _pair(**dict(kw, radius=0.4))
        frames = _stereo(64, 70, alpha=200)
        got = tp.process(frames)
        _assert_close(got, jp.process(frames))
        packed = np.ascontiguousarray(frames).view(np.uint32)[..., 0]
        got_p = tp.process(packed)
        assert got_p.dtype == torch.uint32
        assert np.array_equal(_np(got_p).view(np.uint8).reshape(got.shape),
                              got.numpy())
        assert len(tp.kernels) == 2

    @pytest.mark.parametrize("rs", [0.75, None])
    def test_upscale_nis(self, rs):
        frame = _stereo(48, 56, alpha=190)[0]
        got = T.upscale(frame, render_scale=rs, use_nis=True, radius=2.0,
                        device="cpu")
        _assert_close(got, J.upscale(frame, render_scale=rs, use_nis=True,
                                     radius=2.0, backend="xla"))


class TestAgainstOracle:
    @pytest.mark.parametrize("radius,debug", [(0.5, False), (0.0, True)])
    def test_bit_exact(self, radius, debug):
        frames = _stereo(96, 128)
        got = T.Pipeline(T.Config(**dict(MAIN, radius=radius,
                                         debug_mode=debug)),
                         device="cpu").process(frames)
        want = np.stack([pipeline_oracle(frames[i], 0.75, 0.9, radius=radius,
                                         debug=debug, eye=i)
                         for i in range(2)])
        assert np.array_equal(got.numpy(), want)

    @pytest.mark.parametrize("kw", PLANS, ids=["rcas", "nvscaler",
                                               "nvsharpen"])
    @pytest.mark.parametrize("radius,debug,hdr_mode", [(0.5, True, 0),
                                                       (2.0, False, 1),
                                                       (2.0, False, 2)])
    def test_new_plans_bit_exact(self, kw, radius, debug, hdr_mode):
        frames = _stereo(72, 80, alpha=np.arange(80, dtype=np.uint8))
        cfg = dict(kw, radius=radius, debug_mode=debug)
        got = T.Pipeline(T.Config(**cfg), hdr_mode=hdr_mode,
                         device="cpu").process(frames)
        want = np.stack([pipeline_oracle(
            frames[i], cfg["render_scale"], 0.9, use_nis=cfg.get(
                "use_nis", False), radius=radius, debug=debug,
            hdr_mode=hdr_mode, eye=i) for i in range(2)])
        assert np.array_equal(got.numpy(), want)


class TestHdrMode:
    """hdr_mode is stored, reaches both NIS configs and keys the build
    cache (the JAX package's api/pipeline.py:105-107, 241-242, 271-273,
    594-596)."""

    @pytest.mark.parametrize("rs", [1.0, 0.75])
    def test_hdr_mode_changes_nis_output(self, rs):
        cfg = T.Config(**dict(MAIN, use_nis=True, render_scale=rs,
                              radius=2.0))
        frames = _stereo(48, 56)
        sdr = T.Pipeline(cfg, device="cpu").process(frames)
        pipe = T.Pipeline(cfg, hdr_mode=1, device="cpu")
        assert pipe.hdr_mode == 1
        linear = pipe.process(frames)
        assert not torch.equal(sdr, linear)
        _assert_close(linear, J.Pipeline(J.Config(**dict(
            MAIN, use_nis=True, render_scale=rs, radius=2.0)),
            backend="xla", hdr_mode=1).process(frames))
        # one pipeline, hdr_mode switched: a cache entry of its own each
        pipe.hdr_mode = 0
        assert torch.equal(pipe.process(frames), sdr)
        assert len(pipe._cache) == 2
        pipe.hdr_mode = 1
        assert torch.equal(pipe.process(frames), linear)
        assert len(pipe._cache) == 2

    def test_hdr_mode_outside_nis_modes_raises(self):
        with pytest.raises(ValueError, match="hdr_mode"):
            T.Pipeline(T.Config(**MAIN), hdr_mode=3, device="cpu")


class TestApi:
    def test_disabled_returns_input(self):
        frames = _stereo(48, 56)
        assert T.Pipeline(T.Config(enabled=False),
                          device="cpu").process(frames) is frames

    def test_debug_timer_counts(self):
        tp = T.Pipeline(T.Config(**dict(MAIN, debug_mode=True)), device="cpu")
        tp.process(_stereo(48, 56))
        assert tp.timer.count == 1 and tp.timer.summed > 0

    def test_config_from_jax(self):
        import dataclasses
        jcfg = J.Config(**MAIN)
        tp = T.Pipeline(T.Config.config_from_dict(dataclasses.asdict(jcfg)),
                        device="cpu")
        _assert_close(tp.process(_stereo(48, 56)),
                      J.Pipeline(jcfg, backend="xla").process(_stereo(48, 56)))

    def test_explicit_cpu_device(self):
        tp = T.Pipeline(T.Config(**MAIN), device="cpu")
        out = tp.process(_stereo(48, 56))
        assert out.device.type == "cpu"
        assert tp.kernels[0].launches == 0

    def test_cuda_without_gpu_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA GPU is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            T.Pipeline(T.Config(**MAIN), device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            T.upscale(_stereo(48, 56), render_scale=0.75, device="cuda")

    def test_tensor_on_another_device_raises(self):
        tp = T.Pipeline(T.Config(**MAIN), device="cpu")
        with pytest.raises(ValueError, match="device"):
            tp.process(torch.from_numpy(_stereo(48, 56)).to("meta"))

    @pytest.mark.parametrize("kw,entry", [
        (dict(MAIN, render_scale=1.0), "B2"),
        (dict(MAIN, use_nis=True), "item 10"),
        (dict(MAIN, use_cas=True), "item 11"),
    ])
    def test_unported_plans_raise(self, kw, entry):
        """The plans the first slice refused: FSR at renderScale 1 (B2), NIS
        (item 10) and CAS (item 11) now run and match the JAX XLA
        pipeline."""
        frames = _stereo(48, 56, alpha=180)
        tp, jp = _pair(**kw)
        _assert_close(tp.process(frames), jp.process(frames))

    def test_toggle_nis_then_process_raises(self):
        """The NIS hotkey on a live pipeline: NVScaler runs (it raised
        before NIS was ported) and matches the JAX XLA pipeline toggled the
        same way; toggling back gives the FSR output again."""
        tp, jp = _pair(**MAIN)
        frames = _stereo(48, 56, alpha=180)
        fsr = tp.process(frames)
        jp.process(frames)
        tp.toggle_nis()
        jp.toggle_nis()
        assert tp._cache == {} and tp.config.use_nis
        _assert_close(tp.process(frames), jp.process(frames))
        tp.toggle_nis()
        assert torch.equal(tp.process(frames), fsr)

    @pytest.mark.parametrize("kw", [dict(color_bits=10),
                                    dict(precision="half")])
    def test_unported_options_raise(self, kw):
        """Both options raised before they were ported and now run.
        precision="half" on a NIS plan (ROADMAP Queue A 6b; the half plans
        are held to the JAX half kernels in tests/test_torch_half.py and
        tests/test_torch_nis_half.py): the half build runs, within the JAX
        suite's bar for NIS half of the full output (95% within 2 LSB,
        99.9% within 32). color_bits=10: uint16 frames in and out, within
        the quantized tier of the JAX XLA pipeline's 10-bit values."""
        if "precision" in kw:
            frames = _stereo(48, 56)
            pipe = T.Pipeline(T.Config(**MAIN, use_nis=True), device="cpu",
                              **kw)
            got = pipe.process(frames).numpy().astype(int)
            assert [fn.precision for fn in pipe.kernels] == ["half"]
            full = T.Pipeline(T.Config(**MAIN, use_nis=True),
                              device="cpu").process(frames).numpy()
            d = np.abs(got - full.astype(int))
            assert (d <= 2).mean() >= 0.95 and (d <= 32).mean() >= 0.999
            return
        frames = _stereo(48, 56).astype(np.uint16) * 4
        frames[..., 3] = np.arange(48 * 56).reshape(48, 56) % 4
        got = T.Pipeline(T.Config(**MAIN), device="cpu", **kw).process(
            frames)
        want = np.asarray(J.Pipeline(J.Config(**MAIN), backend="xla",
                                     **kw).process(frames))
        assert got.dtype == torch.uint16 and got.shape == want.shape
        d = np.abs(got.numpy().astype(int) - want.astype(int))
        assert (d == 0).mean() >= 0.999 and d.max() <= 2

    def test_capture_raises(self, tmp_path):
        """arm_capture raised NotImplementedError before capture was
        ported; now it arms and raises nothing, and the next left-eye
        frame is saved: the port's file holds its output, under the JAX
        pipeline's name (less the time stamp)."""
        from openvr_fsr_tpu_torch.api.capture import read_dds_rgba8

        frames = _stereo(48, 56)
        tp, jp = _pair(**MAIN)
        tp.arm_capture(tmp_path / "t")
        jp.arm_capture(tmp_path / "j")
        out = tp.process(frames)
        jp.process(frames)
        (got,) = tp.last_capture_paths
        (want,) = jp.last_capture_paths
        assert got.name.split("_", 3)[3] == want.name.split("_", 3)[3] \
            == "fsr_s90_r50.dds"
        assert np.array_equal(read_dds_rgba8(got), out[0].numpy())

    @pytest.mark.parametrize("backend", ["xla", "pallas", "pallas-interpret"])
    def test_other_backends_raise(self, backend):
        with pytest.raises(ValueError, match="backend"):
            T.Pipeline(T.Config(**MAIN), backend=backend, device="cpu")

    def test_other_dtypes_raise(self):
        with pytest.raises(TypeError):
            T.Pipeline(T.Config(**MAIN), device="cpu").process(
                _stereo(48, 56).astype(np.float32))
