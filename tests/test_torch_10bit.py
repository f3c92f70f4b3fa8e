"""The port's 10-bit path (color_bits=10, R10G10B10A2 passthrough) on the
CPU: the texel codec, the six kernel modules' plain versions, the pipeline,
the DMA floor's 10-bit geometry and the 10-bit capture.

All comparisons are of 10-bit values ((B, H, W, 4) uint16 frames, RGB in
[0, 1023], alpha in [0, 3]), never of bytes. The plain versions are held
bit for bit against the port's NumPy oracle (oracle/pipeline.py at
color_bits=10, itself bit-equal to the JAX package's); against the JAX
package's Pallas kernels in interpret mode and its XLA pipeline, whose
XLA:CPU contracts FMAs, the bar is the quantized tier of the existing
tests: at least 99.9% of values equal, at most 2 LSB.

The CUDA kernels themselves run only on the card: `python3 chip_smoke.py`
holds the 10-bit instantiations against these plain versions there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import openvr_fsr_tpu as J  # noqa: E402
from openvr_fsr_tpu.utils import frames as JFR  # noqa: E402

import openvr_fsr_tpu_torch as T  # noqa: E402
from openvr_fsr_tpu_torch.kernels import _build, _common, sol  # noqa: E402
from openvr_fsr_tpu_torch.oracle.pipeline import pipeline_oracle  # noqa: E402

from torch_entry_calls import entry_calls  # noqa: E402,F401

# plan (the kernel source) -> its Config kwargs
PLANS = {
    "fsr_fused": dict(render_scale=0.75),
    "rcas_sharpen": dict(render_scale=1.0),
    "nis_scaler": dict(render_scale=0.75, use_nis=True),
    "nis_sharpen": dict(render_scale=1.0, use_nis=True),
    "cas_upscale": dict(render_scale=0.75, use_cas=True),
    "cas_sharpen": dict(render_scale=1.0, use_cas=True),
}
OFF_CENTRE = ((0.3, 0.6), (0.7, 0.4))


def _frames(h, w, seed=0, b=2):
    """(b, h, w, 4) uint16: RGB in [0, 1023], alpha in {0, 1, 2, 3}."""
    rng = np.random.default_rng(seed + h * w)
    f = rng.integers(0, 1024, (b, h, w, 4)).astype(np.uint16)
    f[..., 3] = rng.integers(0, 4, (b, h, w))
    return f


def _sharpness(plan):
    return 0.8 if plan.startswith("cas") else 0.9


def _config(cls, plan, radius=0.5, debug=False):
    return cls(enabled=True, sharpness=_sharpness(plan), radius=radius,
               debug_mode=debug, **PLANS[plan])


def _pipe(plan, radius=0.5, debug=False, eye_centers=None, hdr_mode=0,
          mcd=1.0):
    return T.Pipeline(_config(T.Config, plan, radius, debug),
                      eye_centers=eye_centers, color_bits=10,
                      hdr_mode=hdr_mode, cas_max_color_delta=mcd,
                      device="cpu")


def _assert_close(got, ref, frac=0.999, worst=2):
    """The quantized tier over 10-bit values."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint16
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert (d == 0).mean() >= frac, (d == 0).mean()
    assert d.max() <= worst, d.max()


# ---- the texel codec ---------------------------------------------------------

def _every_value():
    """(1, 64, 16, 4) uint16 holding every RGB value 0..1023 in each colour
    channel and every alpha 0..3."""
    v = np.arange(1024, dtype=np.uint16).reshape(64, 16)
    f = np.stack([v, v[::-1], np.roll(v, 7), v % 4], axis=-1)
    return f[None]


def test_codec_round_trips_every_value():
    """All 1024 RGB values and the 4 alpha values decode as the JAX
    to_planar does (u / 1023, a / 3) and encode back to themselves."""
    f = _every_value()
    planes = _common.unpack(torch.from_numpy(f), 4, 10)
    want = np.asarray(JFR.to_planar(f, 10))
    assert planes.dtype == torch.float32
    assert np.array_equal(planes.numpy(), want)
    back = _common.pack(planes[:, :3], planes[:, 3], 10)
    assert back.dtype == torch.uint16 and np.array_equal(back.numpy(), f)
    rgb_only = _common.pack(planes[:, :3], None, 10).numpy()
    assert np.array_equal(rgb_only[..., :3], f[..., :3])
    assert (rgb_only[..., 3] == 3).all()
    assert np.array_equal(_common.unpack(torch.from_numpy(f), 3, 10).numpy(),
                          want[:, :3])


def test_codec_decodes_out_of_range_values_unmasked():
    """Values above 1023 (and alphas above 3) decode from the whole 16-bit
    value and saturate at the encode, as the JAX to_planar and from_planar
    do: nothing is masked to 10 or 2 bits."""
    f = _every_value()
    f[0, 0, :6] = [[1024, 2047, 4095, 4], [65535, 1023, 0, 65535],
                   [1025, 0, 65534, 7], [0, 0, 0, 0], [3000, 1, 2, 3],
                   [1023, 1024, 1022, 2]]
    planes = _common.unpack(torch.from_numpy(f), 4, 10)
    want = np.asarray(JFR.to_planar(f, 10))
    assert np.array_equal(planes.numpy(), want)
    got = _common.pack(planes[:, :3], planes[:, 3], 10).numpy()
    assert np.array_equal(got, np.asarray(JFR.from_planar(want, 10)))
    assert (got[0, 0, 0] == [1023, 1023, 1023, 3]).all()


def test_codec_keeps_eight_bit():
    """The 8-bit codec is the packed RGBA8 one, unchanged by the 10-bit
    path."""
    f = np.random.default_rng(3).integers(0, 256, (1, 8, 8, 4)).astype(
        np.uint8)
    plane = torch.from_numpy(np.ascontiguousarray(f).view(np.int32)[..., 0])
    planes = _common.unpack(plane)
    assert np.array_equal(planes.numpy(), np.asarray(JFR.to_planar(f)))
    assert torch.equal(_common.pack(planes[:, :3], planes[:, 3]), plane)
    assert _common.texel_words(8) == 1 and _common.texel_words(10) == 2
    with pytest.raises(ValueError, match="color_bits"):
        _common.texel_words(12)


# ---- the six plain versions against the oracle ------------------------------

ORACLE_CASES = [(p, r, d, e) for p in PLANS
                for r, d, e in ((0.5, False, None), (2.0, False, None),
                                (0.0, True, None), (0.3, False, OFF_CENTRE))]


@pytest.mark.parametrize("plan,radius,debug,eyes", ORACLE_CASES)
def test_plain_version_bit_exact_to_the_oracle(plan, radius, debug, eyes):
    """Each plan's plain version (the kernel wrapper on CPU tensors, through
    Pipeline(color_bits=10, device="cpu")) equals the oracle value for
    value, eye by eye, alpha in {0..3} included."""
    h, w = 40, 48
    frames = _frames(h, w)
    pipe = _pipe(plan, radius, debug, eyes)
    got = pipe.process(frames).numpy()
    assert got.dtype == np.uint16 and pipe.kernels[0].color_bits == 10
    kw = PLANS[plan]
    want = np.stack([pipeline_oracle(
        frames[i], kw["render_scale"], _sharpness(plan), radius=radius,
        debug=debug, use_nis=kw.get("use_nis", False),
        use_cas=kw.get("use_cas", False), color_bits=10, eye=i,
        eye_centers=eyes or ((0.5, 0.5), (0.5, 0.5))) for i in range(2)])
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("plan,kw", [("nis_scaler", dict(hdr_mode=1)),
                                     ("nis_sharpen", dict(hdr_mode=2)),
                                     ("cas_sharpen", dict(mcd=0.05))])
def test_plain_version_options_bit_exact_to_the_oracle(plan, kw):
    """NIS hdr modes and CAS max_color_delta at 10 bits."""
    frames = _frames(40, 48, seed=1)
    got = _pipe(plan, 0.5, **kw).process(frames).numpy()
    ckw = PLANS[plan]
    want = np.stack([pipeline_oracle(
        frames[i], ckw["render_scale"], _sharpness(plan), radius=0.5,
        use_nis=ckw.get("use_nis", False), use_cas=ckw.get("use_cas", False),
        hdr_mode=kw.get("hdr_mode", 0),
        cas_max_color_delta=kw.get("mcd", 1.0), color_bits=10, eye=i)
        for i in range(2)])
    assert np.array_equal(got, want)


# ---- against the JAX package's Pallas kernels and its XLA pipeline ----------

def _jax_run(plan, h, w, radius, debug, frames):
    """The JAX builder's Pallas kernel at color_bits=10 in interpret mode,
    fed the planar integer texels and packed by from_planar, as the JAX
    pipeline's 10-bit run does (openvr_fsr_tpu/api/pipeline.py:197-345)."""
    from openvr_fsr_tpu.core import constants as JC
    from openvr_fsr_tpu.kernels import cas as jcas
    from openvr_fsr_tpu.kernels import fsr as jfsr
    from openvr_fsr_tpu.kernels import nis as jnis
    from openvr_fsr_tpu.kernels import rcas as jrcas
    cfg = _config(J.Config, plan, radius, debug)
    ow, oh = cfg.output_size(w, h)
    cen = JC.centres_payload(ow, oh, radius, ((0.5, 0.5), (0.5, 0.5)),
                             (0, 1))
    common = dict(centres=cen, color_bits=10, debug=debug, interpret=True)
    s = cfg.sharpness
    if plan == "fsr_fused":
        fn = jfsr.build_fsr_fused(2, h, w, ow, oh, sharpness=s, **common)
    elif plan == "rcas_sharpen":
        fn = jrcas.build_rcas_sharpen(2, h, w, sharpness=s, **common)
    elif plan == "nis_scaler":
        ncfg = JC.nvscaler_update_config(s, w, h, w, h, ow, oh, ow, oh)
        fn = jnis.build_nvscaler(2, h, w, ow, oh, nis_cfg=ncfg, **common)
    elif plan == "nis_sharpen":
        ncfg = JC.nvsharpen_update_config(s, w, h, w, h)
        fn = jnis.build_nvsharpen(2, h, w, nis_cfg=ncfg, **common)
    elif plan == "cas_upscale":
        fn = jcas.build_cas_upscale(2, h, w, ow, oh, sharpness=s, **common)
    else:
        fn = jcas.build_cas_sharpen(2, h, w, sharpness=s, **common)
    ints = np.transpose(frames, (0, 3, 1, 2)).astype(np.float32)
    if plan in ("fsr_fused", "cas_upscale"):
        rgb = np.asarray(fn(ints[:, :3]))
        planes = np.concatenate([rgb, np.ones_like(rgb[:, :1])], axis=1)
    else:
        planes = np.asarray(fn(ints))
    return np.asarray(JFR.from_planar(planes, 10))


@pytest.mark.parametrize("plan", list(PLANS))
def test_close_to_the_pallas_interpret_kernel(plan):
    """The JAX package's 10-bit Pallas kernel in interpret mode, as its
    own CPU tests run it, at radius 0.5 (both tile classes run)."""
    h, w = 40, 48
    frames = _frames(h, w, seed=2)
    got = _pipe(plan, 0.5).process(frames).numpy()
    _assert_close(got, _jax_run(plan, h, w, 0.5, False, frames))


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("radius,debug", [(0.5, False), (0.0, True)])
def test_close_to_the_jax_xla_pipeline(plan, radius, debug):
    """Pipeline(color_bits=10, device="cpu") against the JAX
    Pipeline(backend="xla", color_bits=10), every plan."""
    frames = _frames(36, 44, seed=3)
    got = _pipe(plan, radius, debug).process(frames)
    jp = J.Pipeline(_config(J.Config, plan, radius, debug), backend="xla",
                    color_bits=10)
    _assert_close(got.numpy(), np.asarray(jp.process(frames)))


def test_upscale_and_models_take_color_bits():
    """upscale(color_bits=10) and the model families' color_bits run the
    10-bit path: the same values as Pipeline.process."""
    frames = _frames(36, 44, seed=4)
    want = _pipe("fsr_fused").process(frames)
    got = T.upscale(frames, render_scale=0.75, sharpness=0.9, radius=0.5,
                    color_bits=10, device="cpu")
    assert torch.equal(got, want)
    model = T.FsrModel(render_scale=0.75, color_bits=10, device="cpu")
    assert torch.equal(model(frames), want)
    cas_model = T.get_model("cas", color_bits=10, device="cpu")
    assert torch.equal(cas_model(frames), _pipe("cas_sharpen", 2.0)
                       .process(frames))
    rgb = T.upscale(frames[..., :3], render_scale=0.75, color_bits=10,
                    device="cpu")
    opaque = frames.copy()
    opaque[..., 3] = 3
    assert torch.equal(rgb, T.upscale(opaque, render_scale=0.75,
                                      color_bits=10, device="cpu"))
    single = T.upscale(frames[0], render_scale=0.75, color_bits=10,
                       device="cpu")
    assert single.shape == (48, 58, 4) and single.dtype == torch.uint16


# ---- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_packed_frames_need_eight_bits(dtype):
    """Packed u32 frames raise the JAX package's ValueError at 10 bits."""
    plane = np.zeros((2, 36, 44), dtype)
    with pytest.raises(ValueError, match="packed-u32 frames require "
                                         "color_bits=8"):
        _pipe("fsr_fused").process(plane)


@pytest.mark.parametrize("bits,dtype,want", [
    (10, np.uint8, "uint16"), (10, np.float32, "uint16"),
    (8, np.uint16, "uint8")])
def test_other_dtypes_name_the_expected_one(bits, dtype, want):
    pipe = T.Pipeline(_config(T.Config, "fsr_fused"), color_bits=bits,
                      device="cpu")
    with pytest.raises(TypeError, match=want):
        pipe.process(np.zeros((2, 36, 44, 4), dtype))


def test_other_color_bits_raise():
    with pytest.raises(ValueError, match="color_bits"):
        T.Pipeline(_config(T.Config, "fsr_fused"), color_bits=12,
                   device="cpu")


def test_cache_key_holds_color_bits():
    """One pipeline, the same frame shape: the 10-bit build is cached
    under its own key, beside the 8-bit one of a pipeline that differs in
    color_bits only."""
    pipe = _pipe("rcas_sharpen")
    frames = _frames(36, 44)
    pipe.process(frames)
    pipe.process(frames)
    (key,) = pipe._cache
    assert 10 in key and len(pipe.kernels) == 1


# ---- the kernel wrappers' 10-bit entry points ---------------------------------

def _prototype(kernel, entry):
    return _build.prototype(entry, (_build.CSRC / f"{kernel}.cu").read_text())


@pytest.mark.parametrize("plan", list(PLANS))
def test_ten_bit_entry_points_share_the_prototype(plan):
    """Each source has a 10-bit launch and occupancy entry point with the
    8-bit one's parameters, types and names."""
    assert _prototype(plan, f"{plan}_launch10") == _prototype(
        plan, f"{plan}_launch")
    assert _prototype(plan, f"{plan}_occupancy10") == _prototype(
        plan, f"{plan}_occupancy")


@pytest.mark.parametrize("plan", list(PLANS))
def test_launch_takes_the_ten_bit_entry(plan, entry_calls):
    """On a CUDA tensor the 10-bit build would call <kernel>_launch10 with
    the frame's rows and pitch in texels and a uint16 output of the
    kernel's shape: driven here through fn.launch with the entry point
    stubbed, on the unpadded frame and on the ring pitch."""
    pipe = _pipe(plan)
    h, w = 45, 61
    fn = pipe._build(2, h, w, (0, 1), False).kernel
    names = [n for _, n in _prototype(plan, f"{plan}_launch10")]
    hp, wp = fn.pad_to
    for x in (torch.zeros((2, h, w, 4), dtype=torch.uint16),
              torch.zeros((2, hp, wp, 4), dtype=torch.uint16)):
        out, err = fn.launch(x)
        ow, oh = pipe.output_size(w, h)
        assert err == 0 and out.dtype == torch.uint16
        assert out.shape == (2, oh, ow, 4)
        args = entry_calls[-1][2]
        assert args[0] == x.data_ptr() and args[1] == out.data_ptr()
        assert (x.shape[1], x.shape[2]) == (args[names.index("pitch") - 1],
                                            args[names.index("pitch")])
    assert [c[:2] for c in entry_calls] == [(plan, f"{plan}_launch10")] * 2
    assert fn.launches == 0


@pytest.mark.parametrize("plan", list(PLANS))
def test_kernel_fn_checks_the_ten_bit_frame(plan):
    fn = _pipe(plan)._build(2, 36, 44, (0, 1), False).kernel
    with pytest.raises(TypeError, match="uint16"):
        fn(torch.zeros((2, 36, 44), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        fn(torch.zeros((2, 36, 44, 3), dtype=torch.uint16))
    with pytest.raises(ValueError, match="shape"):
        fn(torch.zeros((2, 36, 45, 4), dtype=torch.uint16))
    frames = torch.from_numpy(_frames(36, 44))
    hp, wp = fn.pad_to
    ring = torch.full((2, hp, wp, 4), 1023, dtype=torch.uint16)
    ring[:, :36, :44] = frames
    assert torch.equal(fn(ring), fn(frames))


# ---- the DMA floor's 10-bit geometry ------------------------------------------

def _geometries(plan, h, w, radius):
    """The 8-bit and 10-bit builds' geometries of one plan."""
    cfg = _config(T.Config, plan, radius)
    g8 = T.Pipeline(cfg, device="cpu")._build(2, h, w, (0, 1), True)
    g10 = T.Pipeline(cfg, color_bits=10, device="cpu")._build(
        2, h, w, (0, 1), False)
    return g8.dma_geometry, g10.dma_geometry


FLOOR_CASES = [(p, h, w, r) for p in PLANS for h, w in ((72, 96), (45, 61))
               for r in (0.5, 2.0, 0.0)]


@pytest.mark.parametrize("plan,h,w,radius", FLOOR_CASES)
def test_floor_moves_each_texels_two_words(plan, h, w, radius):
    """The 10-bit geometry is the 8-bit one in 4-byte words: every output
    texel of its floor is the whole 8-byte texel the 8-bit floor moves to
    that output (found from an index plane), on the unpadded frame and the
    ring pitch; its byte counts are the 10-bit kernel's."""
    g8, g10 = _geometries(plan, h, w, radius)
    assert g10["texel_words"] == 2 and g10["tile"][0] == 64
    assert (g10["in_w"], g10["out_w"], g10["wp"]) == (
        2 * g8["in_w"], 2 * g8["out_w"], 2 * g8["wp"])
    f8, f10 = sol.build_dma_floor(g8), sol.build_dma_floor(g10)
    index = torch.arange(2 * h * w, dtype=torch.int32).reshape(2, h, w)
    src = f8.reference(index).numpy()                 # source texel ids
    frames = _frames(h, w, seed=5)
    want = frames.reshape(-1, 4)[src]
    got = f10(torch.from_numpy(frames))
    assert got.dtype == torch.uint16 and np.array_equal(got.numpy(), want)
    hp, wp = f10.pad_to
    ring = np.full((2, hp, wp, 4), 777, np.uint16)
    ring[:, :h, :w] = frames
    assert np.array_equal(f10(torch.from_numpy(ring)).numpy(), want)
    assert f10.write_bytes == 2 * f8.write_bytes == 2 * g8["out_h"] * \
        g8["out_w"] * 8
    assert f10.hbm_bytes == 2 * f8.hbm_bytes
    assert f10.read_bytes == 4 * sol.floor_loads(g10) and f10.launches == 0


@pytest.mark.parametrize("plan,h,w,radius", FLOOR_CASES)
def test_floor_boxes_hold_every_tap_word(plan, h, w, radius):
    """Each tile's box (the staging window's, or what the outside pass
    reads) holds every word its outputs store or, in a tile of stage
    "list" that does not stage, the words of all four edge-clamped
    bilinear taps; box columns start and end on 16-byte boundaries."""
    _, g = _geometries(plan, h, w, radius)
    boxes = sol.floor_boxes(g)
    tw = g["tile"][0]
    (bw0, _), (bw1, _) = boxes.box
    assert bw0 % 4 == bw1 % 4 == 0 and (boxes.x0 % 4 == 0).all()
    n_in = g["in_w"]
    for tx in range(len(g["tile_x0"])):
        cols = np.arange(tx * tw, min(tx * tw + tw, g["out_w"]))
        staged = g["tap_x"][cols]
        if g["stage"] == "list":
            q = g["quad_x"][1][cols]
            other = np.concatenate([sol.clip_words(q, n_in, 2),
                                    sol.clip_words(q, n_in, 2, 1)])
        else:
            other = cols
        for c, taps, bw in ((1, staged, bw1), (0, other, bw0)):
            x0 = boxes.x0[c][tx]
            assert taps.min() >= x0 and taps.max() < x0 + bw
    # word k of a texel is its word k: the clamps stay in texel space
    assert sol.clip_words([-2, -1, 0, 1, 2 * 7, 2 * 7 + 1], 14, 2).tolist() \
        == [0, 1, 0, 1, 12, 13]
    assert sol.clip_words([-2, -1, 12, 13], 14, 2, 1).tolist() == \
        [0, 1, 12, 13]


@pytest.mark.parametrize("plan", ["rcas_sharpen", "nis_sharpen",
                                  "cas_sharpen"])
def test_floor_spans_cover_the_same_tiles(plan):
    """The copy form's span items: the same outside tiles at both formats,
    up to FLOOR_SPAN tiles of one tile row each (128 words of each row at
    8 bits, 256 at 10)."""
    for radius in (0.0, 0.5):
        g8, g10 = _geometries(plan, 72, 320, radius)
        t8, t10 = sol.floor_tiles(g8), sol.floor_tiles(g10)
        assert np.array_equal(t8, t10)
        assert -t10[:, 3].min() == sol.FLOOR_SPAN
        assert g10["tile"][0] == 2 * g8["tile"][0] == 64


@pytest.mark.parametrize("plan", ["fsr_fused", "rcas_sharpen"])
def test_floor_launch_runs_words(plan, entry_calls):
    """On a CUDA tensor the 10-bit floor would hand dma_floor_launch the
    frame as words: the word pitch, 64-word tiles, and it refuses a pitch
    TMA cannot take (the 61-texel rows: 122 words) before any launch."""
    _, g = _geometries(plan, 45, 61, 0.5)
    floor = sol.build_dma_floor(g)
    with pytest.raises(ValueError, match="pitch"):
        floor.launch(torch.zeros((2, 45, 61, 4), dtype=torch.uint16))
    assert not entry_calls
    hp, wp = floor.pad_to
    out, err = floor.launch(torch.zeros((2, hp, wp, 4), dtype=torch.uint16))
    assert err == 0 and out.dtype == torch.uint16
    assert out.shape == (2, g["out_h"], g["out_w"] // 2, 4)
    ((library, entry, args),) = entry_calls
    assert (library, entry) == ("dma_floor", "dma_floor_launch")
    assert len(args) == len(_prototype("dma_floor", entry))
    assert args[9:16] == (2, 45, 122, hp, 2 * wp, g["out_h"], g["out_w"])
    assert args[16] == 64


# ---- capture ------------------------------------------------------------------

def test_ten_bit_capture_equals_the_jax_pipeline(tmp_path):
    """arm_capture on a 10-bit pipeline writes an R10G10B10A2 DDS of the
    eye-0 output, byte-equal to the JAX capture module's file of the same
    texels, under the JAX pipeline's name (less the time stamp)."""
    from openvr_fsr_tpu.api import capture as JCAP
    from openvr_fsr_tpu_torch.api.capture import read_dds
    frames = _frames(36, 40, seed=11)
    cfg = dict(enabled=True, render_scale=0.75, sharpness=0.9, radius=2.0)
    tp = T.Pipeline(T.Config(**cfg), color_bits=10, device="cpu")
    jp = J.Pipeline(J.Config(**cfg), color_bits=10, backend="xla")
    tp.arm_capture(tmp_path / "t")
    jp.arm_capture(tmp_path / "j")
    tp.process(frames[1:], eyes=(1,))
    assert not tp.last_capture_paths
    out = tp.process(frames)
    jp.process(frames)
    (got,) = tp.last_capture_paths
    (want,) = jp.last_capture_paths
    assert got.name.split("_", 3)[3] == want.name.split("_", 3)[3]
    img, bits = read_dds(got)
    assert bits == 10 and np.array_equal(img, out[0].numpy())
    JCAP._write_dds_py(tmp_path / "same.dds",
                       JCAP.pack_r10g10b10a2(out[0].numpy()).tobytes(),
                       out.shape[2], out.shape[1], 10)
    assert got.read_bytes() == (tmp_path / "same.dds").read_bytes()
    assert got.read_bytes()[:128] == want.read_bytes()[:128]


def test_occupancy_names_the_ten_bit_entry(monkeypatch):
    """occupancy(name, 10) asks <name>_occupancy10."""
    names = []

    class Lib:
        def __getattr__(self, name):
            names.append(name)

            def f(*args):
                for a in args:
                    a._obj.value = 2
                return 0
            return f
    monkeypatch.setattr(_build, "load_library", lambda name: Lib())
    got = _common.occupancy("fsr_fused", 10)
    assert names == ["fsr_fused_occupancy10"]
    assert got == {"outside": 2, "inside": 2, "inside_smem": 2}
