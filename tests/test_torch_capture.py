"""Capture in the port (openvr_fsr_tpu_torch/api/capture.py and
Pipeline.arm_capture) on the CPU: the DDS files byte-equal to the JAX
module's pure-Python writer for RGBA8 and R10G10B10A2, the R10 pack and
unpack, the reference filename scheme, save_frame on uint8, packed uint32
and packed int32 frames (numpy arrays and torch tensors), and the deferred
left-eye trigger. chip_smoke.py runs the trigger on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu.api import capture as JCAP  # noqa: E402
from openvr_fsr_tpu.utils import frames as JFR  # noqa: E402

import openvr_fsr_tpu_torch as T  # noqa: E402
from openvr_fsr_tpu_torch.api import capture as TCAP  # noqa: E402

MAIN = dict(enabled=True, render_scale=0.75, sharpness=0.9, radius=2.0)


def _r10(h, w, seed=5):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 1024, (h, w, 4)).astype(np.uint16)
    img[..., 3] = rng.integers(0, 4, (h, w))
    return img


def test_rgba8_file_equals_the_jax_writer(tmp_path):
    img = JFR.noise_frame(12, 20, seed=2)
    TCAP.write_dds_rgba8(tmp_path / "t.dds", img)
    JCAP._write_dds_py(tmp_path / "j.dds", img.tobytes(), 20, 12, 8)
    assert (tmp_path / "t.dds").read_bytes() == \
        (tmp_path / "j.dds").read_bytes()
    assert np.array_equal(TCAP.read_dds_rgba8(tmp_path / "j.dds"), img)


@pytest.mark.parametrize("packed", [False, True])
def test_r10_file_equals_the_jax_writer(tmp_path, packed):
    img = _r10(12, 16)
    arg = JCAP.pack_r10g10b10a2(img) if packed else img
    TCAP.write_dds_r10(tmp_path / "t.dds", arg)
    JCAP._write_dds_py(tmp_path / "j.dds",
                       JCAP.pack_r10g10b10a2(img).tobytes(), 16, 12, 10)
    assert (tmp_path / "t.dds").read_bytes() == \
        (tmp_path / "j.dds").read_bytes()
    got, bits = TCAP.read_dds(tmp_path / "j.dds")
    assert bits == 10 and got.dtype == np.uint16
    assert np.array_equal(got, img)
    with pytest.raises(ValueError, match="10-bit"):
        TCAP.read_dds_rgba8(tmp_path / "t.dds")


def test_r10_pack_round_trip():
    img = _r10(9, 11, seed=3)
    img[0, :4] = [[1023, 0, 1023, 3], [0, 1023, 0, 0], [512, 1, 2, 1],
                  [1023, 1023, 1023, 3]]
    packed = TCAP.pack_r10g10b10a2(img)
    assert packed.dtype == np.uint32
    assert np.array_equal(packed, JCAP.pack_r10g10b10a2(img))
    assert np.array_equal(TCAP.unpack_r10g10b10a2(packed), img)
    assert np.array_equal(JCAP.unpack_r10g10b10a2(packed), img)


def test_read_refuses_other_files(tmp_path):
    (tmp_path / "x.dds").write_bytes(b"PNG " + bytes(200))
    with pytest.raises(ValueError, match="not a DDS"):
        TCAP.read_dds(tmp_path / "x.dds")


@pytest.mark.parametrize("args", [
    (False, 0.9, 0.5), (True, 0.75, 2.0), (False, 0.0, 0.0),
    (True, 1.0, 0.35)])
@pytest.mark.parametrize("ext", ["dds", "npy", "png"])
def test_capture_filename_equals_the_jax_one(args, ext):
    for ts in (0.0, 1.7e9, 1_800_000_123.5):
        assert TCAP.capture_filename(*args, ext=ext, ts=ts) == \
            JCAP.capture_filename(*args, ext=ext, ts=ts)


def _as(kind, img):
    """One (H, W, 4) uint8 frame in each form save_frame takes."""
    words = np.ascontiguousarray(img).view(np.uint32)[..., 0]
    return {
        "uint8 numpy": img,
        "uint8 tensor": torch.from_numpy(img),
        "uint8 batch tensor": torch.from_numpy(img)[None],
        "packed uint32 numpy": words,
        "packed int32 numpy": words.view(np.int32),
        "packed uint32 tensor": torch.from_numpy(words.view(np.int32))
        .view(torch.uint32),
        "packed int32 tensor": torch.from_numpy(words.view(np.int32)),
    }[kind]


@pytest.mark.parametrize("kind", [
    "uint8 numpy", "uint8 tensor", "uint8 batch tensor",
    "packed uint32 numpy", "packed int32 numpy", "packed uint32 tensor",
    "packed int32 tensor"])
def test_save_frame(tmp_path, kind):
    img = JFR.noise_frame(10, 14, seed=4)
    img[..., 3] = np.arange(140, dtype=np.uint8).reshape(10, 14)
    paths = TCAP.save_frame(_as(kind, img), tmp_path, use_nis=True,
                            sharpness=0.75, radius=0.5,
                            formats=("dds", "npy"))
    dds, npy = paths
    assert dds.name.endswith("_nis_s75_r50.dds")
    assert npy.name.endswith("_nis_s75_r50.npy")
    assert np.array_equal(TCAP.read_dds_rgba8(dds), img)
    assert np.array_equal(np.load(npy), img)
    JCAP._write_dds_py(tmp_path / "j.dds", img.tobytes(), 14, 10, 8)
    assert dds.read_bytes() == (tmp_path / "j.dds").read_bytes()


def test_save_frame_ten_bit(tmp_path):
    img = _r10(10, 14)
    (dds,) = TCAP.save_frame(torch.from_numpy(img.astype(np.int32)).to(
        torch.uint16), tmp_path, formats=("dds",))
    got, bits = TCAP.read_dds(dds)
    assert bits == 10 and np.array_equal(got, img)


def test_save_frame_png(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    img = JFR.noise_frame(6, 8)
    (png,) = TCAP.save_frame(img, tmp_path, formats=("png",))
    assert np.array_equal(np.asarray(pil.open(png)), img)


@pytest.mark.parametrize("packed", [False, True])
def test_arm_capture_saves_next_left_eye(tmp_path, packed):
    """tests/test_pipeline.py:200-222 on the port, device="cpu": the
    armed flag saves on the next left-eye frame only, then clears."""
    pipe = T.Pipeline(T.Config(**MAIN), device="cpu")
    fr = JFR.noise_frame(40, 36)
    batch = np.stack([fr, fr])
    if packed:
        fr = fr.view(np.int32)[..., 0]
        batch = batch.view(np.int32)[..., 0]
    pipe.arm_capture(tmp_path)
    # a right-eye-only batch must NOT trigger the capture
    pipe.process(fr[None], eyes=(1,))
    assert pipe._capture_armed is not None and not list(tmp_path.iterdir())
    out = pipe.process(batch, eyes=(1, 0))
    assert pipe._capture_armed is None
    (path,) = pipe.last_capture_paths
    assert path.name.endswith("_fsr_s90_r200.dds")
    want = out[1].numpy()
    if packed:
        assert out.dtype == torch.int32
        want = want.view(np.uint8).reshape(want.shape + (4,))
    assert np.array_equal(TCAP.read_dds_rgba8(path), want)
    # one-shot: the next left-eye frame does not capture again
    pipe.process(fr[None], eyes=(0,))
    assert len(list(tmp_path.iterdir())) == 1


def test_arm_capture_double_wide(tmp_path):
    """Double-wide frames hold the left eye: any frame captures."""
    pipe = T.Pipeline(T.Config(**MAIN), single_eye_per_frame=False,
                      device="cpu")
    fr = np.concatenate([JFR.noise_frame(24, 20), JFR.zone_plate_frame(24, 20)],
                        axis=1)
    pipe.arm_capture(tmp_path / "caps", formats=("dds", "npy"))
    out = pipe.process(fr[None], eyes=(1,))
    dds, npy = pipe.last_capture_paths
    assert pipe._capture_armed is None
    assert np.array_equal(TCAP.read_dds_rgba8(dds), out[0].numpy())
    assert np.array_equal(np.load(npy), out[0].numpy())
