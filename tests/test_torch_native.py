"""The port's native runtime library (openvr_fsr_tpu_torch/csrc/
ovrfsr_native.cc through openvr_fsr_tpu_torch/native_rt.py) against the
JAX package's (native/src/ovrfsr_native.cc through openvr_fsr_tpu/
native_rt.py) and the port's pure-Python config scanner and DDS codec:
the build, the frame ring (the same sequence through both, outputs and
stats equal; threaded order), the cfg scanner and the DDS writer, reader
and query."""

import shutil
import struct
import sys
import threading

import numpy as np
import pytest

from openvr_fsr_tpu import native_rt as JN
from openvr_fsr_tpu_torch import native_rt as TN
from openvr_fsr_tpu_torch.api import capture as TCAP
from openvr_fsr_tpu_torch.core import config as TCFG
from openvr_fsr_tpu_torch.utils import frames as FR
from test_torch_config import CORPUS

# tests/test_native.py's malformed texts: the scanner passes both tokens on
# as strings, which the config converter then rejects
MALFORMED = {"bare_scalar": '{"fsr": {"renderScale": abc}}',
             "null_scalar": '{"fsr": {"sharpness": null}}'}


@pytest.fixture
def jax_native():
    if not JN.available():
        pytest.skip("the JAX package's native library is not built")
    return JN


def test_builds_with_gxx_into_the_build_dir():
    so = TN.build()
    assert so == TN.library_path() and so.exists()
    assert so.parent == TN.BUILD_DIR and so.parent.name == "_build"
    assert TN.lib().ovrfsr_abi_version() == 2


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(TN, "SOURCE", bad)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited") as e:
        TN.lib()
    assert "error" in str(e.value)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TN.build()


def _ring_script(mod):
    """One sequence of ring calls; returns everything they return."""
    log = []
    ring = mod.FrameRing(64, nslots=3)
    for i in range(3):
        log.append(ring.push(np.full(64, i, np.uint8)))
    log.append(ring.push(np.zeros(64, np.uint8), blocking=False))  # full
    log.append(ring.stats())
    log.append(ring.pop((64,)).tolist())
    log.append(ring.push(np.arange(48, dtype=np.uint8)))
    log.append(ring.pop((64,), blocking=False).tolist())
    log.append(ring.pop((64,)).tolist())
    try:                                   # a 48-byte frame, a 16-byte buffer
        ring.pop((16,))
    except ValueError as e:
        log.append(("ValueError", str(e)))
    log.append(ring.stats())
    out = np.zeros(64, np.uint8)
    log.append(ring.pop((64,), out=out) is out)
    log.append(out.tolist())
    log.append(ring.pop((64,), blocking=False))            # empty: None
    try:
        ring.push(np.zeros(65, np.uint8))                  # beyond a slot
    except RuntimeError as e:
        log.append(("RuntimeError", str(e)))
    # close while a pop is blocked on the empty ring: the pop returns None
    got = []
    t = threading.Thread(target=lambda: got.append(ring.pop((64,))))
    t.start()
    t.join(timeout=0.2)
    log.append(t.is_alive())
    ring.close()
    t.join(timeout=10)
    log.append((t.is_alive(), got))
    # close while a push is blocked on a full ring: the push raises
    ring = mod.FrameRing(8, nslots=1)
    log.append(ring.push(np.ones(8, np.uint8)))
    errs = []

    def push():
        try:
            ring.push(np.ones(8, np.uint8))
        except RuntimeError as e:
            errs.append(str(e))

    t = threading.Thread(target=push)
    t.start()
    t.join(timeout=0.2)
    log.append(t.is_alive())
    ring.close()
    t.join(timeout=10)
    log.append((t.is_alive(), errs, ring.stats()))
    log.append(ring.pop((8,)).tolist())          # queued before the close
    log.append(ring.pop((8,)))                   # closed and drained
    return log


def test_frame_ring_matches_the_jax_ring(jax_native):
    got = _ring_script(TN)
    assert got == _ring_script(jax_native)
    assert got[4] == {"pushed": 3, "popped": 0, "dropped": 1, "depth": 3}


def test_frame_ring_threaded_order():
    ring = TN.FrameRing(1024, nslots=4)
    n = 300
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def producer():
            for i in range(n):
                ring.push(np.full(256, i, np.int32))

        def consumer():
            for _ in range(n):
                got.append(int(ring.pop((256,), np.int32)[0]))

        threads = [threading.Thread(target=producer),
                   threading.Thread(target=consumer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert got == list(range(n))
    assert ring.stats() == {"pushed": n, "popped": n, "dropped": 0,
                            "depth": 0}
    ring.close()


def _native_scan(mod, text):
    try:
        return mod.parse_cfg_native(text)
    except ValueError:                     # the scanner returned -1
        return None


@pytest.mark.parametrize("name", list(CORPUS) + list(MALFORMED))
def test_parse_cfg_native_matches_the_scanner_and_jax(name, jax_native):
    text = CORPUS[name][0] if name in CORPUS else MALFORMED[name]
    got = _native_scan(TN, text)
    assert got == TCFG.scan_cfg(text)
    assert got == _native_scan(jax_native, text)


def test_parse_cfg_native_flat_output():
    d = TN.parse_cfg_native(CORPUS["shipped_cfg"][0])
    assert d["enabled"] == "true" and d["renderScale"] == "0.77"
    assert d["hotkeys.toggleUseNIS"] == "112"
    assert TN.parse_cfg_native(MALFORMED["bare_scalar"])["renderScale"] \
        == "abc"                           # the converter rejects it
    with pytest.raises(ValueError):
        TN.parse_cfg_native(CORPUS["scanner_fails"][0])


def _ten_bit(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 4), np.uint16)
    img[..., :3] = rng.integers(0, 1024, (h, w, 3))
    img[..., 3] = rng.integers(0, 4, (h, w))
    return img


@pytest.mark.parametrize("bits", [8, 10])
def test_dds_writer_byte_equal(bits, tmp_path, jax_native):
    if bits == 8:
        img = FR.noise_frame(20, 24)
        payload = img
        TCAP.write_dds_rgba8(tmp_path / "py.dds", img)
    else:
        img = _ten_bit(10, 14, 2)
        payload = TCAP.pack_r10g10b10a2(img)
        TCAP.write_dds_r10(tmp_path / "py.dds", img)
    assert TN.dds_write_native(tmp_path / "port.dds", payload, bits)
    assert jax_native.dds_write_native(tmp_path / "jax.dds", payload, bits)
    data = (tmp_path / "port.dds").read_bytes()
    assert data == (tmp_path / "py.dds").read_bytes()
    assert data == (tmp_path / "jax.dds").read_bytes()
    raw, got_bits = TN.dds_read_native(tmp_path / "port.dds")
    assert got_bits == bits
    if bits == 8:
        assert np.array_equal(raw, img)
    else:
        assert np.array_equal(TCAP.unpack_r10g10b10a2(
            np.ascontiguousarray(raw).view(np.uint32)[..., 0]), img)
    frame, py_bits = TCAP.read_dds(tmp_path / "port.dds")
    assert py_bits == bits and np.array_equal(frame, img)


def _header(width, height, pf_flags, fourcc, bits, masks):
    hdr = bytearray(128)
    struct.pack_into("<IIIII", hdr, 0, 0x20534444, 124, 0x100F, height,
                     width)
    struct.pack_into("<IIII", hdr, 76, 32, pf_flags, fourcc, bits)
    struct.pack_into("<IIII", hdr, 92, *masks)
    return bytes(hdr)


RGBA8 = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)
REJECTED = {   # tests/test_native.py:134-156, and two more the query refuses
    "fourcc_dxt1": _header(8, 8, 0x4, 0x31545844, 32, (0, 0, 0, 0))
    + b"\x00" * 256,
    "absurd_dimensions": _header(0x40000000, 0x40000000, 0x41, 0, 32, RGBA8),
    "24bpp": _header(8, 8, 0x41, 0, 24, RGBA8) + b"\x00" * 256,
    "other_masks": _header(8, 8, 0x41, 0, 32, (0xF, 0xF0, 0xF00, 0xF000))
    + b"\x00" * 256,
    "not_dds": b"PNG\x00" * 40,
}


@pytest.mark.parametrize("name", list(REJECTED))
def test_dds_query_rejections(name, tmp_path, jax_native):
    p = tmp_path / f"{name}.dds"
    p.write_bytes(REJECTED[name])
    with pytest.raises(IOError):
        TN.dds_read_native(p)
    with pytest.raises(IOError):
        jax_native.dds_read_native(p)


def test_the_nvcc_build_leaves_the_host_source_out(tmp_path, monkeypatch):
    """kernels/_build.py compiles only csrc/*.cu: the native source is no
    kernel and no input of a kernel library's hash."""
    from openvr_fsr_tpu_torch.kernels import _build
    assert TN.SOURCE.parent == _build.CSRC
    assert "ovrfsr_native" not in _build.kernel_names()
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path("fsr_fused").name
    (csrc / "ovrfsr_native.cc").write_text("// changed\n")
    assert _build.library_path("fsr_fused").name == before
