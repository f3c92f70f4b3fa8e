"""ctypes bindings for the port's native runtime library
(csrc/ovrfsr_native.cc), the counterpart of openvr_fsr_tpu/native_rt.py.

The C++ side is the reference's native non-compute subsystems: the analogs
of its vendored jsoncpp (config parsing), DirectXTK ScreenGrab (DDS IO) and
the PostProcessor staging-resource pools (the frame ring that
tools/stream_bench.py feeds the card through). The source is a copy of the
JAX package's native/src/ovrfsr_native.cc (ABI 2), built at first use with
g++ as native/build.sh builds it, into the package's _build/ directory
(listed in .gitignore) under a name keyed by a hash of the source and the
flags. A file lock makes concurrent processes build it once, and the build
writes a temporary file that it renames into place.

Unlike the JAX loader, `lib()` never returns None: a missing g++, a failed
build or a library of another ABI raises RuntimeError (with the compiler's
output). The pure-Python config scanner (core/config.py::scan_cfg) and DDS
codec (api/capture.py) stay the port's path for those two;
tests/test_torch_native.py holds them equal to this library.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["lib", "library_path", "parse_cfg_native", "dds_write_native",
           "dds_read_native", "FrameRing", "CXX_FLAGS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ovrfsr_native.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# native/build.sh's command, less its -o and source
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-Wall")
CXX_LIBS = ("-lpthread",)
CXX_TIMEOUT_S = 120

# must match OVRFSR_ABI_VERSION in csrc/ovrfsr_native.cc; the ctypes
# signatures below describe exactly this ABI
_ABI_VERSION = 2

_LIBS = {}     # the load cache: library path -> loaded ctypes library


def library_path():
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + CXX_LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libovrfsr_native_{h.hexdigest()[:16]}.so"


def _cxx():
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native runtime "
                           "library (csrc/ovrfsr_native.cc) cannot be built")
    return cxx


def build():
    """Build the library if it does not exist yet, under a file lock, into
    a temporary file renamed into place. Returns its path; raises
    RuntimeError with the compiler's output when g++ fails."""
    so = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *CXX_LIBS]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=CXX_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"{' '.join(cmd)}: g++ killed after "
                               f"{CXX_TIMEOUT_S} s") from e
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)}: g++ exited {r.returncode}"
                               f":\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    return so


def lib():
    """The loaded native library, built first if needed. Raises
    RuntimeError on a failed build or a library of another ABI."""
    so = library_path()
    L = _LIBS.get(so)
    if L is not None:
        return L
    L = ctypes.CDLL(str(build()))
    try:
        version = L.ovrfsr_abi_version
    except AttributeError:
        raise RuntimeError(f"{so}: no ovrfsr_abi_version symbol") from None
    version.restype = ctypes.c_int
    if version() != _ABI_VERSION:
        raise RuntimeError(f"{so}: ABI {version()}, the bindings expect "
                           f"{_ABI_VERSION}")
    L.ovrfsr_parse_cfg.restype = ctypes.c_int
    L.ovrfsr_parse_cfg.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int]
    L.ovrfsr_dds_write.restype = ctypes.c_int
    L.ovrfsr_dds_write.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_int]
    L.ovrfsr_dds_query.restype = ctypes.c_long
    L.ovrfsr_dds_query.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    L.ovrfsr_dds_read.restype = ctypes.c_int
    L.ovrfsr_dds_read.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_long]
    L.ovrfsr_ring_create.restype = ctypes.c_void_p
    L.ovrfsr_ring_create.argtypes = [ctypes.c_long, ctypes.c_int]
    L.ovrfsr_ring_destroy.restype = None
    L.ovrfsr_ring_destroy.argtypes = [ctypes.c_void_p]
    L.ovrfsr_ring_push.restype = ctypes.c_int
    L.ovrfsr_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_long, ctypes.c_int]
    L.ovrfsr_ring_pop.restype = ctypes.c_long
    L.ovrfsr_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_long, ctypes.c_int]
    L.ovrfsr_ring_close.restype = None
    L.ovrfsr_ring_close.argtypes = [ctypes.c_void_p]
    L.ovrfsr_ring_stats.restype = None
    L.ovrfsr_ring_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 4
    _LIBS[so] = L
    return L


def parse_cfg_native(text):
    """JSON-with-comments 'fsr' object -> dict of key -> raw string value
    (nested hotkeys as 'hotkeys.<key>'); ValueError where the scanner
    fails (core/config.py::scan_cfg returns None there)."""
    out = ctypes.create_string_buffer(1 << 16)
    n = lib().ovrfsr_parse_cfg(text.encode(), out, len(out))
    if n < 0:
        raise ValueError("native config parse failed")
    d = {}
    for line in out.value.decode().splitlines():
        k, _, v = line.partition("=")
        d[k] = v
    return d


def dds_write_native(path, rgba, color_bits=8):
    """rgba: (H, W, 4) uint8 (color_bits=8) or (H, W) uint32 packed
    R10G10B10A2 (color_bits=10) — the encoder writes raw 32bpp texels.
    Returns True; raises IOError when the file cannot be written."""
    dtype = np.uint32 if color_bits == 10 else np.uint8
    rgba = np.ascontiguousarray(np.asarray(rgba, dtype))
    h, w = rgba.shape[:2]
    rc = lib().ovrfsr_dds_write(str(path).encode(), w, h,
                                rgba.ctypes.data_as(ctypes.c_char_p),
                                color_bits)
    if rc != 0:
        raise IOError(f"native DDS write failed: {path}")
    return True


def dds_read_native(path):
    """Returns ((H, W, 4) uint8 texel bytes, color_bits) — for 10-bit files
    the bytes are packed R10G10B10A2 (view as uint32 to unpack). Raises
    IOError on a file the decoder does not accept."""
    L = lib()
    w, h, bits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    n = L.ovrfsr_dds_query(str(path).encode(), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(bits))
    if n < 0:
        raise IOError(f"not a DDS file: {path}")
    buf = np.empty((h.value, w.value, 4), np.uint8)
    if L.ovrfsr_dds_read(str(path).encode(),
                         buf.ctypes.data_as(ctypes.c_char_p), n) != 0:
        raise IOError(f"native DDS read failed: {path}")
    return buf, bits.value


class FrameRing:
    """Thread-safe fixed-slot staging ring (the reference's lazily-created
    staging texture pool analog). Push frames from a producer thread, pop on
    the consumer that feeds the device. Push and pop each copy a whole slot
    with the ring's mutex held (csrc/ovrfsr_native.cc, the JAX design), so
    the two copies of one slot run one after the other. ctypes releases the
    interpreter lock during each call."""

    def __init__(self, slot_bytes, nslots=6):
        self._L = lib()
        self._ring = self._L.ovrfsr_ring_create(int(slot_bytes), int(nslots))
        self.slot_bytes = int(slot_bytes)
        self.nslots = int(nslots)

    def push(self, arr, blocking=True):
        """Copy arr into the next free slot: True when pushed, False when
        the ring is full and blocking is False (the frame is dropped and
        counted). Raises RuntimeError when the ring is closed or the frame
        exceeds a slot."""
        arr = np.ascontiguousarray(arr)
        rc = self._L.ovrfsr_ring_push(
            self._ring, arr.ctypes.data_as(ctypes.c_char_p),
            arr.nbytes, 1 if blocking else 0)
        if rc < 0:
            raise RuntimeError("ring closed or frame too large")
        return bool(rc)

    def pop(self, shape, dtype=np.uint8, blocking=True, out=None):
        """Pop the oldest frame into `out` (a reused buffer, such as a
        pinned host buffer's numpy view) or a fresh array of shape and
        dtype. Returns it, or None when the ring is empty (not blocking) or
        closed and drained. ValueError when the frame is larger than the
        buffer (it stays queued)."""
        if out is None:
            out = np.empty(shape, dtype)
        n = self._L.ovrfsr_ring_pop(
            self._ring, out.ctypes.data_as(ctypes.c_char_p),
            out.nbytes, 1 if blocking else 0)
        if n == -2:
            raise ValueError(
                f"queued frame larger than pop buffer ({out.nbytes} bytes)")
        if n <= 0:
            return None
        return out

    def stats(self):
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._L.ovrfsr_ring_stats(self._ring, *[ctypes.byref(v) for v in vals])
        return dict(zip(("pushed", "popped", "dropped", "depth"),
                        (v.value for v in vals)))

    def close(self):
        """Wake every blocked push (which then raises) and pop (which
        returns what is queued, then None)."""
        self._L.ovrfsr_ring_close(self._ring)

    def __del__(self):
        ring, self._ring = getattr(self, "_ring", None), None
        if ring:
            self._L.ovrfsr_ring_destroy(ring)
