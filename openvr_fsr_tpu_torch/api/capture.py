"""Frame capture — the ScreenGrab11/SaveTextureToFile analog.

The reference captures the final output as a DDS named
`capture_<ts>_<fsr|nis>_s<sharp>_r<radius>.dds`
(PostProcessor.cpp:640-657), in whichever of its two output formats the
pipeline produced (R8G8B8A8 or R10G10B10A2, PostProcessor.cpp:63-74). Same
metadata-in-filename scheme and format pair here; formats: .dds
(uncompressed 32bpp), .npy, and .png when PIL exists (10-bit frames are
tone-dropped to 8-bit for PNG — the DDS/NPY captures keep full precision).

A copy of openvr_fsr_tpu/api/capture.py (the port cannot import that
package: its __init__ imports jax) without its native DDS codec, so the
pure-Python writer and reader here are the only codec;
tests/test_torch_capture.py holds the files byte-equal. save_frame takes
a torch tensor on any device (moved to the host once) or a numpy array,
and reads the port's packed int32 planes as packed RGBA8, as uint32 ones.
"""

import struct
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_frame", "capture_filename", "write_dds_rgba8",
           "write_dds_r10", "read_dds", "read_dds_rgba8", "pack_r10g10b10a2",
           "unpack_r10g10b10a2"]

_DDSD_FLAGS = 0x1 | 0x2 | 0x4 | 0x1000 | 0x8  # CAPS|HEIGHT|WIDTH|PIXELFORMAT|PITCH
_DDPF_RGBA = 0x41
_MASKS = {8: (0x000000FF, 0x0000FF00, 0x00FF0000, 0xFF000000),
          10: (0x000003FF, 0x000FFC00, 0x3FF00000, 0xC0000000)}


def capture_filename(use_nis, sharpness, radius, ext="dds", ts=None):
    """capture_<ts>_<fsr|nis>_s<sharp*100>_r<radius*100>.<ext>
    (PostProcessor.cpp:645-651)."""
    stamp = time.strftime("%Y%m%d_%H%M%S", time.localtime(ts))
    return (f"capture_{stamp}_{'nis' if use_nis else 'fsr'}"
            f"_s{int(round(sharpness * 100))}_r{int(round(radius * 100))}.{ext}")


def pack_r10g10b10a2(frame):
    """(H, W, 4) uint16 (RGB in [0,1023], A in [0,3]) -> (H, W) uint32
    packed R10G10B10A2_UNORM texels (the 10-bit pipeline's DXGI layout)."""
    f = np.asarray(frame, np.uint32)
    return (f[..., 0] | (f[..., 1] << 10) | (f[..., 2] << 20)
            | (f[..., 3] << 30)).astype(np.uint32)


def unpack_r10g10b10a2(plane):
    """(H, W) uint32 packed R10G10B10A2 -> (H, W, 4) uint16."""
    p = np.asarray(plane, np.uint32)
    out = np.empty(p.shape + (4,), np.uint16)
    out[..., 0] = p & 0x3FF
    out[..., 1] = (p >> 10) & 0x3FF
    out[..., 2] = (p >> 20) & 0x3FF
    out[..., 3] = p >> 30
    return out


def _write_dds_py(path, payload, w, h, color_bits):
    """128-byte legacy header + raw 32bpp texels."""
    buf = bytearray(128)
    struct.pack_into("<4s", buf, 0, b"DDS ")
    struct.pack_into("<I", buf, 4, 124)            # dwSize
    struct.pack_into("<I", buf, 8, _DDSD_FLAGS)    # dwFlags
    struct.pack_into("<I", buf, 12, h)             # dwHeight
    struct.pack_into("<I", buf, 16, w)             # dwWidth
    struct.pack_into("<I", buf, 20, w * 4)         # dwPitchOrLinearSize
    struct.pack_into("<I", buf, 76, 32)            # ddspf.dwSize
    struct.pack_into("<I", buf, 80, _DDPF_RGBA)    # ddspf.dwFlags
    struct.pack_into("<I", buf, 88, 32)            # RGBBitCount
    struct.pack_into("<4I", buf, 92, *_MASKS[color_bits])
    struct.pack_into("<I", buf, 108, 0x1000)       # dwCaps
    with open(path, "wb") as f:
        f.write(bytes(buf))
        f.write(payload)


def write_dds_rgba8(path, rgba):
    """Uncompressed 32-bit RGBA8 DDS writer (DirectXTK-compatible)."""
    rgba = np.ascontiguousarray(np.asarray(rgba, np.uint8))
    _write_dds_py(path, rgba.tobytes(), rgba.shape[1], rgba.shape[0], 8)


def write_dds_r10(path, frame):
    """R10G10B10A2 DDS writer; frame is (H, W, 4) uint16 or a pre-packed
    (H, W) uint32 plane."""
    packed = frame if frame.ndim == 2 else pack_r10g10b10a2(frame)
    packed = np.ascontiguousarray(np.asarray(packed, np.uint32))
    _write_dds_py(path, packed.tobytes(), packed.shape[1], packed.shape[0], 10)


def read_dds(path):
    """Read a DDS written by this module: returns ((H, W, 4) array, bits) —
    uint8 for RGBA8 files, uint16 for R10G10B10A2."""
    data = Path(path).read_bytes()
    if data[:4] != b"DDS ":
        raise ValueError(f"{path} is not a DDS file")
    h = struct.unpack_from("<I", data, 12)[0]
    w = struct.unpack_from("<I", data, 16)[0]
    masks = struct.unpack_from("<4I", data, 92)
    bits = 10 if masks == _MASKS[10] else 8
    raw = np.frombuffer(data[128:128 + h * w * 4], np.uint8).reshape(h, w, 4)
    if bits == 10:
        return unpack_r10g10b10a2(
            np.ascontiguousarray(raw).view(np.uint32)[..., 0]), 10
    return raw, 8


def read_dds_rgba8(path):
    frame, bits = read_dds(path)
    if bits != 8:
        raise ValueError(f"{path} is a {bits}-bit capture; use read_dds()")
    return frame


def _host_array(frame):
    """A tensor (any device, moved to the host once) or array as numpy;
    packed planes cross as int32, which numpy takes from every torch
    version, and come back as uint32."""
    if isinstance(frame, torch.Tensor):
        if frame.dtype in (torch.uint32, torch.int32):
            return frame.view(torch.int32).cpu().numpy().view(np.uint32)
        return frame.cpu().numpy()
    return np.asarray(frame)


def save_frame(frame, directory=".", use_nis=False, sharpness=0.9, radius=0.5,
               formats=("dds", "npy")):
    """Save a processed frame with reference-style metadata filenames.

    Accepts (H, W, 4) uint8, (H, W, 4) uint16 (the color_bits=10 pipeline
    output: RGB in [0,1023], alpha in [0,3] — captured as R10G10B10A2), or
    an (H, W) uint32 or int32 packed-RGBA8 plane from the zero-copy
    pipeline mode, as a numpy array or a torch tensor on any device.
    Returns the list of written paths."""
    frame = _host_array(frame)
    if frame.dtype in (np.uint32, np.int32):    # packed API mode output
        frame = frame.view(np.uint8).reshape(frame.shape + (4,))
    if frame.ndim == 4:
        frame = frame[0]
    ten_bit = frame.dtype == np.uint16
    paths = []
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for ext in formats:
        p = directory / capture_filename(use_nis, sharpness, radius, ext)
        if ext == "dds":
            (write_dds_r10 if ten_bit else write_dds_rgba8)(p, frame)
        elif ext == "npy":
            np.save(p, frame)
        elif ext == "png":
            try:
                from PIL import Image
                view = ((frame >> 2).astype(np.uint8) if ten_bit else frame)
                if ten_bit:   # 2-bit alpha -> 8-bit (0..3 -> 0..255)
                    view[..., 3] = (frame[..., 3] * 85).astype(np.uint8)
                Image.fromarray(view, "RGBA").save(p)
            except ImportError:
                continue
        paths.append(p)
    return paths
