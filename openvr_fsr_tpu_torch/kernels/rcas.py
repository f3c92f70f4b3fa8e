"""The RCAS sharpen-only kernel (renderScale 1): build, launch, and its plain
version.

`build_rcas_sharpen` is the port of the JAX package's kernels/rcas.py::
build_rcas_sharpen for the 8-bit packed path. The reference runs only the
sharpen dispatch when renderScale is 1 (PostProcessor.cpp:530-535,
591-594): RCAS (ffx_fsr1.h:684-769) over the game's frame with zero
out-of-image taps (fsr_rcas.hlsl:18) inside the foveation circle, alpha 1
there; outside, the source colour times the debug tint with the source's
own alpha (fsr_rcas.hlsl:23-55; kernels/rcas.py:112-115).

The returned function launches the CUDA kernels (csrc/rcas_sharpen.cu: the
copy pass over the 32x32 tiles outside the circle and an RCAS kernel over
those inside, from one C entry point and the host's tile lists,
kernels/_maps.py::sharpen_maps) for a CUDA tensor and runs
`rcas_sharpen_reference`, the same computation in plain torch, for a CPU
tensor. Nothing falls back.
"""

import ctypes
import functools

import torch

from ..core import constants as C
from ..core.foveation import TILE_FSR
from ..ops.rcas import rcas
from . import _build
from ._common import (DeviceTables, circle_mask, debug_tint, kernel_fn, pack,
                      tint_vector, unpack)
from ._maps import (CAS_SHARPEN_IN_TILE, SHARPEN_TILE, TILE, input_padding,
                    sharpen_geometry, sharpen_maps)

__all__ = ["build_rcas_sharpen", "rcas_sharpen_reference"]


def rcas_sharpen_reference(img, centres, sharpness_linear, tint):
    """The kernel's computation in plain torch, on img's device.

    img: (B, H, W) int32 packed RGBA8 (H, W: the frame; a pre-padded plane
    is cropped by the caller); centres: (B, 5) int64 on img's device;
    sharpness_linear: RCAS con.x; tint: the out-of-circle G/B multiplier.
    Returns (B, H, W) int32 packed RGBA8."""
    rgba = unpack(img)
    rgb, alpha = rgba[:, :3], rgba[:, 3]
    inside = circle_mask(centres, img.shape[1], img.shape[2], TILE_FSR)
    sharp = rcas(rgb, sharpness_linear)
    out_rgb = torch.where(inside[:, None], sharp,
                          rgb * tint_vector(tint, img.device))
    return pack(out_rgb, torch.where(inside, 1.0, alpha))


# csrc/rcas_sharpen.cu rcas_sharpen_launch: img, out, group_cls, the inside
# list and its length, the outside list and its length, batch, h, w, rows,
# pitch, sharp, tint, tile, window, stream
SHARPEN_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                    + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@functools.cache
def _launch_fn():
    """The ctypes entry point, bound (and built) at the first launch."""
    f = _build.load_library("rcas_sharpen").rcas_sharpen_launch
    f.argtypes = SHARPEN_ARGTYPES
    f.restype = ctypes.c_int
    return f


def build_rcas_sharpen(batch, h, w, *, sharpness, centres, debug=False):
    """Build the sharpen-only RCAS kernel for a fixed shape/config.

    Args:
      batch, h, w: static sizes (output = input size).
      sharpness: the [0,1] config slider (PostProcessor.cpp:420-421 mapping).
      centres: (B, 5) int array per batch entry: cx1, cy1, cx2, cy2,
        radius_sq (core.constants.centres_payload at the frame size).
      debug: out-of-radius tint 1-(0, .3, .3) (fsr_rcas.hlsl:46).

    Returns fn(img): img is a contiguous (B, h, w) int32 tensor, or one
    pre-padded to the ring pitch fn.pad_to, of packed RGBA8 texels; the
    result is a new (B, h, w) int32 tensor of packed RGBA8 on img's device.
    fn.launches counts calls that launched the CUDA kernels (one per call:
    the copy pass and the inside kernel, each only where its tile list is
    not empty); fn.reference(img) runs the plain version on img's device;
    fn.dma_geometry is what the kernels load and store (kernels/sol.py).
    """
    B, H, W = int(batch), int(h), int(w)
    tables = DeviceTables(sharpen_maps(B, H, W, centres, (TILE, TILE)))
    sharp = C.fsr_rcas_con(C.rcas_stops_from_slider(sharpness))
    tint = debug_tint(debug)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return rcas_sharpen_reference(img[:, :H, :W],
                                      tables.on(img.device).centres, sharp,
                                      tint)

    def launch(img):
        dev = img.device
        m = tables.on(dev)
        out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        err = _launch_fn()(
            img.data_ptr(), out.data_ptr(), m.group_cls.data_ptr(),
            m.inside_tiles.data_ptr(), n_inside, m.outside_tiles.data_ptr(),
            n_outside, B, H, W, img.shape[1], img.shape[2], float(sharp),
            float(tint), SHARPEN_TILE, CAS_SHARPEN_IN_TILE,
            torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    # an inside tile stages its 34x34 window, 0 outside the image; the
    # outside tiles copy their texels (so does a run of an outside group in
    # an inside tile, from device memory: not counted, the floor stays below)
    m = tables.host
    n_inside, n_outside = len(m.inside_tiles), len(m.outside_tiles)
    return kernel_fn("RCAS sharpen", B, (H, W), input_padding(H, W),
                     reference, launch,
                     sharpen_geometry(H, W, SHARPEN_TILE, 1, m.centres,
                                      "zero", staged=m.tile_inside,
                                      group=(TILE, TILE)))
