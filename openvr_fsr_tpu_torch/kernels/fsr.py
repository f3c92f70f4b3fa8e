"""The fused FSR (EASU + RCAS) kernel: build, launch, and its plain version.

`build_fsr_fused` is the port of the JAX package's kernels/fsr.py::
build_fsr_fused for the 8-bit packed path. Per output pixel of each batch
entry it computes what the reference does in two dispatches and an
intermediate texture (src/postprocess/PostProcessor.cpp:385-401, 483-496):

  1. EASU (ffx_fsr1.h:315-437) inside the foveation circle, the bilinear
     fallback (fsr_easu.hlsl:33-36) outside, alpha 1;
  2. the UNORM8 round trip of the intermediate (PostProcessor.cpp:527);
  3. RCAS (ffx_fsr1.h:684-769) with zero out-of-image taps inside the
     circle, the quantized value times the debug tint outside;
  4. the packed RGBA8 store with alpha 255.

The returned function launches the CUDA kernels (csrc/fsr_fused.cu: the
bilinear pass over the 32x32 tiles outside the foveation circle and the
EASU + RCAS kernel over those inside, both from one C entry point) for a
CUDA tensor and runs `fsr_fused_reference`, the same computation in plain
torch, for a CPU tensor. Nothing falls back: a CUDA tensor runs the kernels
or raises.
"""

import ctypes
import functools

import numpy as np
import torch

from ..core import constants as C
from ..core.foveation import TILE_FSR
from ..ops.bilinear import bilinear_gather
from ..ops.easu import easu_core, easu_gather
from ..ops.rcas import rcas
from ..ops.common import unorm_quantize
from . import _build
from ._common import (DeviceTables, circle_mask, debug_tint, kernel_fn,
                      pack, tint_vector, unpack)
from ._maps import (FSR_TILE, IN_TILE, TILE, dma_geometry, fsr_maps,
                    input_padding)

__all__ = ["build_fsr_fused", "fsr_fused_reference", "circle_mask"]


def fsr_fused_reference(img, maps, sharpness_linear, tint):
    """The fused kernel's computation in plain torch, on img's device.

    img: (B, H, W) or pre-padded (B, HP, WP) int32 packed RGBA8; maps: the
    build's FsrMaps on img's device; sharpness_linear: RCAS con.x; tint: the
    out-of-circle G/B multiplier (0.7 in debug mode, else 1). Returns
    (B, OH, OW) int32 packed RGBA8."""
    m = maps
    rgb = unpack(img[:, :m.in_h, :m.in_w], 3)
    taps = easu_gather(rgb, m.col_i[0], m.row_i[0])
    up = easu_core(taps, m.col_f[0][None, :], m.row_f[0][:, None])
    bil = bilinear_gather(rgb, m.col_i[1], m.col_f[1], m.row_i[1],
                          m.row_f[1])
    inside = circle_mask(m.centres, m.out_h, m.out_w, TILE_FSR)[:, None]
    q = unorm_quantize(torch.where(inside, up, bil))
    sharp = rcas(q, sharpness_linear)
    return pack(torch.where(inside, sharp, q * tint_vector(tint, img.device)))


@functools.cache
def _launch_fn():
    """The ctypes entry point, bound (and built) at the first launch."""
    f = _build.load_library("fsr_fused").fsr_fused_launch
    f.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
                  + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def build_fsr_fused(batch, in_h, in_w, out_w, out_h, *, sharpness, centres,
                    debug=False):
    """Build the fused stereo FSR kernel for a fixed shape/config.

    Args:
      batch, in_h, in_w, out_w, out_h: static sizes (out > in: EASU upscales).
      sharpness: the [0,1] config slider (PostProcessor.cpp:420-421 mapping).
      centres: (B, 5) int array per batch entry: cx1, cy1, cx2, cy2,
        radius_sq (core.constants.centres_payload).
      debug: out-of-radius tint 1-(0, .3, .3) (fsr_rcas.hlsl:46).

    Returns fn(img): img is a contiguous (B, in_h, in_w) int32 tensor, or
    one pre-padded to the ring pitch fn.pad_to (rows read in place, no
    copy), holding packed RGBA8 texels (little-endian, R in the low byte);
    the result is a new (B, out_h, out_w) int32 tensor of packed RGBA8 with
    alpha 255 on img's device. fn.launches counts calls that launched the
    CUDA kernels (one per call: the outside pass and the inside kernel,
    each only where its tile list is not empty); fn.reference(img) runs the
    plain version on img's device; fn.dma_geometry is what the kernels load
    and store (kernels/sol.py).
    """
    B, H, W = int(batch), int(in_h), int(in_w)
    OH, OW = int(out_h), int(out_w)
    tables = DeviceTables(fsr_maps(B, H, W, OW, OH, centres))
    sharp = C.fsr_rcas_con(C.rcas_stops_from_slider(sharpness))
    tint = debug_tint(debug)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return fsr_fused_reference(img, tables.on(img.device), sharp, tint)

    def launch(img):
        dev = img.device
        m = tables.on(dev)
        out = torch.empty((B, OH, OW), dtype=torch.int32, device=dev)
        err = _launch_fn()(
            img.data_ptr(), out.data_ptr(), m.col_i.data_ptr(),
            m.col_f.data_ptr(), m.row_i.data_ptr(), m.row_f.data_ptr(),
            m.tile_x0.data_ptr(), m.tile_y0.data_ptr(),
            m.group_cls.data_ptr(), m.inside_tiles.data_ptr(), n_inside,
            m.outside_tiles.data_ptr(), n_outside, B, H, W, img.shape[1],
            img.shape[2], OH, OW, float(sharp), float(tint), FSR_TILE,
            IN_TILE, torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    # the inside tiles stage their 40x40 window edge-clamped; an output's
    # own tap there is its clamped EASU floor. The outside tiles load each
    # output's four bilinear taps (fsr_outside_kernel).
    m = tables.host
    n_inside, n_outside = len(m.inside_tiles), len(m.outside_tiles)
    geometry = dma_geometry(
        OH, OW, (FSR_TILE, FSR_TILE), (IN_TILE, IN_TILE), m.tile_x0,
        m.tile_y0, m.centres, oob="clamp", stage="list",
        staged=m.tile_inside, stage_quads=False, group=(TILE, TILE),
        tap_x=np.clip(m.col_i[0], 0, W - 1),
        tap_y=np.clip(m.row_i[0], 0, H - 1),
        quad_x=m.col_i[[1, 1]], quad_y=m.row_i[[1, 1]])
    return kernel_fn("fused FSR", B, (H, W), input_padding(H, W), reference,
                     launch, geometry)
