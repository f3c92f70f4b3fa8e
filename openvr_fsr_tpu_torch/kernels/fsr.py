"""The fused FSR (EASU + RCAS) kernel: build, launch, and its plain version.

`build_fsr_fused` is the port of the JAX package's kernels/fsr.py::
build_fsr_fused, on RGBA8 (color_bits 8, packed u32 planes) and
R10G10B10A2 (color_bits 10, (B, H, W, 4) uint16 frames) texels. Per output
pixel of each batch entry it computes what the reference does in two
dispatches and an intermediate texture (src/postprocess/
PostProcessor.cpp:385-401, 483-496):

  1. EASU (ffx_fsr1.h:315-437) inside the foveation circle, the bilinear
     fallback (fsr_easu.hlsl:33-36) outside, alpha 1;
  2. the UNORM round trip of the intermediate in the frame's format
     (PostProcessor.cpp:527; UNORM10 at 10 bits, JAX fsr.py:752);
  3. RCAS (ffx_fsr1.h:684-769) with zero out-of-image taps inside the
     circle, the quantized value times the debug tint outside;
  4. the UNORM store with alpha 1 (255, or 3 at 10 bits).

The returned function launches the CUDA kernels (csrc/fsr_fused.cu: the
bilinear pass over the 32x32 tiles outside the foveation circle and the
EASU + RCAS kernel over those inside, both from one C entry point) for a
CUDA tensor and runs `fsr_fused_reference`, the same computation in plain
torch, for a CPU tensor. Nothing falls back: a CUDA tensor runs the kernels
or raises. With band_range the build computes a row band of the full
image from an input row strip (the JAX builder's band_range, for
parallel/spatial.py), through the same kernels and plain version.
precision="half" runs EASU and RCAS in bf16 as the JAX kernel's
precision="half" does (ops/easu.py, ops/rcas.py at dt=bf16; the bilinear
fallback, the UNORM round trip and the tint stay f32), through the half
instantiations of the inside kernel (fsr_fused_launch_h, _launch10_h: the
whole output's and a band's), on the whole image or a strip.
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
from ..ops.common import lit, unorm_quantize
from . import _build
from ._common import (DeviceTables, band_fn, circle_mask, debug_tint,
                      entry_args, entry_name, kernel_fn, pack, texel_words,
                      tint_vector, unpack, working_type)
from ._maps import (FSR_TILE, IN_TILE, TILE, band_geometry, band_layout,
                    band_output_rows, band_strip, dma_geometry, fsr_maps,
                    input_padding, launch_work, word_geometry)

__all__ = ["build_fsr_fused", "fsr_fused_reference", "fsr_band_layout",
           "circle_mask", "FUSED_ARGTYPES"]


def fsr_band_layout(out_w, out_h, band_rows=128, chunk=128):
    """(TH, GY): the JAX fused kernel's band height after its VMEM
    auto-shrink for very wide frames, and its band count (the JAX package's
    kernels/fsr.py::fsr_band_layout): what a spatial-sharding caller needs
    to pick `band_range` splits (parallel/spatial.py)."""
    return band_layout(out_w, out_h, band_rows,
                       lambda th, owp: 10 * (th + 2) * owp * 4, chunk)


def fsr_fused_reference(img, maps, sharpness_linear, tint, color_bits=8,
                        band=None, precision="full"):
    """The fused kernel's computation in plain torch, on img's device.

    img: (B, H, W) or pre-padded (B, HP, WP) int32 packed RGBA8, or at
    color_bits 10 the same with a trailing 4 of uint16 R10G10B10A2; maps:
    the build's FsrMaps on img's device; sharpness_linear: RCAS con.x;
    tint: the out-of-circle G/B multiplier (0.7 in debug mode, else 1);
    band: (in_row_base, out_row0, out_row1) of a row-band build, whose img
    is the input strip from the image's row in_row_base (row indices stay
    the full image's, rebased to the strip), default the whole image;
    precision: "full", or "half" for EASU and RCAS in bf16 (ops/easu.py,
    ops/rcas.py at dt=bf16). Returns (B, OH, OW) int32 packed RGBA8, or
    (B, OH, OW, 4) uint16, for the band's OH = out_row1 - out_row0 rows."""
    dt = working_type(precision)
    m = maps
    base, r0, r1 = (0, 0, m.out_h) if band is None else band
    # stage 1 one row beyond the band, where the image has it: RCAS's taps
    q0, q1 = max(r0 - 1, 0), min(r1 + 1, m.out_h)
    ri, rf = m.row_i[:, q0:q1], m.row_f[:, q0:q1]
    rgb = unpack(img[:, :m.in_h - base, :m.in_w], 3, color_bits)
    taps = easu_gather(rgb, m.col_i[0], ri[0], base, m.in_h)
    up = easu_core(taps, m.col_f[0][None, :], rf[0][:, None], dt)
    bil = bilinear_gather(rgb, m.col_i[1], m.col_f[1], ri[1], rf[1], base,
                          m.in_h)
    inside = circle_mask(m.centres, m.out_h, m.out_w,
                         TILE_FSR)[:, None, q0:q1]
    q = unorm_quantize(torch.where(inside, up, bil), color_bits)
    sharp = rcas(q, sharpness_linear, dt)
    out = torch.where(inside, sharp, q * tint_vector(tint, img.device))
    return pack(out[..., r0 - q0:r1 - q0, :], color_bits=color_bits)


# csrc/fsr_fused.cu fsr_fused_launch: img, out, the four sample maps, the
# window origins, group_cls, the inside list and its length, the outside
# list and its length, batch, in_h, in_w, in_row_base, in_rows, pitch,
# out_h, out_w, out_row0, out_row1, sharp, tint, tile, window, stream
FUSED_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
                  + [ctypes.c_int] * 11 + [ctypes.c_float] * 2
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@functools.cache
def _launch_fn(color_bits=8, precision="full"):
    """The ctypes entry point of `color_bits` and `precision`
    (fsr_fused_launch, fsr_fused_launch10, or either with the suffix _h),
    bound (and built) at the first launch."""
    f = getattr(_build.load_library("fsr_fused"),
                entry_name("fsr_fused_launch", color_bits, precision))
    f.argtypes = FUSED_ARGTYPES
    f.restype = ctypes.c_int
    return f


def build_fsr_fused(batch, in_h, in_w, out_w, out_h, *, sharpness, centres,
                    debug=False, color_bits=8, band_rows=128,
                    band_range=None, precision="full"):
    """Build the fused stereo FSR kernel for a fixed shape/config.

    Args:
      batch, in_h, in_w, out_w, out_h: static sizes (out > in: EASU upscales).
      sharpness: the [0,1] config slider (PostProcessor.cpp:420-421 mapping).
      centres: (B, 5) int array per batch entry: cx1, cy1, cx2, cy2,
        radius_sq (core.constants.centres_payload).
      debug: out-of-radius tint 1-(0, .3, .3) (fsr_rcas.hlsl:46).
      color_bits: 8 (RGBA8) or 10 (R10G10B10A2 passthrough).
      band_rows: the JAX kernel's output rows per band (a multiple of 8, or
        at least out_h), after its auto-shrink (fsr_band_layout): the unit
        of band_range.
      band_range: optional (g0, g1): build for the output rows
        [g0 * TH, min(g1 * TH, out_h)) of the FULL image only (spatial
        sharding: the tables and foveation classes are the full image's,
        the tile lists the band's). fn then takes the input row strip
        [fn.in_row_base, fn.in_row_base + fn.in_rows) as (B, fn.in_rows,
        in_w) (or in_w padded to the ring pitch) and returns the band's
        fn.out_rows rows; fn.band_range is (g0, g1), fn.dma_geometry the
        strip kernels' (kernels/_maps.py::band_geometry).
      precision: "full" (f32, the oracle's bits) or "half": EASU and RCAS
        in bf16, op by op as the JAX kernel's precision="half"
        (fsr_fused_reference; the CUDA kernel's half instantiations), with
        or without band_range, as the JAX builder takes both.

    Returns fn(img): img is a contiguous (B, in_h, in_w) int32 tensor, or
    one pre-padded to the ring pitch fn.pad_to (rows read in place, no
    copy), holding packed RGBA8 texels (little-endian, R in the low byte);
    the result is a new (B, out_h, out_w) int32 tensor of packed RGBA8 with
    alpha 255 on img's device. At color_bits 10 img is a (B, in_h, in_w,
    4) uint16 tensor (or pre-padded the same way) and the result a
    (B, out_h, out_w, 4) uint16 one with alpha 3. fn.launches counts calls that launched the
    CUDA kernels (one per call: the outside pass and the inside kernel,
    each only where its tile list is not empty); fn.reference(img) runs the
    plain version on img's device; fn.dma_geometry is what the kernels load
    and store (kernels/sol.py).
    """
    dt = working_type(precision)
    B, H, W = int(batch), int(in_h), int(in_w)
    OH, OW = int(out_h), int(out_w)
    th, gy = fsr_band_layout(OW, OH, band_rows)
    r0, r1 = (0, OH) if band_range is None else band_output_rows(
        th, gy, OH, band_range)
    maps, base, rows = band_strip(fsr_maps(B, H, W, OW, OH, centres),
                                  (r0, r1), IN_TILE, "clamp")
    tables = DeviceTables(maps)
    sharp = C.fsr_rcas_con(C.rcas_stops_from_slider(sharpness))
    tint = debug_tint(debug)
    cb = int(color_bits)
    # the scalar arguments in the kernel's types, once: a call converts none
    sharp_k, tint_k = lit(sharp, dt), float(tint)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return fsr_fused_reference(img, tables.on(img.device), sharp, tint,
                                   cb, (base, r0, r1), precision)

    def launch(img):
        dev = img.device
        m = tables.on(dev)
        out = torch.empty((B, r1 - r0, OW, 4) if cb == 10
                          else (B, r1 - r0, OW), dtype=img.dtype, device=dev)
        err = _launch_fn(*entry_args(cb, precision))(
            img.data_ptr(), out.data_ptr(), m.col_i.data_ptr(),
            m.col_f.data_ptr(), m.row_i.data_ptr(), m.row_f.data_ptr(),
            m.tile_x0.data_ptr(), m.tile_y0.data_ptr(),
            m.group_cls.data_ptr(), m.inside_tiles.data_ptr(), n_inside,
            m.outside_tiles.data_ptr(), n_outside, B, H, W, base,
            img.shape[1], img.shape[2], OH, OW, r0, r1, sharp_k, tint_k,
            FSR_TILE, IN_TILE,
            torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    m = tables.host
    n_inside, n_outside = len(m.inside_tiles), len(m.outside_tiles)
    # the inside tiles stage their 40x40 window edge-clamped; an output's
    # own tap there is its clamped EASU floor. The outside tiles load each
    # output's four bilinear taps (fsr_outside_kernel).
    geometry = dma_geometry(
        OH, OW, (FSR_TILE, FSR_TILE), (IN_TILE, IN_TILE), m.tile_x0,
        m.tile_y0, m.centres, oob="clamp", stage="list",
        staged=m.tile_inside, stage_quads=False, group=(TILE, TILE),
        tap_x=np.clip(m.col_i[0], 0, W - 1),
        tap_y=np.clip(m.row_i[0], 0, H - 1),
        quad_x=m.col_i[[1, 1]], quad_y=m.row_i[[1, 1]])
    geometry = word_geometry(geometry, texel_words(cb))
    work = launch_work(m.group_cls, (TILE, TILE), OH, OW, n_inside,
                       n_outside, (r0, r1))
    if band_range is not None:
        return band_fn("fused FSR strip", B, (rows, W), input_padding(H, W),
                       reference, launch,
                       band_geometry(geometry, (r0, r1), base, rows), cb,
                       precision, band_range, base, r1 - r0, work)
    return kernel_fn("fused FSR", B, (H, W), input_padding(H, W), reference,
                     launch, geometry, cb, precision, work)
