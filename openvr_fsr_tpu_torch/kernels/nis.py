"""The NVIDIA Image Scaling kernels, NVSharpen (NIS at renderScale 1) and
NVScaler (NIS upscale): build, launch, and their plain versions.

`build_nvsharpen` and `build_nvscaler` are the ports of the JAX package's
kernels/nis.py builders, HDR modes 0/1/2, on RGBA8 (color_bits 8, packed
u32 planes) and R10G10B10A2 (color_bits 10, (B, H, W, 4) uint16 frames)
texels: only the texel decode and encode change with the format
(NIS_SCALE_FLOAT stays 255, a shader constant, JAX ops/nis.py:20). What
each computes per pixel, with the foveated select of the reference
pipeline (api/pipeline.py:419-476 of the JAX package):

  NVSharpen (NIS_Scaler.h:876-971): inside the circle (32x32 blocks) the
    sharpened colour with the source alpha; outside, the source colour
    times the debug tint with alpha 1 (kernels/nis.py:238-241).
  NVScaler (NIS_Scaler.h:589-770): inside the circle (32x24 blocks) the
    luma-corrected bilinear RGBA tap with the tap's alpha; outside, the
    DirectCopy bilinear tap at (x/OW, y/OH) times the tint with alpha 1
    (NIS_Upscale.hlsl:77-90).

The returned functions launch the CUDA kernels (csrc/nis_sharpen.cu, the
copy pass over the 32x32 blocks outside the circle and an NVSharpen kernel
over those inside; csrc/nis_scaler.cu, a DirectCopy pass over the 32x48
tiles outside the circle and an NVScaler kernel over those inside; each
from one C entry point)
for a CUDA tensor and run `nvsharpen_reference` /
`nvscaler_reference`, the same computations in plain torch (ops/nis.py),
for a CPU tensor. Nothing falls back. precision="half" runs the filters
in bf16 as the JAX kernels' precision="half" does (ops/nis.py at dt=bf16:
NVScaler's FilterNormal, interpolation trees and EvalPoly6, NVSharpen's
USM), through the half instantiations of the inside kernels
(<kernel>_launch_h, _launch10_h); the fallbacks outside the circle are the
same.
"""

import ctypes
import functools

import numpy as np
import torch

from ..core.constants import NisConfig
from ..core.foveation import TILE_NIS_SCALER, TILE_NIS_SHARPEN
from ..ops.bilinear import bilinear_fallback_fsr
from ..ops.common import lit
from ..ops.nis import KHDR_COMPRESSION, NIS_SCALE_FLOAT, nvscaler, nvsharpen
from . import _build
from ._common import (DeviceTables, circle_mask, debug_tint, entry_args,
                      entry_name, kernel_fn, pack, texel_words, tint_vector,
                      unpack, working_type)
from ._maps import (NIS_EDGE_TILE, NIS_IN_TILE, NIS_SHARPEN_IN_TILE,
                    NIS_TILE, SHARPEN_TILE, dma_geometry, input_padding,
                    launch_work, nvscaler_maps, sharpen_geometry,
                    sharpen_maps, word_geometry)

__all__ = ["build_nvsharpen", "build_nvscaler", "nvsharpen_reference",
           "nvscaler_reference"]

F32 = np.float32


# nis::Consts entries the filters read in their working type (the JAX
# kernels' dt(cfg.k...) literals): kMinContrastRatio through
# kSharpLimitScale; the edge map's thresholds and the corrections' constants
# stay f32
_DT_CONSTS = slice(2, 13)


def _consts(cfg: NisConfig, dt=torch.float32):
    """The config constants the kernels read, in the order of
    csrc/nis_math.cuh nis::Consts: f32, those of _DT_CONSTS rounded to the
    working type dt."""
    k = np.array([
        cfg.kDetectRatio, cfg.kDetectThres, cfg.kMinContrastRatio,
        cfg.kRatioNorm, cfg.kContrastBoost, cfg.kEps,
        cfg.kEps * F32(1.0 / 255.0),
        cfg.kSharpStartY, cfg.kSharpScaleY, cfg.kSharpStrengthMin,
        cfg.kSharpStrengthScale, cfg.kSharpLimitMin, cfg.kSharpLimitScale,
        F32(1e-4),
        np.divide(F32(1.0), NIS_SCALE_FLOAT * KHDR_COMPRESSION,
                  dtype=np.float32),
        F32(1e-4) * KHDR_COMPRESSION * KHDR_COMPRESSION,
    ], np.float32)
    k[_DT_CONSTS] = [lit(v, dt) for v in k[_DT_CONSTS]]
    return k


def nvsharpen_reference(img, centres, nis_cfg, tint, color_bits=8,
                        precision="full"):
    """NVSharpen with the foveated select in plain torch, on img's device.

    img: (B, H, W) int32 packed RGBA8, or at color_bits 10 (B, H, W, 4)
    uint16 R10G10B10A2; centres: (B, 5) int64 on img's device; tint: the
    out-of-circle G/B multiplier; precision: "full", or "half" for the USM
    in bf16. Returns a frame of img's shape and format."""
    rgba = unpack(img, 4, color_bits)
    sh = nvsharpen(rgba, nis_cfg, working_type(precision))
    inside = circle_mask(centres, img.shape[1], img.shape[2],
                         TILE_NIS_SHARPEN)
    rgb = torch.where(inside[:, None], sh[:, :3],
                      rgba[:, :3] * tint_vector(tint, img.device))
    return pack(rgb, torch.where(inside, rgba[:, 3], 1.0), color_bits)


def nvscaler_reference(img, centres, out_w, out_h, nis_cfg, tint,
                       color_bits=8, precision="full"):
    """NVScaler with the foveated DirectCopy fallback in plain torch, on
    img's device.

    img: (B, H, W) int32 packed RGBA8, or at color_bits 10 (B, H, W, 4)
    uint16 R10G10B10A2; centres: (B, 5) int64 on img's device; tint: the
    out-of-circle G/B multiplier; precision: "full", or "half" for the
    filters in bf16. Returns (B, out_h, out_w) int32 packed RGBA8, or
    (B, out_h, out_w, 4) uint16."""
    rgba = unpack(img, 4, color_bits)
    up = nvscaler(rgba, out_w, out_h, nis_cfg, working_type(precision))
    fb = bilinear_fallback_fsr(rgba[:, :3], out_w, out_h)
    inside = circle_mask(centres, out_h, out_w, TILE_NIS_SCALER)
    rgb = torch.where(inside[:, None], up[:, :3],
                      fb * tint_vector(tint, img.device))
    return pack(rgb, torch.where(inside, up[:, 3], 1.0), color_bits)


# csrc/nis_sharpen.cu nis_sharpen_launch: img, out, the inside list and its
# length, the outside list and its length, consts and their count, batch, h,
# w, rows, pitch, hdr_mode, tint, tile, window, stream
SHARPEN_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_void_p]
                    + [ctypes.c_int] * 7 + [ctypes.c_float]
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@functools.cache
def _sharpen_fn(color_bits=8, precision="full"):
    """NVSharpen's ctypes entry point of `color_bits` and `precision`
    (nis_sharpen_launch, nis_sharpen_launch10, or either with the suffix
    _h), bound (and built) at first launch."""
    f = getattr(_build.load_library("nis_sharpen"),
                entry_name("nis_sharpen_launch", color_bits, precision))
    f.argtypes = SHARPEN_ARGTYPES
    f.restype = ctypes.c_int
    return f


@functools.cache
def _scaler_fn(color_bits=8, precision="full"):
    """NVScaler's ctypes entry point of `color_bits` and `precision`
    (nis_scaler_launch, nis_scaler_launch10, or either with the suffix
    _h), bound (and built) at first launch."""
    f = getattr(_build.load_library("nis_scaler"),
                entry_name("nis_scaler_launch", color_bits, precision))
    f.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_void_p]
                  + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 9
                  + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def build_nvsharpen(batch, h, w, *, nis_cfg: NisConfig, centres, debug=False,
                    color_bits=8, precision="full"):
    """Build the NVSharpen kernel for a fixed shape/config.

    Args:
      batch, h, w: static sizes (output = input size).
      nis_cfg: core.constants.nvsharpen_update_config(...) (its hdr_mode
        selects getY and the correction).
      centres: (B, 5) int array per batch entry (core.constants.
        centres_payload at the frame size).
      debug: out-of-radius tint 1-(0, .3, .3).
      color_bits: 8 (RGBA8) or 10 (R10G10B10A2 passthrough).
      precision: "full" (f32) or "half" (the USM in bf16, op by op as the
        JAX kernel's precision="half"; the edge map on the rounded luma).

    Returns fn(img): img is a contiguous (B, h, w) int32 tensor, or one
    pre-padded to the ring pitch fn.pad_to, of packed RGBA8 texels; the
    result is a new (B, h, w) int32 tensor of packed RGBA8 on img's device.
    At color_bits 10 img is a (B, h, w, 4) uint16 tensor (or pre-padded the
    same way) and the result a (B, h, w, 4) uint16 one. fn.launches counts
    CUDA launches; fn.reference(img) runs the plain
    version on img's device; fn.dma_geometry is what the kernel loads and
    stores (kernels/sol.py), the same at both precisions; fn.precision is
    published.
    """
    dt = working_type(precision)
    B, H, W = int(batch), int(h), int(w)
    tables = DeviceTables(sharpen_maps(B, H, W, centres, TILE_NIS_SHARPEN))
    consts = _consts(nis_cfg, dt)
    tint = debug_tint(debug)
    cb = int(color_bits)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return nvsharpen_reference(img[:, :H, :W],
                                   tables.on(img.device).centres, nis_cfg,
                                   tint, cb, precision)

    def launch(img):
        dev = img.device
        m = tables.on(dev)
        out = torch.empty((B, H, W, 4) if cb == 10 else (B, H, W),
                          dtype=img.dtype, device=dev)
        err = _sharpen_fn(*entry_args(cb, precision))(
            img.data_ptr(), out.data_ptr(), m.inside_tiles.data_ptr(),
            n_inside, m.outside_tiles.data_ptr(), n_outside,
            consts.ctypes.data, consts.size, B, H, W, img.shape[1],
            img.shape[2], int(nis_cfg.hdr_mode), float(tint), SHARPEN_TILE,
            NIS_SHARPEN_IN_TILE, torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    # a block inside the circle stages its 36x36 edge-clamped window; the
    # others copy their texels
    m = tables.host
    n_inside, n_outside = len(m.inside_tiles), len(m.outside_tiles)
    return kernel_fn("NVSharpen", B, (H, W), input_padding(H, W), reference,
                     launch, word_geometry(
                         sharpen_geometry(H, W, SHARPEN_TILE, 2, m.centres,
                                          "clamp", staged=m.tile_inside),
                         texel_words(cb)), cb, precision,
                     launch_work(m.group_cls, TILE_NIS_SHARPEN, H, W,
                                 n_inside, n_outside))


def build_nvscaler(batch, in_h, in_w, out_w, out_h, *, nis_cfg: NisConfig,
                   centres, debug=False, color_bits=8, precision="full"):
    """Build the NVScaler kernel for a fixed shape/config.

    Args:
      batch, in_h, in_w, out_w, out_h: static sizes.
      nis_cfg: core.constants.nvscaler_update_config(...); a config with
        valid=False (scale outside 0.5..1) runs all the same, as in the
        reference.
      centres: (B, 5) int array per batch entry (core.constants.
        centres_payload at the output size).
      debug: out-of-radius tint 1-(0, .3, .3).
      color_bits: 8 (RGBA8) or 10 (R10G10B10A2 passthrough).
      precision: "full" (f32) or "half" (FilterNormal, the interpolation
        trees and EvalPoly6 in bf16, op by op as the JAX kernel's
        precision="half"; the edge map on the f32 luma).

    Returns fn(img) as build_nvsharpen's, with a (B, out_h, out_w) result
    ((B, out_h, out_w, 4) at color_bits 10);
    fn.launches counts calls that launched the CUDA kernels (one per call:
    the DirectCopy pass and the inside kernel, each only where its tile
    list is not empty). Raises ValueError here if a tile's luma window or
    edge-map extent exceeds the kernel's shared-memory caps.
    """
    dt = working_type(precision)
    B, H, W = int(batch), int(in_h), int(in_w)
    OH, OW = int(out_h), int(out_w)
    tables = DeviceTables(nvscaler_maps(B, H, W, OW, OH, nis_cfg, centres))
    consts = _consts(nis_cfg, dt)
    tint = debug_tint(debug)
    cb = int(color_bits)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return nvscaler_reference(img[:, :H, :W],
                                  tables.on(img.device).centres, OW, OH,
                                  nis_cfg, tint, cb, precision)

    def launch(img):
        dev = img.device
        m = tables.on(dev)
        out = torch.empty((B, OH, OW, 4) if cb == 10 else (B, OH, OW),
                          dtype=img.dtype, device=dev)
        err = _scaler_fn(*entry_args(cb, precision))(
            img.data_ptr(), out.data_ptr(), m.col_i.data_ptr(),
            m.col_f.data_ptr(), m.row_i.data_ptr(), m.row_f.data_ptr(),
            m.tile_x0.data_ptr(), m.tile_y0.data_ptr(), m.edge_x.data_ptr(),
            m.edge_y.data_ptr(), m.block_cls.data_ptr(), m.coef.data_ptr(),
            m.inside_tiles.data_ptr(), n_inside,
            m.outside_tiles.data_ptr(), n_outside, consts.ctypes.data,
            consts.size, B, H, W, img.shape[1], img.shape[2], OH, OW,
            int(nis_cfg.hdr_mode), float(tint), *NIS_TILE, *NIS_IN_TILE,
            *NIS_EDGE_TILE, torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    # a 32x48 tile with a block inside the circle stages its 40x56
    # edge-clamped luma window and loads each pixel's RGBA tap (its blocks
    # outside load the four DirectCopy taps instead: the same count); the
    # other tiles load the four DirectCopy taps of each pixel
    m = tables.host
    n_inside, n_outside = len(m.inside_tiles), len(m.outside_tiles)
    geometry = dma_geometry(
        OH, OW, NIS_TILE, NIS_IN_TILE, m.tile_x0, m.tile_y0, m.centres,
        oob="clamp", stage="list", staged=m.tile_inside, stage_quads=True,
        group=TILE_NIS_SCALER, tap_x=np.clip(m.col_i[0], 0, W - 1),
        tap_y=np.clip(m.row_i[0], 0, H - 1),
        quad_x=m.col_i[2:4], quad_y=m.row_i[2:4])
    return kernel_fn("NVScaler", B, (H, W), input_padding(H, W), reference,
                     launch, word_geometry(geometry, texel_words(cb)), cb,
                     precision, launch_work(m.block_cls, TILE_NIS_SCALER, OH,
                                            OW, n_inside, n_outside))
