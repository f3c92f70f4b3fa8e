"""The NVIDIA Image Scaling kernels, NVSharpen (NIS at renderScale 1) and
NVScaler (NIS upscale): build, launch, and their plain versions.

`build_nvsharpen` and `build_nvscaler` are the ports of the JAX package's
kernels/nis.py builders for the 8-bit packed path, HDR modes 0/1/2. What
each computes per pixel, with the foveated select of the reference
pipeline (api/pipeline.py:419-476 of the JAX package):

  NVSharpen (NIS_Scaler.h:876-971): inside the circle (32x32 blocks) the
    sharpened colour with the source alpha; outside, the source colour
    times the debug tint with alpha 1 (kernels/nis.py:238-241).
  NVScaler (NIS_Scaler.h:589-770): inside the circle (32x24 blocks) the
    luma-corrected bilinear RGBA tap with the tap's alpha; outside, the
    DirectCopy bilinear tap at (x/OW, y/OH) times the tint with alpha 1
    (NIS_Upscale.hlsl:77-90).

The returned functions launch the CUDA kernels (csrc/nis_sharpen.cu,
csrc/nis_scaler.cu) for a CUDA tensor and run `nvsharpen_reference` /
`nvscaler_reference`, the same computations in plain torch (ops/nis.py),
for a CPU tensor. Nothing falls back.
"""

import ctypes
import functools

import numpy as np
import torch

from ..core.constants import NisConfig
from ..core.foveation import TILE_NIS_SCALER, TILE_NIS_SHARPEN
from ..ops.bilinear import bilinear_fallback_fsr
from ..ops.nis import KHDR_COMPRESSION, NIS_SCALE_FLOAT, nvscaler, nvsharpen
from . import _build
from ._common import (DeviceTables, centres_table, circle_mask, debug_tint,
                      kernel_fn, pack, tint_vector, unpack)
from ._maps import NIS_IN_TILE, input_padding, nvscaler_maps

__all__ = ["build_nvsharpen", "build_nvscaler", "nvsharpen_reference",
           "nvscaler_reference"]

F32 = np.float32


def _consts(cfg: NisConfig):
    """The config constants the kernels read, as f32 in the order of
    csrc/nis_math.cuh nis::Consts."""
    return np.array([
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


def nvsharpen_reference(img, centres, nis_cfg, tint):
    """NVSharpen with the foveated select in plain torch, on img's device.

    img: (B, H, W) int32 packed RGBA8; centres: (B, 5) int64 on img's
    device; tint: the out-of-circle G/B multiplier. Returns (B, H, W)
    int32 packed RGBA8."""
    rgba = unpack(img)
    sh = nvsharpen(rgba, nis_cfg)
    inside = circle_mask(centres, img.shape[1], img.shape[2],
                         TILE_NIS_SHARPEN)
    rgb = torch.where(inside[:, None], sh[:, :3],
                      rgba[:, :3] * tint_vector(tint, img.device))
    return pack(rgb, torch.where(inside, rgba[:, 3], 1.0))


def nvscaler_reference(img, centres, out_w, out_h, nis_cfg, tint):
    """NVScaler with the foveated DirectCopy fallback in plain torch, on
    img's device.

    img: (B, H, W) int32 packed RGBA8; centres: (B, 5) int64 on img's
    device; tint: the out-of-circle G/B multiplier. Returns (B, out_h,
    out_w) int32 packed RGBA8."""
    rgba = unpack(img)
    up = nvscaler(rgba, out_w, out_h, nis_cfg)
    fb = bilinear_fallback_fsr(rgba[:, :3], out_w, out_h)
    inside = circle_mask(centres, out_h, out_w, TILE_NIS_SCALER)
    rgb = torch.where(inside[:, None], up[:, :3],
                      fb * tint_vector(tint, img.device))
    return pack(rgb, torch.where(inside, up[:, 3], 1.0))


@functools.cache
def _sharpen_fn():
    """NVSharpen's ctypes entry point, bound (and built) at first launch."""
    f = _build.load_library("nis_sharpen").nis_sharpen_launch
    f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


@functools.cache
def _scaler_fn():
    """NVScaler's ctypes entry point, bound (and built) at first launch."""
    f = _build.load_library("nis_scaler").nis_scaler_launch
    f.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                  + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def build_nvsharpen(batch, h, w, *, nis_cfg: NisConfig, centres, debug=False):
    """Build the NVSharpen kernel for a fixed shape/config.

    Args:
      batch, h, w: static sizes (output = input size).
      nis_cfg: core.constants.nvsharpen_update_config(...) (its hdr_mode
        selects getY and the correction).
      centres: (B, 5) int array per batch entry (core.constants.
        centres_payload at the frame size).
      debug: out-of-radius tint 1-(0, .3, .3).

    Returns fn(img): img is a contiguous (B, h, w) int32 tensor, or one
    pre-padded to the ring pitch fn.pad_to, of packed RGBA8 texels; the
    result is a new (B, h, w) int32 tensor of packed RGBA8 on img's device.
    fn.launches counts CUDA launches; fn.reference(img) runs the plain
    version on img's device.
    """
    B, H, W = int(batch), int(h), int(w)
    cen = centres_table(B, centres)
    consts = _consts(nis_cfg)
    tint = debug_tint(debug)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return nvsharpen_reference(img[:, :H, :W], cen.on(img.device),
                                   nis_cfg, tint)

    def launch(img):
        dev = img.device
        out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        err = _sharpen_fn()(
            img.data_ptr(), out.data_ptr(), cen.on(dev).data_ptr(),
            consts.ctypes.data, consts.size, B, H, W, img.shape[1],
            img.shape[2], int(nis_cfg.hdr_mode), float(tint),
            torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    return kernel_fn("NVSharpen", B, (H, W), input_padding(H, W), reference,
                     launch)


def build_nvscaler(batch, in_h, in_w, out_w, out_h, *, nis_cfg: NisConfig,
                   centres, debug=False):
    """Build the NVScaler kernel for a fixed shape/config.

    Args:
      batch, in_h, in_w, out_w, out_h: static sizes.
      nis_cfg: core.constants.nvscaler_update_config(...); a config with
        valid=False (scale outside 0.5..1) runs all the same, as in the
        reference.
      centres: (B, 5) int array per batch entry (core.constants.
        centres_payload at the output size).
      debug: out-of-radius tint 1-(0, .3, .3).

    Returns fn(img) as build_nvsharpen's, with a (B, out_h, out_w) result.
    Raises ValueError here if a block's luma footprint exceeds the kernel's
    shared-memory tile.
    """
    B, H, W = int(batch), int(in_h), int(in_w)
    OH, OW = int(out_h), int(out_w)
    tables = DeviceTables(nvscaler_maps(B, H, W, OW, OH, nis_cfg, centres))
    consts = _consts(nis_cfg)
    tint = debug_tint(debug)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return nvscaler_reference(img[:, :H, :W],
                                  tables.on(img.device).centres, OW, OH,
                                  nis_cfg, tint)

    def launch(img):
        dev = img.device
        m = tables.on(dev)
        out = torch.empty((B, OH, OW), dtype=torch.int32, device=dev)
        err = _scaler_fn()(
            img.data_ptr(), out.data_ptr(), m.col_i.data_ptr(),
            m.col_f.data_ptr(), m.row_i.data_ptr(), m.row_f.data_ptr(),
            m.tile_x0.data_ptr(), m.tile_y0.data_ptr(), m.centres.data_ptr(),
            m.coef.data_ptr(), consts.ctypes.data, consts.size, B, H, W,
            img.shape[1], img.shape[2], OH, OW, int(nis_cfg.hdr_mode),
            float(tint), *NIS_IN_TILE,
            torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    return kernel_fn("NVScaler", B, (H, W), input_padding(H, W), reference,
                     launch)
