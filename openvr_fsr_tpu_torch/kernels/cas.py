"""The two CAS kernels: build, launch, and their plain versions.

The ports of the JAX package's kernels/cas.py for the 8-bit packed path.
The reference keeps CAS in-tree but out of the build; the JAX package ships
it as a pipeline mode with the FSR wrappers' foveation and debug tint, one
CasFilter pass per plan (Config.stage_plan):

  build_cas_upscale   renderScale != 1: CasFilter scaling (ffx_cas.h:
                      552-892) inside the foveation circle, the bilinear
                      fallback (fsr_easu.hlsl:33-36) times the debug tint
                      outside, alpha 1 (csrc/cas_upscale.cu);
  build_cas_sharpen   renderScale 1: CasFilter noScaling (ffx_cas.h:
                      430-552) with the maxColorDelta clamp inside, alpha 1;
                      the source colour times the tint with the source's
                      alpha outside (csrc/cas_sharpen.cu).

Each returned function launches its CUDA kernel for a CUDA tensor and runs
the plain torch version (cas_upscale_reference, cas_sharpen_reference) for
a CPU tensor. Nothing falls back.
"""

import ctypes
import functools

import torch

from ..core.foveation import TILE_FSR
from ..ops.bilinear import bilinear_gather
from ..ops.cas import (cas_core, cas_setup, cas_sharpen_taps,
                       cas_upscale_core, cas_upscale_gather)
from ..ops.common import F32
from . import _build
from ._common import (DeviceTables, centres_table, circle_mask, debug_tint,
                      kernel_fn, pack, tint_vector, unpack)
from ._maps import CAS_IN_TILE, cas_upscale_maps, input_padding

__all__ = ["build_cas_upscale", "build_cas_sharpen", "cas_upscale_reference",
           "cas_sharpen_reference"]


def cas_upscale_reference(img, maps, sharp, tint):
    """The CAS upscale kernel's computation in plain torch, on img's device.

    img: (B, H, W) or pre-padded (B, HP, WP) int32 packed RGBA8; maps: the
    build's cas_upscale_maps on img's device; sharp: the cas_setup constant;
    tint: the out-of-circle G/B multiplier. Returns (B, OH, OW) int32
    packed RGBA8 with alpha 255."""
    m = maps
    rgb = unpack(img[:, :m.in_h, :m.in_w], 3)
    taps = cas_upscale_gather(rgb, m.col_i[0], m.row_i[0])
    up = cas_upscale_core(taps, m.col_f[0][None, :], m.row_f[0][:, None],
                          sharp)
    bil = bilinear_gather(rgb, m.col_i[1], m.col_f[1], m.row_i[1],
                          m.row_f[1])
    inside = circle_mask(m.centres, m.out_h, m.out_w, TILE_FSR)[:, None]
    return pack(torch.where(inside, up, bil * tint_vector(tint, img.device)))


def cas_sharpen_reference(img, centres, sharp, max_color_delta, tint):
    """The CAS sharpen-only kernel's computation in plain torch, on img's
    device.

    img: (B, H, W) int32 packed RGBA8 (a pre-padded plane is cropped by the
    caller); centres: (B, 5) int64 on img's device; sharp: the cas_setup
    constant; tint: the out-of-circle G/B multiplier. Returns (B, H, W)
    int32 packed RGBA8."""
    rgba = unpack(img)
    rgb, alpha = rgba[:, :3], rgba[:, 3]
    inside = circle_mask(centres, img.shape[1], img.shape[2], TILE_FSR)
    sharp_rgb = cas_core(cas_sharpen_taps(rgb), sharp, max_color_delta)
    out_rgb = torch.where(inside[:, None], sharp_rgb,
                          rgb * tint_vector(tint, img.device))
    return pack(out_rgb, torch.where(inside, 1.0, alpha))


@functools.cache
def _upscale_launch_fn():
    """The ctypes entry point, bound (and built) at the first launch."""
    f = _build.load_library("cas_upscale").cas_upscale_launch
    f.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                  + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


@functools.cache
def _sharpen_launch_fn():
    """The ctypes entry point, bound (and built) at the first launch."""
    f = _build.load_library("cas_sharpen").cas_sharpen_launch
    f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                  + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def build_cas_upscale(batch, in_h, in_w, out_w, out_h, *, sharpness,
                      centres, debug=False):
    """Build the CAS scaling kernel for a fixed shape/config.

    Args:
      batch, in_h, in_w, out_w, out_h: static sizes (out >= in, as
        Config.output_size gives them; a footprint the kernel cannot stage
        raises here).
      sharpness: the [0,1] CAS slider (CasSetup, ffx_cas.h:391).
      centres: (B, 5) int array per batch entry: cx1, cy1, cx2, cy2,
        radius_sq (core.constants.centres_payload at the output size).
      debug: out-of-radius tint 1-(0, .3, .3).

    Returns fn(img) with the fused FSR kernel's contract: img is a
    contiguous (B, in_h, in_w) int32 tensor of packed RGBA8, or one
    pre-padded to the ring pitch fn.pad_to; the result is a new (B, out_h,
    out_w) int32 tensor of packed RGBA8 with alpha 255 on img's device.
    fn.launches counts CUDA launches; fn.reference(img) runs the plain
    version on img's device.
    """
    B, H, W = int(batch), int(in_h), int(in_w)
    OH, OW = int(out_h), int(out_w)
    tables = DeviceTables(cas_upscale_maps(B, H, W, OW, OH, centres))
    sharp = cas_setup(sharpness)
    tint = debug_tint(debug)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return cas_upscale_reference(img, tables.on(img.device), sharp, tint)

    def launch(img):
        dev = img.device
        m = tables.on(dev)
        out = torch.empty((B, OH, OW), dtype=torch.int32, device=dev)
        err = _upscale_launch_fn()(
            img.data_ptr(), out.data_ptr(), m.col_i.data_ptr(),
            m.col_f.data_ptr(), m.row_i.data_ptr(), m.row_f.data_ptr(),
            m.tile_x0.data_ptr(), m.tile_y0.data_ptr(), m.centres.data_ptr(),
            B, H, W, img.shape[1], img.shape[2], OH, OW, float(sharp),
            float(tint), CAS_IN_TILE,
            torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    return kernel_fn("CAS upscale", B, (H, W), input_padding(H, W),
                     reference, launch)


def build_cas_sharpen(batch, h, w, *, sharpness, centres, debug=False,
                      max_color_delta=1.0):
    """Build the CAS sharpen-only kernel for a fixed shape/config.

    Args:
      batch, h, w: static sizes (output = input size).
      sharpness: the [0,1] CAS slider (CasSetup, ffx_cas.h:391).
      centres: (B, 5) int array per batch entry (core.constants.
        centres_payload at the frame size).
      debug: out-of-radius tint 1-(0, .3, .3).
      max_color_delta: CasSetup's maxColorDelta (ffx_cas.h:379); 1 leaves
        the sharpened colour unclamped.

    Returns fn(img) with the RCAS sharpen-only kernel's contract (kernels/
    rcas.py::build_rcas_sharpen).
    """
    B, H, W = int(batch), int(h), int(w)
    cen = centres_table(B, centres)
    sharp = cas_setup(sharpness)
    mcd = F32(max_color_delta)
    tint = debug_tint(debug)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return cas_sharpen_reference(img[:, :H, :W], cen.on(img.device),
                                     sharp, mcd, tint)

    def launch(img):
        dev = img.device
        out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        err = _sharpen_launch_fn()(
            img.data_ptr(), out.data_ptr(), cen.on(dev).data_ptr(), B, H,
            W, img.shape[1], img.shape[2], float(sharp), float(mcd),
            float(tint), torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    return kernel_fn("CAS sharpen", B, (H, W), input_padding(H, W),
                     reference, launch)
