"""The two CAS kernels: build, launch, and their plain versions.

The ports of the JAX package's kernels/cas.py, on RGBA8 (color_bits 8,
packed u32 planes) and R10G10B10A2 (color_bits 10, (B, H, W, 4) uint16
frames) texels.
The reference keeps CAS in-tree but out of the build; the JAX package ships
it as a pipeline mode with the FSR wrappers' foveation and debug tint, one
CasFilter pass per plan (Config.stage_plan):

  build_cas_upscale   renderScale != 1: CasFilter scaling (ffx_cas.h:
                      552-892) inside the foveation circle, the bilinear
                      fallback (fsr_easu.hlsl:33-36) times the debug tint
                      outside, alpha 1 (csrc/cas_upscale.cu: a bilinear
                      pass over the 32x32 tiles outside the circle and a
                      CasFilter kernel over those inside, from one C entry
                      point);
  build_cas_sharpen   renderScale 1: CasFilter noScaling (ffx_cas.h:
                      430-552) with the maxColorDelta clamp inside, alpha 1;
                      the source colour times the tint with the source's
                      alpha outside (csrc/cas_sharpen.cu: the copy pass over
                      the 32x32 tiles outside the circle and a CasFilter
                      kernel over those inside, from one C entry point).

Each returned function launches its CUDA kernel for a CUDA tensor and runs
the plain torch version (cas_upscale_reference, cas_sharpen_reference) for
a CPU tensor. Nothing falls back. build_cas_upscale's band_range builds a
row band of the full image from an input row strip (parallel/spatial.py),
as build_fsr_fused's does. precision="half" runs CasFilter in bf16 as the
JAX kernels' precision="half" does (ops/cas.py at dt=bf16), through the
half instantiations of the inside kernels (<kernel>_launch_h,
_launch10_h; build_cas_upscale's on the whole image or a strip); the
fallbacks outside the circle are the same.
"""

import numpy as np
import torch

from ..core.foveation import TILE_FSR
from ..ops.bilinear import bilinear_gather
from ..ops.cas import (cas_core, cas_setup, cas_sharpen_taps,
                       cas_upscale_core, cas_upscale_gather)
from ..ops.common import F32, lit
from ._common import (UPSCALE_TABLES, DeviceTables, band_fn, circle_mask,
                      class_launch, debug_tint, kernel_fn, pack, pointers,
                      texel_words, tile_lists, tint_vector, unpack,
                      working_type)
from ._maps import (CAS_IN_TILE, CAS_SHARPEN_IN_TILE, FSR_TILE, SHARPEN_TILE,
                    TILE, band_geometry, band_layout, band_output_rows,
                    band_strip, cas_upscale_maps, dma_geometry,
                    input_padding, launch_work, sharpen_geometry,
                    sharpen_maps, word_geometry)

__all__ = ["build_cas_upscale", "build_cas_sharpen", "cas_upscale_reference",
           "cas_sharpen_reference", "cas_band_layout"]


def cas_band_layout(out_w, out_h, band_rows=128, chunk=128):
    """(TH, GY) after the JAX CAS kernel's VMEM auto-shrink (the JAX
    package's kernels/cas.py::cas_band_layout; cf. fsr_band_layout)."""
    return band_layout(out_w, out_h, band_rows,
                       lambda th, owp: 9 * th * owp * 4, chunk)


def cas_upscale_reference(img, maps, sharp, tint, color_bits=8, band=None,
                          precision="full"):
    """The CAS upscale kernel's computation in plain torch, on img's device.

    img: (B, H, W) or pre-padded (B, HP, WP) int32 packed RGBA8, or at
    color_bits 10 the same with a trailing 4 of uint16 R10G10B10A2; maps:
    the build's cas_upscale_maps on img's device; sharp: the cas_setup
    constant; tint: the out-of-circle G/B multiplier; band: (in_row_base,
    out_row0, out_row1) of a row-band build, whose img is the input strip
    from the image's row in_row_base (row indices stay the full image's,
    rebased to the strip), default the whole image; precision: "full", or
    "half" for CasFilter in bf16. Returns (B, OH, OW) int32 packed RGBA8
    with alpha 255, or (B, OH, OW, 4) uint16 with alpha 3, for the band's
    OH = out_row1 - out_row0 rows."""
    m = maps
    base, r0, r1 = (0, 0, m.out_h) if band is None else band
    ri, rf = m.row_i[:, r0:r1], m.row_f[:, r0:r1]
    rgb = unpack(img[:, :m.in_h - base, :m.in_w], 3, color_bits)
    taps = cas_upscale_gather(rgb, m.col_i[0], ri[0], base, m.in_h)
    up = cas_upscale_core(taps, m.col_f[0][None, :], rf[0][:, None], sharp,
                          working_type(precision)).float()
    bil = bilinear_gather(rgb, m.col_i[1], m.col_f[1], ri[1], rf[1], base,
                          m.in_h)
    inside = circle_mask(m.centres, m.out_h, m.out_w,
                         TILE_FSR)[:, None, r0:r1]
    return pack(torch.where(inside, up, bil * tint_vector(tint, img.device)),
                color_bits=color_bits)


def cas_sharpen_reference(img, centres, sharp, max_color_delta, tint,
                          color_bits=8, precision="full"):
    """The CAS sharpen-only kernel's computation in plain torch, on img's
    device.

    img: (B, H, W) int32 packed RGBA8, or at color_bits 10 (B, H, W, 4)
    uint16 R10G10B10A2 (a pre-padded one is cropped by the caller);
    centres: (B, 5) int64 on img's device; sharp: the cas_setup constant;
    tint: the out-of-circle G/B multiplier; precision: "full", or "half"
    for CasFilter in bf16. Returns a frame of img's shape and format."""
    rgba = unpack(img, 4, color_bits)
    rgb, alpha = rgba[:, :3], rgba[:, 3]
    inside = circle_mask(centres, img.shape[1], img.shape[2], TILE_FSR)
    sharp_rgb = cas_core(cas_sharpen_taps(rgb), sharp, max_color_delta,
                         working_type(precision)).float()
    out_rgb = torch.where(inside[:, None], sharp_rgb,
                          rgb * tint_vector(tint, img.device))
    return pack(out_rgb, torch.where(inside, 1.0, alpha), color_bits)


def build_cas_upscale(batch, in_h, in_w, out_w, out_h, *, sharpness,
                      centres, debug=False, color_bits=8, band_rows=128,
                      band_range=None, precision="full"):
    """Build the CAS scaling kernel for a fixed shape/config.

    Args:
      batch, in_h, in_w, out_w, out_h: static sizes (out >= in, as
        Config.output_size gives them; a footprint the kernel cannot stage
        raises here).
      sharpness: the [0,1] CAS slider (CasSetup, ffx_cas.h:391).
      centres: (B, 5) int array per batch entry: cx1, cy1, cx2, cy2,
        radius_sq (core.constants.centres_payload at the output size).
      debug: out-of-radius tint 1-(0, .3, .3).
      color_bits: 8 (RGBA8) or 10 (R10G10B10A2 passthrough).
      band_rows, band_range: a row-band build, as build_fsr_fused's, at
        cas_band_layout's band height.
      precision: "full" (f32) or "half" (CasFilter in bf16, op by op as
        the JAX kernel's precision="half"), with or without band_range.

    Returns fn(img) with the fused FSR kernel's contract: img is a
    contiguous (B, in_h, in_w) int32 tensor of packed RGBA8, or one
    pre-padded to the ring pitch fn.pad_to; the result is a new (B, out_h,
    out_w) int32 tensor of packed RGBA8 with alpha 255 on img's device (at
    color_bits 10, (B, in_h, in_w, 4) uint16 in and (B, out_h, out_w, 4)
    uint16 with alpha 3 out).
    fn.launches counts calls that launched the CUDA kernels (one per call:
    the outside pass and the inside kernel, each only where its tile list
    is not empty); fn.reference(img) runs the plain version on img's
    device; fn.dma_geometry is what the kernels load and store
    (kernels/sol.py; a strip's: kernels/_maps.py::band_geometry).
    """
    dt = working_type(precision)
    B, H, W = int(batch), int(in_h), int(in_w)
    OH, OW = int(out_h), int(out_w)
    th, gy = cas_band_layout(OW, OH, band_rows)
    r0, r1 = (0, OH) if band_range is None else band_output_rows(
        th, gy, OH, band_range)
    maps, base, rows = band_strip(cas_upscale_maps(B, H, W, OW, OH, centres),
                                  (r0, r1), CAS_IN_TILE, "zero")
    tables = DeviceTables(maps)
    sharp = cas_setup(sharpness)
    tint = debug_tint(debug)
    cb = int(color_bits)
    # the scalar arguments in the kernel's types, once: a call converts none
    sharp_k, tint_k = lit(sharp, dt), float(tint)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return cas_upscale_reference(img, tables.on(img.device), sharp, tint,
                                     cb, (base, r0, r1), precision)

    launch = class_launch(
        "cas_upscale", tables, (B, r1 - r0, OW),
        lambda d: (*pointers(d, *UPSCALE_TABLES), *tile_lists(d), B, H, W,
                   base),
        (OH, OW, r0, r1, sharp_k, tint_k, FSR_TILE, CAS_IN_TILE), cb,
        precision)
    m = tables.host
    n_inside, n_outside = len(m.inside_tiles), len(m.outside_tiles)
    # the inside tiles stage their 36x36 window, which may start at -2, 0
    # outside the image; an output's own tap there is its clamped CasFilter
    # floor. The outside tiles load each output's four bilinear taps.
    geometry = dma_geometry(
        OH, OW, (FSR_TILE, FSR_TILE), (CAS_IN_TILE, CAS_IN_TILE), m.tile_x0,
        m.tile_y0, m.centres, oob="zero", stage="list",
        staged=m.tile_inside, stage_quads=False, group=(TILE, TILE),
        tap_x=np.clip(m.col_i[0], 0, W - 1),
        tap_y=np.clip(m.row_i[0], 0, H - 1),
        quad_x=m.col_i[[1, 1]], quad_y=m.row_i[[1, 1]])
    geometry = word_geometry(geometry, texel_words(cb))
    work = launch_work(m.group_cls, (TILE, TILE), OH, OW, n_inside,
                       n_outside, (r0, r1))
    if band_range is not None:
        return band_fn("CAS upscale strip", B, (rows, W), input_padding(H, W),
                       reference, launch,
                       band_geometry(geometry, (r0, r1), base, rows), cb,
                       precision, band_range, base, r1 - r0, work)
    return kernel_fn("CAS upscale", B, (H, W), input_padding(H, W),
                     reference, launch, geometry, cb, precision, work)


def build_cas_sharpen(batch, h, w, *, sharpness, centres, debug=False,
                      max_color_delta=1.0, color_bits=8, precision="full"):
    """Build the CAS sharpen-only kernel for a fixed shape/config.

    Args:
      batch, h, w: static sizes (output = input size).
      sharpness: the [0,1] CAS slider (CasSetup, ffx_cas.h:391).
      centres: (B, 5) int array per batch entry (core.constants.
        centres_payload at the frame size).
      debug: out-of-radius tint 1-(0, .3, .3).
      max_color_delta: CasSetup's maxColorDelta (ffx_cas.h:379); 1 leaves
        the sharpened colour unclamped.
      color_bits: 8 (RGBA8) or 10 (R10G10B10A2 passthrough).
      precision: "full" (f32) or "half" (CasFilter in bf16, op by op as
        the JAX kernel's precision="half").

    Returns fn(img) with the RCAS sharpen-only kernel's contract (kernels/
    rcas.py::build_rcas_sharpen).
    """
    dt = working_type(precision)
    B, H, W = int(batch), int(h), int(w)
    tables = DeviceTables(sharpen_maps(B, H, W, centres, (TILE, TILE)))
    sharp = cas_setup(sharpness)
    mcd = F32(max_color_delta)
    tint = debug_tint(debug)
    cb = int(color_bits)
    # the scalar arguments in the kernel's types, once: a call converts none
    sharp_k, mcd_k, tint_k = lit(sharp, dt), lit(mcd, dt), float(tint)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return cas_sharpen_reference(img[:, :H, :W],
                                     tables.on(img.device).centres, sharp,
                                     mcd, tint, cb, precision)

    launch = class_launch(
        "cas_sharpen", tables, (B, H, W),
        lambda d: (*pointers(d, "group_cls"), *tile_lists(d), B, H, W),
        (sharp_k, mcd_k, tint_k, SHARPEN_TILE, CAS_SHARPEN_IN_TILE), cb,
        precision)
    # an inside tile stages its 34x34 window, 0 outside the image; the
    # outside tiles copy their texels (so does a run of an outside group in
    # an inside tile, from device memory: not counted, the floor stays below)
    m = tables.host
    n_inside, n_outside = len(m.inside_tiles), len(m.outside_tiles)
    return kernel_fn("CAS sharpen", B, (H, W), input_padding(H, W),
                     reference, launch, word_geometry(
                         sharpen_geometry(H, W, SHARPEN_TILE, 1, m.centres,
                                          "zero", staged=m.tile_inside,
                                          group=(TILE, TILE)),
                         texel_words(cb)), cb, precision,
                     launch_work(m.group_cls, (TILE, TILE), H, W, n_inside,
                                 n_outside))
