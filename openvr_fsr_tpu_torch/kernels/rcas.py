"""The RCAS sharpen-only kernel (renderScale 1): build, launch, and its plain
version.

`build_rcas_sharpen` is the port of the JAX package's kernels/rcas.py::
build_rcas_sharpen, on RGBA8 (color_bits 8, packed u32 planes) and
R10G10B10A2 (color_bits 10, (B, H, W, 4) uint16 frames) texels. The reference runs only the
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
tensor. Nothing falls back. precision="half" runs RCAS in bf16 as the JAX
kernel's precision="half" does (ops/rcas.py at dt=bf16), through the half
instantiation of the inside kernel (rcas_sharpen_launch_h, _launch10_h);
the copy outside the circle is the same.
"""

import torch

from ..core import constants as C
from ..core.foveation import TILE_FSR
from ..ops.common import lit
from ..ops.rcas import rcas
from ._common import (DeviceTables, circle_mask, class_launch, debug_tint,
                      kernel_fn, pack, pointers, texel_words, tile_lists,
                      tint_vector, unpack, working_type)
from ._maps import (CAS_SHARPEN_IN_TILE, SHARPEN_TILE, TILE, input_padding,
                    launch_work, sharpen_geometry, sharpen_maps,
                    word_geometry)

__all__ = ["build_rcas_sharpen", "rcas_sharpen_reference"]


def rcas_sharpen_reference(img, centres, sharpness_linear, tint,
                           color_bits=8, precision="full"):
    """The kernel's computation in plain torch, on img's device.

    img: (B, H, W) int32 packed RGBA8, or at color_bits 10 (B, H, W, 4)
    uint16 R10G10B10A2 (H, W: the frame; a pre-padded one is cropped by the
    caller); centres: (B, 5) int64 on img's device; sharpness_linear: RCAS
    con.x; tint: the out-of-circle G/B multiplier; precision: "full", or
    "half" for RCAS in bf16. Returns a frame of img's shape and format."""
    rgba = unpack(img, 4, color_bits)
    rgb, alpha = rgba[:, :3], rgba[:, 3]
    inside = circle_mask(centres, img.shape[1], img.shape[2], TILE_FSR)
    sharp = rcas(rgb, sharpness_linear, working_type(precision))
    out_rgb = torch.where(inside[:, None], sharp,
                          rgb * tint_vector(tint, img.device))
    return pack(out_rgb, torch.where(inside, 1.0, alpha), color_bits)


def build_rcas_sharpen(batch, h, w, *, sharpness, centres, debug=False,
                       color_bits=8, precision="full"):
    """Build the sharpen-only RCAS kernel for a fixed shape/config.

    Args:
      batch, h, w: static sizes (output = input size).
      sharpness: the [0,1] config slider (PostProcessor.cpp:420-421 mapping).
      centres: (B, 5) int array per batch entry: cx1, cy1, cx2, cy2,
        radius_sq (core.constants.centres_payload at the frame size).
      debug: out-of-radius tint 1-(0, .3, .3) (fsr_rcas.hlsl:46).
      color_bits: 8 (RGBA8) or 10 (R10G10B10A2 passthrough).
      precision: "full" (f32) or "half" (RCAS in bf16, op by op as the JAX
        kernel's precision="half").

    Returns fn(img): img is a contiguous (B, h, w) int32 tensor, or one
    pre-padded to the ring pitch fn.pad_to, of packed RGBA8 texels; the
    result is a new (B, h, w) int32 tensor of packed RGBA8 on img's device.
    At color_bits 10 img is a (B, h, w, 4) uint16 tensor (or pre-padded the
    same way) and the result a (B, h, w, 4) uint16 one.
    fn.launches counts calls that launched the CUDA kernels (one per call:
    the copy pass and the inside kernel, each only where its tile list is
    not empty); fn.reference(img) runs the plain version on img's device;
    fn.dma_geometry is what the kernels load and store (kernels/sol.py).
    """
    dt = working_type(precision)
    B, H, W = int(batch), int(h), int(w)
    tables = DeviceTables(sharpen_maps(B, H, W, centres, (TILE, TILE)))
    sharp = C.fsr_rcas_con(C.rcas_stops_from_slider(sharpness))
    tint = debug_tint(debug)
    cb = int(color_bits)
    # the scalar arguments in the kernel's types, once: a call converts none
    sharp_k, tint_k = lit(sharp, dt), float(tint)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return rcas_sharpen_reference(img[:, :H, :W],
                                      tables.on(img.device).centres, sharp,
                                      tint, cb, precision)

    launch = class_launch(
        "rcas_sharpen", tables, (B, H, W),
        lambda d: (*pointers(d, "group_cls"), *tile_lists(d), B, H, W),
        (sharp_k, tint_k, SHARPEN_TILE, CAS_SHARPEN_IN_TILE), cb, precision)
    # an inside tile stages its 34x34 window, 0 outside the image; the
    # outside tiles copy their texels (so does a run of an outside group in
    # an inside tile, from device memory: not counted, the floor stays below)
    m = tables.host
    n_inside, n_outside = len(m.inside_tiles), len(m.outside_tiles)
    work = launch_work(m.group_cls, (TILE, TILE), H, W, n_inside, n_outside)
    # the inside outputs computed on the texels' 256 levels: RGBA8 at full
    # precision (csrc/rcas_sharpen.cu, the inside kernel's RGBA8
    # specialization)
    work["levels"] = work["inside"] if (cb, precision) == (8, "full") else 0
    return kernel_fn("RCAS sharpen", B, (H, W), input_padding(H, W),
                     reference, launch, word_geometry(
                         sharpen_geometry(H, W, SHARPEN_TILE, 1, m.centres,
                                          "zero", staged=m.tile_inside,
                                          group=(TILE, TILE)),
                         texel_words(cb)), cb, precision, work)
