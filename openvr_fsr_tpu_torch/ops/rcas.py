"""RCAS in torch: planar (..., 3, H, W), zero-padded shifts.

Line-faithful port of FsrRcasF (reference src/fsr/ffx_fsr1.h:684-769). The
reference wrapper loads taps with Texture2D.Load whose out-of-bounds reads
return zero (src/fsr/fsr_rcas.hlsl:18), reproduced by zero padding. Flat
regions divide by zero; the HLSL min/max selects swallow the NaNs, while
min3/max3 propagate them (torch.minimum/maximum, like jnp).
"""

import torch
import torch.nn.functional as F

from ..core.constants import RCAS_LIMIT
from .common import (aprx_med_rcp, lit, rcp, hlsl_min, hlsl_max, min3, max3,
                     via_f32)

__all__ = ["rcas", "rcas_core", "shift_zero"]


def shift_zero(rgb, dx, dy):
    """rgb[..., y+dy, x+dx] with zeros outside."""
    h, w = rgb.shape[-2:]
    padded = F.pad(rgb, (1, 1, 1, 1))
    return padded[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def rcas(rgb, sharpness_linear, dt=torch.float32):
    """rgb: (..., 3, H, W) f32 (the quantized upscale output in the full
    pipeline). sharpness_linear: f32 scalar = exp2(-stops); dt: the working
    type (rcas_core). Returns (..., 3, H, W) f32."""
    return rcas_core(shift_zero(rgb, 0, -1), shift_zero(rgb, -1, 0), rgb,
                     shift_zero(rgb, 1, 0), shift_zero(rgb, 0, 1),
                     sharpness_linear, dt).float()


def rcas_core(b, d, e, f, h, sharpness_linear, dt=torch.float32):
    """FsrRcasF (ffx_fsr1.h:684-769) given the 5 cross taps as (..., 3, H, W)
    tensors (b=up, d=left, e=centre, f=right, h=down; out-of-image taps must
    already be zero). dt: the working type, f32, or bf16 for
    precision="half" (the JAX package's rcas_core at dt=bfloat16: taps and
    sharpness rounded to bf16, every op in bf16 but rcp and
    aprx_med_rcp, which run through f32). Returns the result in dt."""
    b, d, e, f, h = (x.to(dt) for x in (b, d, e, f, h))
    rcp_, med_rcp = via_f32(rcp, dt), via_f32(aprx_med_rcp, dt)
    mn4 = torch.minimum(min3(b, d, f), h)
    mx4 = torch.maximum(max3(b, d, f), h)
    hit_min = mn4 * rcp_(4.0 * mx4)
    hit_max = (1.0 - mx4) * rcp_(4.0 * mn4 + -4.0)
    lobe_rgb = hlsl_max(-hit_min, hit_max)
    r, g, bl = lobe_rgb.unbind(-3)
    m = max3(r, g, bl)
    lobe = hlsl_max(torch.full_like(m, -float(RCAS_LIMIT)),
                    hlsl_min(m, torch.zeros_like(m))) * lit(sharpness_linear,
                                                            dt)
    lobe = lobe.unsqueeze(-3)
    rcp_l = med_rcp(4.0 * lobe + 1.0)
    return (lobe * b + lobe * d + lobe * h + lobe * f + e) * rcp_l
