"""Bilinear sampling in torch with static separable index/weight maps.

Implements the linear-clamp sampler of the out-of-radius fallbacks
(src/fsr/fsr_easu.hlsl:33-36, src/nis/NIS_Upscale.hlsl:77-90) and of the
NIS RGBA tap (NIS_Scaler.h:747). Coordinates are axis-separable, so the
gather is two index_selects and the weights are per-axis vectors.
"""

import numpy as np
import torch

from .common import F32

__all__ = ["bilinear_axis", "bilinear_texel_axis", "bilinear_gather",
           "bilinear_sample", "bilinear_fallback_fsr"]


def bilinear_texel_axis(u, in_n):
    """Floor indices (int32) and f32 fractions of the texel coordinates
    t = u*in_n - 0.5 (f32) of normalized coordinates u (numpy, 1-D)."""
    t = np.asarray(u, np.float32) * F32(in_n) - F32(0.5)
    i0 = np.floor(t)
    return i0.astype(np.int32), (t - i0).astype(np.float32)


def bilinear_axis(out_n, in_n):
    """Floor indices (int32) and f32 fractions of the fallback's texel
    coordinates t = (i / out_n) * in_n - 0.5 for i in [0, out_n)
    (fsr_easu.hlsl:34; the JAX package's kernels/fsr.py::_bilinear_axis)."""
    return bilinear_texel_axis(
        np.arange(out_n, dtype=np.float32) / F32(out_n), in_n)


def bilinear_sample(rgba, u_axis, v_axis):
    """SampleLevel(linear-clamp) at normalized coordinates: rgba (..., C, H,
    W); u_axis (Wo,) / v_axis (Ho,) numpy f32 per output column / row.
    Texel space t = u*W - 0.5 in f32, corners clamped to the edge (the JAX
    package's ops/bilinear.py::bilinear_sample_jax). Returns (..., C, Ho,
    Wo)."""
    h, w = rgba.shape[-2:]
    x0, fx = bilinear_texel_axis(u_axis, w)
    y0, fy = bilinear_texel_axis(v_axis, h)
    dev = rgba.device
    return bilinear_gather(rgba, torch.from_numpy(x0).to(dev),
                           torch.from_numpy(fx).to(dev),
                           torch.from_numpy(y0).to(dev),
                           torch.from_numpy(fy).to(dev))


def bilinear_gather(rgb, x0, fx, y0, fy):
    """rgb: (..., C, H, W). x0/fx: (Wo,) floor index (any int dtype) and
    fraction per output column; y0/fy the same per output row. Corners clamp
    to the edge. Returns (..., C, Ho, Wo) with the lerp form
    c00*(1-fx) + c10*fx, then the same in y (ops/bilinear.py:51-53)."""
    h, w = rgb.shape[-2:]
    x0 = x0.long()
    y0 = y0.long()
    x0c, x1c = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    y0c, y1c = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    rows0 = rgb.index_select(-2, y0c)
    rows1 = rgb.index_select(-2, y1c)
    c00, c10 = rows0.index_select(-1, x0c), rows0.index_select(-1, x1c)
    c01, c11 = rows1.index_select(-1, x0c), rows1.index_select(-1, x1c)
    fx = fx[None, :]
    fy = fy[:, None]
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def bilinear_fallback_fsr(rgb, out_w, out_h):
    """The EASU out-of-radius fallback: sample at (x/outW, y/outH) — integer
    pixel over output size, no half-texel offset (fsr_easu.hlsl:34).
    rgb: (..., 3, H, W) f32. Returns (..., 3, out_h, out_w)."""
    h, w = rgb.shape[-2:]
    x0, fx = bilinear_axis(out_w, w)
    y0, fy = bilinear_axis(out_h, h)
    dev = rgb.device
    return bilinear_gather(rgb, torch.from_numpy(x0).to(dev),
                           torch.from_numpy(fx).to(dev),
                           torch.from_numpy(y0).to(dev),
                           torch.from_numpy(fy).to(dev))
