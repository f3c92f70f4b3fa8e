"""Bilinear sampling (linear-clamp sampler semantics) + the foveated
out-of-radius fallbacks of the reference shaders.

- FSR EASU fallback:  c = Sample(pos / (outW,outH)).rgb, alpha=1
  (src/fsr/fsr_easu.hlsl:33-36 — note: integer pos, *no* half-texel offset)
- NIS upscale fallback: same coordinates, multiplied by the debug tint
  (src/nis/NIS_Upscale.hlsl:77-90)

Exact GPU samplers quantize the interpolation fraction to >=8 bits; this
oracle (and the TPU path) use exact f32 weights — agreement with real D3D11
hardware is within 1 LSB of UNORM8, and the oracle is the parity reference.
"""

import numpy as np

from .intrinsics import F32

__all__ = ["bilinear_sample", "bilinear_fallback_fsr", "debug_tint_mul"]


def bilinear_sample(img, u, v):
    """SampleLevel(linear-clamp, (u,v), 0) for normalized coords u,v
    (broadcastable arrays). img: (H, W, C). Returns (..., C) float32."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    tx = np.asarray(u, np.float32) * F32(w) - F32(0.5)
    ty = np.asarray(v, np.float32) * F32(h) - F32(0.5)
    x0 = np.floor(tx)
    y0 = np.floor(ty)
    fx = (tx - x0).astype(np.float32)
    fy = (ty - y0).astype(np.float32)
    x0i = x0.astype(np.int64)
    y0i = y0.astype(np.int64)
    x0c = np.clip(x0i, 0, w - 1)
    x1c = np.clip(x0i + 1, 0, w - 1)
    y0c = np.clip(y0i, 0, h - 1)
    y1c = np.clip(y0i + 1, 0, h - 1)
    c00 = img[y0c, x0c]
    c10 = img[y0c, x1c]
    c01 = img[y1c, x0c]
    c11 = img[y1c, x1c]
    fx = fx[..., None]
    fy = fy[..., None]
    one = F32(1.0)
    top = c00 * (one - fx) + c10 * fx
    bot = c01 * (one - fx) + c11 * fx
    return top * (one - fy) + bot * fy


def bilinear_fallback_fsr(img, out_w, out_h):
    """The EASU shader's Bilinear(pos): sample at pos/(outW,outH) — integer
    pixel position divided by output size (fsr_easu.hlsl:33-36)."""
    xs = np.arange(out_w, dtype=np.float32)
    ys = np.arange(out_h, dtype=np.float32)
    u = (xs / F32(out_w))[None, :] * np.ones((out_h, 1), np.float32)
    v = (ys / F32(out_h))[:, None] * np.ones((1, out_w), np.float32)
    return bilinear_sample(img[..., :3], u, v)


def debug_tint_mul(debug):
    """float4(1,1,1,1) - debug*float4(0,0.3,0.3,0) — the out-of-radius tint
    (fsr_rcas.hlsl:46, NIS DirectCopy)."""
    d = F32(1.0) if debug else F32(0.0)
    return np.array([1.0, 1.0 - 0.3 * d, 1.0 - 0.3 * d, 1.0], np.float32)
