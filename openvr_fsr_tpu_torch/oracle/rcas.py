"""NumPy golden reference for FSR1 RCAS (Robust Contrast-Adaptive Sharpen).

Literal float32 port of FsrRcasF (reference src/fsr/ffx_fsr1.h:684-769).

The wrapper loads taps with Texture2D.Load (src/fsr/fsr_rcas.hlsl:18), which
returns ZERO for out-of-bounds coordinates (D3D11 Load semantics) — so the
border ring sees zero-padded neighbors, not clamped ones. The flat-region
limiter math divides by zero producing NaN/Inf that HLSL min/max swallow
(see intrinsics.hlsl_min/hlsl_max).
"""

import numpy as np

from .intrinsics import (
    F32,
    aprx_med_rcp,
    rcp,
    hlsl_min,
    hlsl_max,
    min3,
    max3,
    sat,
)
from ..core.constants import RCAS_LIMIT

__all__ = ["rcas_oracle"]


def _shift_zero_pad(img, dx, dy):
    """img[y+dy, x+dx] with zeros outside (D3D11 Load OOB -> 0)."""
    h, w = img.shape[:2]
    out = np.zeros_like(img)
    ys0, ys1 = max(0, dy), min(h, h + dy)
    xs0, xs1 = max(0, dx), min(w, w + dx)
    out[ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx] = img[ys0:ys1, xs0:xs1]
    return out


def rcas_oracle(img, sharpness_linear, denoise=False):
    """RCAS sharpen (no scaling).

    img: (H, W, C>=3) float32 — in the reference pipeline this is the
         *quantized* (UNORM8/10) output of the EASU pass re-decoded to float.
    sharpness_linear: exp2(-stops) from fsr_rcas_con (con.x).
    Returns (H, W, 3) float32.
    """
    img = np.asarray(img, np.float32)[..., :3]
    sharp = F32(sharpness_linear)

    e = img
    b = _shift_zero_pad(img, 0, -1)
    d = _shift_zero_pad(img, -1, 0)
    f = _shift_zero_pad(img, 1, 0)
    h = _shift_zero_pad(img, 0, 1)

    bR, bG, bB = b[..., 0], b[..., 1], b[..., 2]
    dR, dG, dB = d[..., 0], d[..., 1], d[..., 2]
    eR, eG, eB = e[..., 0], e[..., 1], e[..., 2]
    fR, fG, fB = f[..., 0], f[..., 1], f[..., 2]
    hR, hG, hB = h[..., 0], h[..., 1], h[..., 2]

    # Min/max of the cross ring (no NaN possible here — plain min/max).
    mn4R = np.minimum(min3(bR, dR, fR), hR)
    mn4G = np.minimum(min3(bG, dG, fG), hG)
    mn4B = np.minimum(min3(bB, dB, fB), hB)
    mx4R = np.maximum(max3(bR, dR, fR), hR)
    mx4G = np.maximum(max3(bG, dG, fG), hG)
    mx4B = np.maximum(max3(bB, dB, fB), hB)

    peak_x, peak_y = F32(1.0), F32(-4.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        hitMinR = mn4R * rcp(F32(4.0) * mx4R)
        hitMinG = mn4G * rcp(F32(4.0) * mx4G)
        hitMinB = mn4B * rcp(F32(4.0) * mx4B)
        hitMaxR = (peak_x - mx4R) * rcp(F32(4.0) * mn4R + peak_y)
        hitMaxG = (peak_x - mx4G) * rcp(F32(4.0) * mn4G + peak_y)
        hitMaxB = (peak_x - mx4B) * rcp(F32(4.0) * mn4B + peak_y)
    lobeR = hlsl_max(-hitMinR, hitMaxR)
    lobeG = hlsl_max(-hitMinG, hitMaxG)
    lobeB = hlsl_max(-hitMinB, hitMaxB)
    lobe = hlsl_max(
        F32(-RCAS_LIMIT) * np.ones_like(lobeR),
        hlsl_min(max3(lobeR, lobeG, lobeB), np.zeros_like(lobeR)),
    ) * sharp

    if denoise:  # FSR_RCAS_DENOISE — compiled out in the reference shaders
        bL = bB * F32(0.5) + (bR * F32(0.5) + bG)
        dL = dB * F32(0.5) + (dR * F32(0.5) + dG)
        eL = eB * F32(0.5) + (eR * F32(0.5) + eG)
        fL = fB * F32(0.5) + (fR * F32(0.5) + fG)
        hL = hB * F32(0.5) + (hR * F32(0.5) + hG)
        nz = F32(0.25) * bL + F32(0.25) * dL + F32(0.25) * fL + F32(0.25) * hL - eL
        rng = max3(max3(bL, dL, eL), fL, hL) - min3(min3(bL, dL, eL), fL, hL)
        nz = sat(np.abs(nz) * aprx_med_rcp(rng))
        nz = F32(-0.5) * nz + F32(1.0)
        lobe = lobe * nz

    rcpL = aprx_med_rcp(F32(4.0) * lobe + F32(1.0))
    pixR = (lobe * bR + lobe * dR + lobe * hR + lobe * fR + eR) * rcpL
    pixG = (lobe * bG + lobe * dG + lobe * hG + lobe * fG + eG) * rcpL
    pixB = (lobe * bB + lobe * dB + lobe * hB + lobe * fB + eB) * rcpL
    return np.stack([pixR, pixG, pixB], axis=-1)
