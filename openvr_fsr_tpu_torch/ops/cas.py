"""FFX CAS in torch: planar (..., 3, H, W), op for op the NumPy oracle
(openvr_fsr_tpu/oracle/cas.py).

CasSetup and CasFilter (reference src/cas/ffx_cas.h:375-395, 430-892) with
the flags of the mod's old CAS shaders: fast approximations (no
CAS_GO_SLOWER), green-coefficient weights (no CAS_SLOW); the sharpen-only
path with CAS_BETTER_DIAGONALS and the maxColorDelta clamp
(cas.sharpen.hlsl), the scaling path without either (cas.upscale.hlsl,
ffx_cas.h:876-878). CasLoad is Texture2D.Load, so out-of-image taps read
zero (cas.compute.h:14-16).

The setup constant follows the oracle's form -rcp(lerp(8, 5, sat(s))) with
ffx_a.h's ALerpF1 = b*c + (-a*c + a). The JAX op (openvr_fsr_tpu/ops/cas.py::
cas_setup_sharp) computes -1 * rcp(8 + s*(5-8)), which differs by 1 ulp at
14 of the 101 slider values 0.00..1.00.

The cores take the working type dt: f32, or bf16 for precision="half",
the JAX package's dt=bfloat16 (taps, fractions and constants rounded to
bf16, every op in bf16 but the ffx_a.h approximations, which run through
f32: via_f32). Keep these eager (torch.compile may contract mul+add).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..f32util import f32, rcp as rcp_np
from .common import (F32, aprx_lo_rcp, aprx_lo_sqrt, aprx_med_rcp, lit, max3,
                     min3, sat, strip_rows, via_f32)
from .rcas import shift_zero

__all__ = ["CAS_AREA_LIMIT", "CAS_USED_TAPS", "cas_support_scaling",
           "cas_setup", "cas_upscale_index_maps", "cas_core",
           "cas_upscale_core", "cas_upscale_gather", "cas_sharpen_taps",
           "cas_sharpen", "cas_upscale"]

CAS_AREA_LIMIT = 4.0   # ffx_cas.h:368
# the 12 taps of the 4x4 window the scaling path reads (ffx_cas.h:573-587),
# keyed (dx, dy) relative to floor(pp): the window minus its corners
CAS_USED_TAPS = tuple((dx, dy) for dy in (-1, 0, 1, 2)
                      for dx in (-1, 0, 1, 2)
                      if not (dx in (-1, 2) and dy in (-1, 2)))


def cas_support_scaling(out_w, out_h, in_w, in_h):
    """CasSupportScaling (ffx_cas.h:372): out area <= 4x in area."""
    return bool((F32(out_w) * F32(out_h)) * rcp_np(F32(in_w) * F32(in_h))
                <= F32(CAS_AREA_LIMIT))


def cas_setup(sharpness):
    """CasSetup sharpness term (ffx_cas.h:391): -rcp(lerp(8, 5, sat(s))) in
    f32 on the host, with ALerpF1's b*c + (-a*c + a)."""
    s = np.minimum(F32(1.0), np.maximum(F32(0.0), f32(sharpness)))
    a, b = F32(8.0), F32(5.0)
    return F32(-rcp_np(b * s + (-(a * s) + a)))


def cas_upscale_index_maps(in_n, out_n):
    """Per-axis scaling maps (ffx_cas.h:385-388, 568-571): pp = ip*(in/out)
    + (0.5*in/out - 0.5) in f32; returns (floor int64, fraction f32)."""
    scale = F32(in_n) * rcp_np(F32(out_n))
    off = F32(0.5) * F32(in_n) * rcp_np(F32(out_n)) - F32(0.5)
    pp = (np.arange(out_n).astype(np.float32) * scale + off).astype(np.float32)
    fp = np.floor(pp)
    return fp.astype(np.int64), (pp - fp).astype(np.float32)


def cas_core(taps, sharp, max_color_delta, dt=torch.float32):
    """CasFilter noScaling (ffx_cas.h:430-552) with CAS_BETTER_DIAGONALS,
    green-coefficient weights and the maxColorDelta clamp. taps: dict
    (dy, dx) -> (..., 3, H, W), out-of-image taps already zero; sharp: the
    cas_setup constant; dt: the working type. Returns (..., 3, H, W) in
    dt."""
    taps = {k: v.to(dt) for k, v in taps.items()}
    lo_sqrt, lo_rcp, med_rcp = (via_f32(f, dt) for f in (
        aprx_lo_sqrt, aprx_lo_rcp, aprx_med_rcp))
    a, b, c = taps[-1, -1], taps[-1, 0], taps[-1, 1]
    d, e, f = taps[0, -1], taps[0, 0], taps[0, 1]
    g, h, i = taps[1, -1], taps[1, 0], taps[1, 1]

    mn = torch.minimum(min3(d, e, f), torch.minimum(b, h))
    mn = mn + torch.minimum(min3(mn, a, c), torch.minimum(g, i))
    mx = torch.maximum(max3(d, e, f), torch.maximum(b, h))
    mx = mx + torch.maximum(max3(mx, a, c), torch.maximum(g, i))

    amp = lo_sqrt(sat(torch.minimum(mn, 2.0 - mx) * lo_rcp(mx)))
    w_g = (amp * lit(sharp, dt))[..., 1:2, :, :]     # green coefficient only
    rcp_weight = med_rcp(1.0 + 4.0 * w_g)
    pix = sat((b * w_g + d * w_g + f * w_g + h * w_g + e) * rcp_weight)
    mcd = lit(max_color_delta, dt)
    return torch.minimum(torch.maximum(pix, e - mcd), e + mcd)


def cas_upscale_core(taps, ppx, ppy, sharp, dt=torch.float32):
    """CasFilter scaling (ffx_cas.h:552-892) with the mod's upscale flags:
    no CAS_BETTER_DIAGONALS, no maxColorDelta clamp. taps: dict (dx, dy) ->
    (..., 3, h, w) over CAS_USED_TAPS; ppx / ppy: fractions broadcastable
    against (h, w); sharp: the cas_setup constant; dt: the working type.
    Returns (..., 3, h, w) in dt."""
    taps = {k: v.to(dt) for k, v in taps.items()}
    ppx, ppy = ppx.to(dt), ppy.to(dt)
    lo_sqrt, lo_rcp, med_rcp = (via_f32(f, dt) for f in (
        aprx_lo_sqrt, aprx_lo_rcp, aprx_med_rcp))
    sharp = lit(sharp, dt)
    b, c = taps[0, -1], taps[1, -1]
    e, f, g, h = taps[-1, 0], taps[0, 0], taps[1, 0], taps[2, 0]
    i, j, k, ll = taps[-1, 1], taps[0, 1], taps[1, 1], taps[2, 1]
    n, o = taps[0, 2], taps[1, 2]

    def soft_g(up, lf, ce, rt, dn):   # green-channel 5-tap soft min/max
        up, lf, ce, rt, dn = (x[..., 1, :, :] for x in (up, lf, ce, rt, dn))
        return (torch.minimum(min3(up, lf, ce), torch.minimum(rt, dn)),
                torch.maximum(max3(up, lf, ce), torch.maximum(rt, dn)))

    mnf, mxf = soft_g(b, e, f, g, j)
    mng, mxg = soft_g(c, f, g, h, k)
    mnj, mxj = soft_g(f, i, j, k, n)
    mnk, mxk = soft_g(g, j, k, ll, o)

    def weight(mn, mx):
        amp = lo_sqrt(sat(torch.minimum(mn, 1.0 - mx) * lo_rcp(mx)))
        return amp * sharp

    wf, wg = weight(mnf, mxf), weight(mng, mxg)
    wj, wk = weight(mnj, mxj), weight(mnk, mxk)

    s = (1.0 - ppx) * (1.0 - ppy)
    t = ppx * (1.0 - ppy)
    u = (1.0 - ppx) * ppy
    v = ppx * ppy
    thin = 1.0 / 32.0
    s = s * lo_rcp(thin + (mxf - mnf))
    t = t * lo_rcp(thin + (mxg - mng))
    u = u * lo_rcp(thin + (mxj - mnj))
    v = v * lo_rcp(thin + (mxk - mnk))

    qbe = wf * s
    qch = wg * t
    qf = wg * t + wj * u + s
    qg = wf * s + wk * v + t
    qj = wf * s + wk * v + u
    qk = wg * t + wj * u + v
    qin = wj * u
    qlo = wk * v
    rcp_w = med_rcp(2.0 * qbe + 2.0 * qch + 2.0 * qin + 2.0 * qlo
                    + qf + qg + qj + qk)
    qbe, qch, qf, qg, qj, qk, qin, qlo, rcp_w = (
        q.unsqueeze(-3) for q in (qbe, qch, qf, qg, qj, qk, qin, qlo, rcp_w))
    return sat((b * qbe + e * qbe + c * qch + h * qch + i * qin + n * qin
                + ll * qlo + o * qlo + f * qf + g * qg + j * qj + k * qk)
               * rcp_w)


def cas_upscale_gather(rgb, fx, fy, row_base=0, in_h=None):
    """The CAS_USED_TAPS of every output pixel: rgb (..., C, H, W); fx / fy
    the floor of pp per output column / row (any int dtype, on rgb's
    device). Taps outside the image read zero (CasLoad). Returns dict (dx,
    dy) -> (..., C, len(fy), len(fx)). rgb may be a row strip of an image
    of in_h rows that starts at the image's row row_base: a tap's row
    outside the image reads zero, one inside is rebased to the strip
    (strip_rows)."""
    h, w = rgb.shape[-2:]
    in_h = h if in_h is None else int(in_h)
    pad = F.pad(rgb, (1, 3, 1, 0))    # row 0: the zero row
    fx, fy = fx.long(), fy.long()

    def row(r):
        return torch.where((r >= 0) & (r < in_h),
                           strip_rows(r, h, row_base, in_h) + 1, 0)
    rows = {dy: pad.index_select(-2, row(fy + dy)) for dy in (-1, 0, 1, 2)}
    return {(dx, dy): rows[dy].index_select(-1, (fx + dx + 1).clamp(0, w + 3))
            for dx, dy in CAS_USED_TAPS}


def cas_upscale(rgb, sharpness, out_w, out_h):
    """rgb: (..., 3, H, W) f32 in [0, 1]. Returns (..., 3, out_h, out_w)."""
    h, w = rgb.shape[-2:]
    fx, ppx = cas_upscale_index_maps(w, out_w)
    fy, ppy = cas_upscale_index_maps(h, out_h)
    dev = rgb.device
    taps = cas_upscale_gather(rgb, torch.from_numpy(fx).to(dev),
                              torch.from_numpy(fy).to(dev))
    return cas_upscale_core(taps, torch.from_numpy(ppx).to(dev)[None, :],
                            torch.from_numpy(ppy).to(dev)[:, None],
                            cas_setup(sharpness))


def cas_sharpen_taps(rgb):
    """The 3x3 taps of cas_core, dict (dy, dx) -> (..., C, H, W), zero
    outside the image (CasLoad)."""
    return {(dy, dx): shift_zero(rgb, dx, dy)
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)}


def cas_sharpen(rgb, sharpness, max_color_delta=1.0):
    """rgb: (..., 3, H, W) f32 in [0, 1]. Returns the sharpened (..., 3, H,
    W)."""
    return cas_core(cas_sharpen_taps(rgb), cas_setup(sharpness),
                    max_color_delta)
