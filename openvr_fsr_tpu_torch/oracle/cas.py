"""NumPy oracle for FFX CAS sharpen-only (the vestigial third kernel).

Port of CasSetup + CasFilter(noScaling=true) from reference
src/cas/ffx_cas.h:375-395, 430-552 with the build flags the fork's old CAS
releases shipped (src/cas/cas.sharpen.hlsl:1-2): CAS_SHARPEN_ONLY=1,
CAS_BETTER_DIAGONALS=1, fast approximations (no CAS_GO_SLOWER), green-coef
weights (no CAS_SLOW). CasLoad is Texture2D.Load, so out-of-bounds taps read
zero (cas.compute.h:14-16); CasInput is identity (no linearization) and the
wrapper stores float4(rgb, 1) (cas.compute.h:36-48). The current reference
build omits CAS (absent from src/CMakeLists.txt:58-90) — its sharpen-only
config maps to renderScale 1.0 + RCAS — so this exists for parity with the
older releases README.md:135 cites.
"""

import numpy as np

from .intrinsics import (F32, f32, rcp, sat, lerp, min3, max3,
                         aprx_lo_rcp, aprx_lo_sqrt, aprx_med_rcp, clamp)

__all__ = ["cas_setup", "cas_sharpen_oracle", "cas_upscale_oracle",
           "cas_support_scaling", "CAS_AREA_LIMIT"]

CAS_AREA_LIMIT = 4.0  # ffx_cas.h:368


def cas_support_scaling(out_w, out_h, in_w, in_h):
    """CasSupportScaling (ffx_cas.h:372): out area <= 4x in area."""
    return (F32(out_w) * F32(out_h)) * rcp(F32(in_w) * F32(in_h)) \
        <= F32(CAS_AREA_LIMIT)


def cas_setup(sharpness):
    """CasSetup sharpness term (ffx_cas.h:391): -1/lerp(8, 5, sat(s))."""
    return -rcp(lerp(F32(8.0), F32(5.0), sat(f32(sharpness))))


def cas_sharpen_oracle(img, sharpness, max_color_delta=1.0):
    """img: (H, W, 3) f32 in [0,1]. Returns the sharpened (H, W, 3) f32."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    sharp = cas_setup(sharpness)
    mcd = f32(max_color_delta)

    pad = np.zeros((h + 2, w + 2, 3), np.float32)  # Load() OOB -> zero
    pad[1:-1, 1:-1] = img

    def tap(dy, dx):
        return pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    a, b, c = tap(-1, -1), tap(-1, 0), tap(-1, 1)
    d, e, f = tap(0, -1), tap(0, 0), tap(0, 1)
    g, hh, i = tap(1, -1), tap(1, 0), tap(1, 1)

    mn = np.minimum(min3(d, e, f), np.minimum(b, hh))
    mn2 = np.minimum(min3(mn, a, c), np.minimum(g, i))
    mn = mn + mn2                                   # CAS_BETTER_DIAGONALS
    mx = np.maximum(max3(d, e, f), np.maximum(b, hh))
    mx2 = np.maximum(max3(mx, a, c), np.maximum(g, i))
    mx = mx + mx2

    rcp_m = aprx_lo_rcp(mx)
    amp = sat(np.minimum(mn, F32(2.0) - mx) * rcp_m)
    amp = aprx_lo_sqrt(amp)
    wgt = amp * sharp                               # per-channel, then green
    w_g = wgt[..., 1:2]                             # green coef only
    rcp_weight = aprx_med_rcp(F32(1.0) + F32(4.0) * w_g)
    pix = sat((b * w_g + d * w_g + f * w_g + hh * w_g + e) * rcp_weight)
    return clamp(pix, e - mcd, e + mcd)


def cas_upscale_index_maps(in_n, out_n):
    """Per-axis scaling maps (ffx_cas.h:385-388, 568-571):
    pp = ip*(in/out) + (0.5*in/out - 0.5); returns (floor int32, frac f32)."""
    scale = f32(in_n) * rcp(f32(out_n))
    off = F32(0.5) * f32(in_n) * rcp(f32(out_n)) - F32(0.5)
    pp = (np.arange(out_n, dtype=np.float32) * scale + off).astype(np.float32)
    fp = np.floor(pp)
    return fp.astype(np.int64), (pp - fp).astype(np.float32)


def cas_upscale_oracle(img, sharpness, out_w, out_h):
    """CasFilter noScaling=false — the 4x-area-limited upscale path.

    Port of reference src/cas/ffx_cas.h:552-892 with the flags of the mod's
    upscale shader (src/cas/cas.upscale.hlsl: CAS_SHARPEN_ONLY=0 and, unlike
    the sharpen shader, *no* CAS_BETTER_DIAGONALS), fast approximations (no
    CAS_GO_SLOWER) and green-coefficient weighting (no CAS_SLOW). The four
    3x3 soft min/max neighborhoods therefore use the 5-tap cross only and
    amp = sat(min(mn, 1-mx) * rcpM) (ffx_cas.h:749-760). The scaling path
    applies no maxColorDelta clamp (ffx_cas.h:876-878 ends at ASat).

    img: (H, W, 3) f32 in [0,1]. Returns (out_h, out_w, 3) f32.
    """
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    sharp = cas_setup(sharpness)

    fx, ppx = cas_upscale_index_maps(w, out_w)
    fy, ppy = cas_upscale_index_maps(h, out_h)
    ppx = ppx[None, :, None]
    ppy = ppy[:, None, None]

    pad = np.zeros((h + 4, w + 4, 3), np.float32)  # CasLoad OOB -> zero
    pad[1:1 + h, 1:1 + w] = img

    def tap(dx, dy):  # (out_h, out_w, 3), offsets relative to sp=floor(pp)
        return pad[np.clip(fy + dy + 1, 0, h + 3)][:,
                   np.clip(fx + dx + 1, 0, w + 3)]

    # 4x4 letters (ffx_cas.h:554-587): rows dy=-1..2 are abcd/efgh/ijkl/mnop
    a, b, c, d = tap(-1, -1), tap(0, -1), tap(1, -1), tap(2, -1)
    e, f, g, hh = tap(-1, 0), tap(0, 0), tap(1, 0), tap(2, 0)
    i, j, k, ll = tap(-1, 1), tap(0, 1), tap(1, 1), tap(2, 1)
    m, n, o, p = tap(-1, 2), tap(0, 2), tap(1, 2), tap(2, 2)

    def soft(up, lf, ce, rt, dn):
        """5-tap cross soft min/max (green channel only is consumed)."""
        mn = min3(min3(up, lf, ce), rt, dn)
        mx = max3(max3(up, lf, ce), rt, dn)
        return mn, mx

    mnf, mxf = soft(b, e, f, g, j)
    mng, mxg = soft(c, f, g, hh, k)
    mnj, mxj = soft(f, i, j, k, n)
    mnk, mxk = soft(g, j, k, ll, o)

    def weight(mn, mx):
        amp = sat(np.minimum(mn, F32(1.0) - mx) * aprx_lo_rcp(mx))
        return aprx_lo_sqrt(amp) * sharp

    wf, wg = weight(mnf, mxf), weight(mng, mxg)
    wj, wk = weight(mnj, mxj), weight(mnk, mxk)

    s = (F32(1.0) - ppx) * (F32(1.0) - ppy)
    t = ppx * (F32(1.0) - ppy)
    u = (F32(1.0) - ppx) * ppy
    v = ppx * ppy
    thin = F32(1.0 / 32.0)
    s = s * aprx_lo_rcp(thin + (mxf[..., 1:2] - mnf[..., 1:2]))
    t = t * aprx_lo_rcp(thin + (mxg[..., 1:2] - mng[..., 1:2]))
    u = u * aprx_lo_rcp(thin + (mxj[..., 1:2] - mnj[..., 1:2]))
    v = v * aprx_lo_rcp(thin + (mxk[..., 1:2] - mnk[..., 1:2]))

    wfG, wgG = wf[..., 1:2], wg[..., 1:2]
    wjG, wkG = wj[..., 1:2], wk[..., 1:2]
    qbe = wfG * s
    qch = wgG * t
    qf = wgG * t + wjG * u + s
    qg = wfG * s + wkG * v + t
    qj = wfG * s + wkG * v + u
    qk = wgG * t + wjG * u + v
    qin = wjG * u
    qlo = wkG * v
    rcp_w = aprx_med_rcp(F32(2.0) * qbe + F32(2.0) * qch + F32(2.0) * qin
                         + F32(2.0) * qlo + qf + qg + qj + qk)
    return sat((b * qbe + e * qbe + c * qch + hh * qch + i * qin + n * qin
                + ll * qlo + o * qlo + f * qf + g * qg + j * qj + k * qk)
               * rcp_w)
