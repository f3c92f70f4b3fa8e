"""NumPy golden reference for NVIDIA Image Scaling (NVScaler + NVSharpen).

Literal float32 port of src/nis/NIS_Scaler.h (NIS_USE_HALF_PRECISION=0),
vectorized per output pixel. The reference mod ships the SDR build
(NIS_HDR_MODE=0, NIS_Upscale.hlsl:22-26 / NIS_Sharpen.hlsl:22-26); this
oracle also covers NIS_HDR_MODE_LINEAR/_PQ (NIS_Scaler.h:112-116, selected
via NisConfig.hdr_mode) for library parity with upstream NIS.

Cooperative shared-memory staging in the HLSL becomes direct indexed reads of
a clamped luma plane: shPixelsY[local] holds the linear-clamp-sampled luma at
absolute coords srcBlockStart+local-2 (NVScaler, NIS_Scaler.h:613-669) /
dstBlock+local-2 (NVSharpen, :886-906); the sample coordinates land exactly on
texel centres, so hardware (which quantizes the subtexel fraction) fetches the
texel — the oracle indexes the plane directly.

Luma convention: NVScaler's filter path works on luma scaled by
NIS_SCALE_FLOAT=255 (fp32 build); edge maps and NVSharpen use unscaled [0,1].
"""

import numpy as np

from .intrinsics import F32, sat, rcp, hlsl_lerp
from .bilinear import bilinear_sample
from ..core.constants import NisConfig
from ..core.nis_tables import COEF_SCALE, COEF_USM

__all__ = ["nvscaler_oracle", "nvsharpen_oracle", "get_y", "get_y_linear",
           "edge_map_plane", "KHDR_COMPRESSION"]

NIS_SCALE_FLOAT = F32(255.0)
KHDR_COMPRESSION = F32(0.282842712)  # kHDRCompressionFactor (NIS_Scaler.h:118)


def get_y_linear(rgb):
    """getYLinear (NIS_Scaler.h:171-174) — BT.709 luma."""
    rgb = np.asarray(rgb, np.float32)
    return (F32(0.2126) * rgb[..., 0] + F32(0.7152) * rgb[..., 1]
            + F32(0.0722) * rgb[..., 2])


def get_y(rgb, hdr_mode=0):
    """getY (NIS_Scaler.h:160-169): SDR BT.709; HDR linear =
    sqrt(luma)*kHDRCompressionFactor; HDR PQ = Rec.2020 luma weights."""
    rgb = np.asarray(rgb, np.float32)
    if hdr_mode == 2:   # NIS_HDR_MODE_PQ
        return (F32(0.262) * rgb[..., 0] + F32(0.678) * rgb[..., 1]
                + F32(0.0593) * rgb[..., 2])
    if hdr_mode == 1:   # NIS_HDR_MODE_LINEAR
        return np.sqrt(get_y_linear(rgb), dtype=np.float32) * KHDR_COMPRESSION
    return get_y_linear(rgb)


def _clamped_take(plane, ys, xs):
    h, w = plane.shape[:2]
    return plane.take(np.clip(ys, 0, h - 1), axis=0).take(np.clip(xs, 0, w - 1), axis=1)


def edge_map_plane(y_plane, cfg: NisConfig):
    """GetEdgeMap (NIS_Scaler.h:176-293) evaluated at every pixel of the
    clamp-extended luma plane. Returns (H, W, 4) weights (w0, w90, w45, w135)."""
    h, w = y_plane.shape
    ys = np.arange(h)
    xs = np.arange(w)

    def s(dy, dx):
        return _clamped_take(y_plane, ys + dy, xs + dx)

    p = {(i, j): s(i - 1, j - 1) for i in range(3) for j in range(3)}
    # Exact f32 accumulation order of the reference sums.
    g_0 = np.abs(p[0, 0] + p[0, 1] + p[0, 2] - p[2, 0] - p[2, 1] - p[2, 2])
    g_45 = np.abs(p[1, 0] + p[0, 0] + p[0, 1] - p[2, 1] - p[2, 2] - p[1, 2])
    g_90 = np.abs(p[0, 0] + p[1, 0] + p[2, 0] - p[0, 2] - p[1, 2] - p[2, 2])
    g_135 = np.abs(p[1, 0] + p[2, 0] + p[2, 1] - p[0, 1] - p[0, 2] - p[1, 2])
    return _edge_weights(g_0, g_45, g_90, g_135, cfg)


def _edge_weights(g_0, g_45, g_90, g_135, cfg):
    zero = np.zeros_like(g_0)
    one = F32(1.0)
    g_0_90_max = np.maximum(g_0, g_90)
    g_0_90_min = np.minimum(g_0, g_90)
    g_45_135_max = np.maximum(g_45, g_135)
    g_45_135_min = np.minimum(g_45, g_135)

    denom = g_0_90_max + g_45_135_max
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.divide(g_0_90_max, denom, dtype=np.float32)
    nonzero = denom != 0
    e_0_90 = np.where(nonzero, np.minimum(ratio, one), zero)
    e_45_135 = np.where(nonzero, one - e_0_90, zero)

    c1 = ((g_0_90_max > g_0_90_min * cfg.kDetectRatio)
          & (g_0_90_max > cfg.kDetectThres)
          & (g_0_90_max > g_45_135_min))
    is0 = g_0_90_max == g_0
    edge_0 = np.where(c1 & is0, one, zero)
    edge_90 = np.where(c1 & ~is0, one, zero)

    c2 = ((g_45_135_max > g_45_135_min * cfg.kDetectRatio)
          & (g_45_135_max > cfg.kDetectThres)
          & (g_45_135_max > g_0_90_min))
    is45 = g_45_135_max == g_45
    edge_45 = np.where(c2 & is45, one, zero)
    edge_135 = np.where(c2 & ~is45, one, zero)

    total = edge_0 + edge_90 + edge_45 + edge_135
    ge2 = total >= F32(2.0)
    ge1 = total >= F32(1.0)
    e0_is1 = edge_0 == one
    e45_is1 = edge_45 == one
    w0 = np.where(ge2, np.where(e0_is1, e_0_90, zero), np.where(ge1, edge_0, zero))
    w90 = np.where(ge2, np.where(e0_is1, zero, e_0_90), np.where(ge1, edge_90, zero))
    w45 = np.where(ge2, np.where(e45_is1, e_45_135, zero), np.where(ge1, edge_45, zero))
    w135 = np.where(ge2, np.where(e45_is1, zero, e_45_135), np.where(ge1, edge_135, zero))
    return np.stack([w0, w90, w45, w135], axis=-1).astype(np.float32, copy=False)


def _calc_lti(p6, phase_int, cfg):
    """CalcLTI (NIS_Scaler.h:343-375); p6 = list of 6 (H,W) scaled lumas."""
    lo = phase_int <= 32  # kPhaseCount/2
    y = [np.where(lo, p6[i], p6[i + 1]) for i in range(5)]
    a_min = np.minimum(np.minimum(y[0], y[1]), y[2])
    a_max = np.maximum(np.maximum(y[0], y[1]), y[2])
    b_min = np.minimum(np.minimum(y[2], y[3]), y[4])
    b_max = np.maximum(np.maximum(y[2], y[3]), y[4])
    a_cont = a_max - a_min
    b_cont = b_max - b_min
    cont_ratio = np.divide(np.maximum(a_cont, b_cont),
                           np.minimum(a_cont, b_cont) + cfg.kEps, dtype=np.float32)
    return (F32(1.0) - sat((cont_ratio - cfg.kMinContrastRatio) * cfg.kRatioNorm)) \
        * cfg.kContrastBoost


def _coef(table, phase_int):
    """Gather 6 taps of a (64,8) filter bank at per-pixel integer phases."""
    return [table[:, i].take(phase_int) for i in range(6)]


def _eval_poly6(pxl6, phase_int, cfg):
    """EvalPoly6 (NIS_Scaler.h:399-434); pxl6: 6 (H,W) scaled lumas."""
    cs = _coef(COEF_SCALE, phase_int)
    cu = _coef(COEF_USM, phase_int)
    y = cs[0] * pxl6[0]
    for i in range(1, 6):
        y = y + cs[i] * pxl6[i]
    y_usm = cu[0] * pxl6[0]
    for i in range(1, 6):
        y_usm = y_usm + cu[i] * pxl6[i]
    y_scale = F32(1.0) - sat((y * F32(1.0 / 255) - cfg.kSharpStartY) * cfg.kSharpScaleY)
    y_sharpness = y_scale * cfg.kSharpStrengthScale + cfg.kSharpStrengthMin
    y_usm = y_usm * y_sharpness
    y_sharpness_limit = (y_scale * cfg.kSharpLimitScale + cfg.kSharpLimitMin) * y
    y_usm = np.minimum(y_sharpness_limit, np.maximum(-y_sharpness_limit, y_usm))
    y_usm = y_usm * _calc_lti(pxl6, phase_int, cfg)
    return y + y_usm


def _filter_normal(p, fx_int, fy_int):
    """FilterNormal (NIS_Scaler.h:436-453); p[i][j]: 6x6 of (H,W) arrays."""
    cy = _coef(COEF_SCALE, fy_int)
    cx = _coef(COEF_SCALE, fx_int)
    h_acc = None
    for j in range(6):
        v_acc = p[0][j] * cy[0]
        for i in range(1, 6):
            v_acc = v_acc + p[i][j] * cy[i]
        term = v_acc * cx[j]
        h_acc = term if h_acc is None else h_acc + term
    return h_acc


def _get_dir_filters(p, fx, fy, fx_int, fy_int, cfg):
    """GetDirFilters (NIS_Scaler.h:455-583). Returns (f0, f90, f45, f135)."""
    interp0 = [hlsl_lerp(p[i][2], p[i][3], fx) for i in range(6)]
    f_x = _eval_poly6(interp0, fy_int, cfg)

    interp90 = [hlsl_lerp(p[2][i], p[3][i], fy) for i in range(6)]
    f_y = _eval_poly6(interp90, fx_int, cfg)

    # 45 degrees
    b45 = F32(0.5) + F32(0.5) * (fx - fy)
    t45 = [None] * 7
    t45[1] = hlsl_lerp(p[2][1], p[1][2], b45)
    t45[3] = hlsl_lerp(p[3][2], p[2][3], b45)
    t45[5] = hlsl_lerp(p[4][3], p[3][4], b45)
    hi = b45 >= F32(0.5)
    b45p = np.where(hi, b45 - F32(0.5), F32(0.5) - b45)
    t45[0] = np.where(hi, hlsl_lerp(p[1][1], p[0][2], b45p), hlsl_lerp(p[1][1], p[2][0], b45p))
    t45[2] = np.where(hi, hlsl_lerp(p[2][2], p[1][3], b45p), hlsl_lerp(p[2][2], p[3][1], b45p))
    t45[4] = np.where(hi, hlsl_lerp(p[3][3], p[2][4], b45p), hlsl_lerp(p[3][3], p[4][2], b45p))
    t45[6] = np.where(hi, hlsl_lerp(p[4][4], p[3][5], b45p), hlsl_lerp(p[4][4], p[5][3], b45p))
    p45 = fx + fy
    wrap = p45 >= F32(1.0)
    interp45 = [np.where(wrap, t45[i + 1], t45[i]) for i in range(6)]
    p45 = np.where(wrap, p45 - F32(1.0), p45)
    f_z = _eval_poly6(interp45, (p45 * F32(64)).astype(np.int32), cfg)

    # 135 degrees
    b135 = F32(0.5) * (fx + fy)
    t135 = [None] * 7
    t135[1] = hlsl_lerp(p[3][1], p[4][2], b135)
    t135[3] = hlsl_lerp(p[2][2], p[3][3], b135)
    t135[5] = hlsl_lerp(p[1][3], p[2][4], b135)
    hi = b135 >= F32(0.5)
    b135p = np.where(hi, b135 - F32(0.5), F32(0.5) - b135)
    t135[0] = np.where(hi, hlsl_lerp(p[4][1], p[5][2], b135p), hlsl_lerp(p[4][1], p[3][0], b135p))
    t135[2] = np.where(hi, hlsl_lerp(p[3][2], p[4][3], b135p), hlsl_lerp(p[3][2], p[2][1], b135p))
    t135[4] = np.where(hi, hlsl_lerp(p[2][3], p[3][4], b135p), hlsl_lerp(p[2][3], p[1][2], b135p))
    t135[6] = np.where(hi, hlsl_lerp(p[1][4], p[2][5], b135p), hlsl_lerp(p[1][4], p[0][3], b135p))
    p135 = F32(1.0) + (fx - fy)
    wrap = p135 >= F32(1.0)
    interp135 = [np.where(wrap, t135[i + 1], t135[i]) for i in range(6)]
    p135 = np.where(wrap, p135 - F32(1.0), p135)
    f_w = _eval_poly6(interp135, (p135 * F32(64)).astype(np.int32), cfg)
    return f_x, f_y, f_z, f_w


def nvscaler_oracle(img, out_w, out_h, cfg: NisConfig):
    """NVScaler (NIS_Scaler.h:589-770), SDR. img: (H,W,C>=3) f32 in [0,1].
    Returns (out_h, out_w, 4): rgb luma-corrected bilinear tap, alpha from the
    bilinear tap (1 when the input has no alpha channel)."""
    img = np.asarray(img, np.float32)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones(img.shape[:2] + (1,), np.float32)], axis=-1)
    y01 = get_y(img, cfg.hdr_mode)         # unscaled luma (edge maps)
    ys = (y01 * NIS_SCALE_FLOAT).astype(np.float32)  # scaled luma (filters)
    emap = edge_map_plane(y01, cfg)

    dstx = np.arange(out_w, dtype=np.float32)
    dsty = np.arange(out_h, dtype=np.float32)
    src_x = (F32(0.5) + dstx) * cfg.kScaleX - F32(0.5)   # (Wo,)
    src_y = (F32(0.5) + dsty) * cfg.kScaleY - F32(0.5)   # (Ho,)
    px = np.floor(src_x)
    py = np.floor(src_y)
    fx = (src_x - px)[None, :]
    fy = (src_y - py)[:, None]
    pxi = px.astype(np.int64)
    pyi = py.astype(np.int64)
    fx_int = (fx * F32(64)).astype(np.int32)
    fy_int = (fy * F32(64)).astype(np.int32)

    # 6x6 scaled-luma support: p[i][j] = Ys(py-2+i, px-2+j), clamp-extended.
    p = [[_clamped_take(ys, pyi + (i - 2), pxi + (j - 2)) for j in range(6)]
         for i in range(6)]

    pixel_n = _filter_normal(p, fx_int, fy_int)
    f0, f90, f45, f135 = _get_dir_filters(p, fx, fy, fx_int, fy_int, cfg)

    # 2x2 edge maps around the source position (kShift=2 inside the 6x6).
    edge = [[_clamped_take(emap, pyi + i, pxi + j) for j in range(2)] for i in range(2)]
    h0 = hlsl_lerp(edge[0][0], edge[0][1], fx[..., None])
    h1 = hlsl_lerp(edge[1][0], edge[1][1], fx[..., None])
    w = hlsl_lerp(h0, h1, fy[..., None]) * F32(255)  # * NIS_SCALE_INT

    op_y = (f0 * w[..., 0] + f90 * w[..., 1] + f45 * w[..., 2] + f135 * w[..., 3]
            + pixel_n * (NIS_SCALE_FLOAT - w[..., 0] - w[..., 1] - w[..., 2] - w[..., 3])
            ) * F32(1.0 / 255.0)

    # Bilinear chroma tap at dst-normalized coords (NIS_Scaler.h:747).
    u = ((dstx + F32(0.5)) * cfg.kDstNormX)[None, :] * np.ones((out_h, 1), np.float32)
    v = ((dsty + F32(0.5)) * cfg.kDstNormY)[:, None] * np.ones((1, out_w), np.float32)
    op = bilinear_sample(img, u, v)
    out = op.copy()
    if cfg.hdr_mode == 1:   # NIS_HDR_MODE_LINEAR: multiplicative luma fix
        # NIS_Scaler.h:749-756
        k_eps = F32(1e-4)
        k_norm = rcp(NIS_SCALE_FLOAT * KHDR_COMPRESSION)
        op_yn = np.maximum(op_y, F32(0.0)) * k_norm
        corr = np.divide(op_yn * op_yn + k_eps,
                         np.maximum(get_y_linear(op[..., :3]), F32(0.0))
                         + k_eps, dtype=np.float32)
        out[..., 0] = op[..., 0] * corr
        out[..., 1] = op[..., 1] * corr
        out[..., 2] = op[..., 2] * corr
    else:                   # SDR and PQ: additive correction (:758-761)
        corr = op_y * F32(1.0 / 255.0) - get_y(op[..., :3], cfg.hdr_mode)
        out[..., 0] = op[..., 0] + corr
        out[..., 1] = op[..., 1] + corr
        out[..., 2] = op[..., 2] + corr
    return out


def _calc_lti_fast(y5, cfg):
    """CalcLTIFast (NIS_Scaler.h:790-803); y5: 5 (H,W) unscaled lumas."""
    a_min = np.minimum(np.minimum(y5[0], y5[1]), y5[2])
    a_max = np.maximum(np.maximum(y5[0], y5[1]), y5[2])
    b_min = np.minimum(np.minimum(y5[2], y5[3]), y5[4])
    b_max = np.maximum(np.maximum(y5[2], y5[3]), y5[4])
    a_cont = a_max - a_min
    b_cont = b_max - b_min
    cont_ratio = np.divide(
        np.maximum(a_cont, b_cont),
        np.minimum(a_cont, b_cont) + cfg.kEps * F32(1.0 / 255.0),
        dtype=np.float32)
    return (F32(1.0) - sat((cont_ratio - cfg.kMinContrastRatio) * cfg.kRatioNorm)) \
        * cfg.kContrastBoost


def _eval_usm(pxl5, strength, limit, cfg):
    """EvalUSM (NIS_Scaler.h:805-817)."""
    y_usm = F32(-0.6001) * pxl5[1] + F32(1.2002) * pxl5[2] - F32(0.6001) * pxl5[3]
    y_usm = y_usm * strength
    y_usm = np.minimum(limit, np.maximum(-limit, y_usm))
    y_usm = y_usm * _calc_lti_fast(pxl5, cfg)
    return y_usm


def nvsharpen_oracle(img, cfg: NisConfig):
    """NVSharpen (NIS_Scaler.h:876-971), SDR. img: (H,W,C>=3) f32 in [0,1].
    Returns (H, W, 4)."""
    img = np.asarray(img, np.float32)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones(img.shape[:2] + (1,), np.float32)], axis=-1)
    y01 = get_y(img, cfg.hdr_mode)
    h, w = y01.shape
    ys_idx = np.arange(h)
    xs_idx = np.arange(w)
    # 5x5 unscaled-luma support centred at the pixel, clamp-extended.
    p = [[_clamped_take(y01, ys_idx + (i - 2), xs_idx + (j - 2)) for j in range(5)]
         for i in range(5)]

    # GetDirUSM (NIS_Scaler.h:819-871)
    scale_y = F32(1.0) - sat((p[2][2] - cfg.kSharpStartY) * cfg.kSharpScaleY)
    strength = scale_y * cfg.kSharpStrengthScale + cfg.kSharpStrengthMin
    limit = (scale_y * cfg.kSharpLimitScale + cfg.kSharpLimitMin) * p[2][2]

    interp0 = [p[i][2] for i in range(5)]
    d0 = _eval_usm(interp0, strength, limit, cfg)
    interp90 = [p[2][i] for i in range(5)]
    d90 = _eval_usm(interp90, strength, limit, cfg)
    half = F32(0.5)
    interp45 = [p[1][1], hlsl_lerp(p[2][1], p[1][2], half), p[2][2],
                hlsl_lerp(p[3][2], p[2][3], half), p[3][3]]
    d45 = _eval_usm(interp45, strength, limit, cfg)
    interp135 = [p[3][1], hlsl_lerp(p[3][2], p[2][1], half), p[2][2],
                 hlsl_lerp(p[2][3], p[1][2], half), p[1][3]]
    d135 = _eval_usm(interp135, strength, limit, cfg)

    # Edge-map weights on the 3x3 centred in the 5x5 (kSupportSize/2-1 = 1).
    pc = {(i, j): p[i + 1][j + 1] for i in range(3) for j in range(3)}
    g_0 = np.abs(pc[0, 0] + pc[0, 1] + pc[0, 2] - pc[2, 0] - pc[2, 1] - pc[2, 2])
    g_45 = np.abs(pc[1, 0] + pc[0, 0] + pc[0, 1] - pc[2, 1] - pc[2, 2] - pc[1, 2])
    g_90 = np.abs(pc[0, 0] + pc[1, 0] + pc[2, 0] - pc[0, 2] - pc[1, 2] - pc[2, 2])
    g_135 = np.abs(pc[1, 0] + pc[2, 0] + pc[2, 1] - pc[0, 1] - pc[0, 2] - pc[1, 2])
    wgt = _edge_weights(g_0, g_45, g_90, g_135, cfg)

    usm_y = (d0 * wgt[..., 0] + d90 * wgt[..., 1] + d45 * wgt[..., 2]
             + d135 * wgt[..., 3])

    # The output tap samples at ((x+0.5)/W, (y+0.5)/H) which lands on the texel
    # centre — hardware subtexel quantization makes this an exact fetch.
    out = img.copy()
    if cfg.hdr_mode == 1:   # NIS_HDR_MODE_LINEAR (NIS_Scaler.h:951-959)
        k_eps = F32(1e-4) * KHDR_COMPRESSION * KHDR_COMPRESSION
        new_y = np.maximum(p[2][2] + usm_y, F32(0.0))
        old_y = p[2][2]
        corr = np.divide(new_y * new_y + k_eps, old_y * old_y + k_eps,
                         dtype=np.float32)
        out[..., 0] = img[..., 0] * corr
        out[..., 1] = img[..., 1] * corr
        out[..., 2] = img[..., 2] * corr
    else:                   # SDR and PQ: additive (:961-963)
        out[..., 0] = img[..., 0] + usm_y
        out[..., 1] = img[..., 1] + usm_y
        out[..., 2] = img[..., 2] + usm_y
    return out
