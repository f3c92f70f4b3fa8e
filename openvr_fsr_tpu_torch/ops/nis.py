"""NVIDIA Image Scaling in eager torch (NVScaler + NVSharpen; SDR and both
HDR modes).

Port of openvr_fsr_tpu/ops/nis.py (itself a line-faithful port of
src/nis/NIS_Scaler.h) in the same f32 op order, bit-exact against the NumPy
oracle openvr_fsr_tpu/oracle/nis.py. Source positions, filter phases and
lerp fractions depend only on the shapes and the config: the per-axis ones
are numpy on the host, the per-pixel ones of the diagonal filters are the
same f32 ops on the image's device. Planes are (..., C, H, W). Keep this
eager: a compiler may contract mul+add.

These ops are the plain versions of the NVScaler and NVSharpen CUDA kernels
(kernels/nis.py). Their cores take the working type dt: f32, or bf16 for
precision="half", the JAX package's dt=bfloat16 cores (eval_poly6_core,
_calc_lti_jax, _eval_usm_jax, _calc_lti_fast_jax) with every dt(...)
literal rounded to bf16 (lit), the divisions in f32 rounded to dt
(_div_dt) and `sat` (a clamp) kept in dt. The pipelines follow the JAX
Pallas kernels' half policy (kernels/nis.py of the JAX package, not its XLA
op, which has no dt): nvscaler rounds its scaled-luma taps, coefficients
and fractions to bf16 and runs FilterNormal, the interpolation trees and
EvalPoly6 in bf16, its edge map on the f32 luma; nvsharpen rounds its luma
plane once and runs the USM in bf16, its edge map on the rounded luma
widened. Both combine in f32 and correct the f32 colour.
"""

import numpy as np
import torch

from ..core.constants import NisConfig
from ..core.nis_tables import COEF_SCALE, COEF_USM
from .bilinear import bilinear_sample
from .common import F32, hlsl_lerp, lit, sat

__all__ = ["get_y", "get_y_linear", "sqrt_rn", "edge_map_plane",
           "eval_poly6_core", "nis_source_maps", "nvscaler", "nvsharpen",
           "NIS_SCALE_FLOAT", "KHDR_COMPRESSION"]

NIS_SCALE_FLOAT = F32(255.0)
KHDR_COMPRESSION = F32(0.282842712)  # kHDRCompressionFactor (NIS_Scaler.h:118)
_INV255 = float(F32(1.0 / 255.0))


def _f(x):
    """An f32 constant as the Python float torch multiplies by exactly."""
    return float(F32(x))


def _t(a, device):
    """A host numpy array as a tensor on `device` (int arrays as int64)."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def _ch(x, c):
    return x[..., c, :, :]


def get_y_linear(rgb):
    """getYLinear (NIS_Scaler.h:171-174): BT.709 luma of (..., >=3, H, W)."""
    return (_f(0.2126) * _ch(rgb, 0) + _f(0.7152) * _ch(rgb, 1)
            + _f(0.0722) * _ch(rgb, 2))


def sqrt_rn(x):
    """The correctly rounded f32 square root (IEEE, as numpy and CUDA's
    sqrtf give it). torch's CPU kernel is not (SLEEF, 0.5001 ulp); the
    float64 root rounded once to f32 is, since 53 >= 2*24 + 2 bits."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def get_y(rgb, hdr_mode=0):
    """getY (NIS_Scaler.h:160-169): SDR BT.709; HDR linear =
    sqrt(luma)*kHDRCompressionFactor; HDR PQ = Rec.2020 luma weights."""
    if hdr_mode == 2:   # NIS_HDR_MODE_PQ
        return (_f(0.262) * _ch(rgb, 0) + _f(0.678) * _ch(rgb, 1)
                + _f(0.0593) * _ch(rgb, 2))
    if hdr_mode == 1:   # NIS_HDR_MODE_LINEAR
        return sqrt_rn(get_y_linear(rgb)) * float(KHDR_COMPRESSION)
    return get_y_linear(rgb)


def _take2(plane, ys, xs):
    """plane[..., ys, :][..., xs] for int64 index tensors."""
    return plane.index_select(-2, ys).index_select(-1, xs)


def _edge_grads(p):
    """The four directional gradients from a {(i, j): plane} 3x3 dict, in
    the exact f32 summation order of NIS_Scaler.h:182-185."""
    g_0 = torch.abs(p[0, 0] + p[0, 1] + p[0, 2] - p[2, 0] - p[2, 1] - p[2, 2])
    g_45 = torch.abs(p[1, 0] + p[0, 0] + p[0, 1] - p[2, 1] - p[2, 2] - p[1, 2])
    g_90 = torch.abs(p[0, 0] + p[1, 0] + p[2, 0] - p[0, 2] - p[1, 2] - p[2, 2])
    g_135 = torch.abs(p[1, 0] + p[2, 0] + p[2, 1] - p[0, 1] - p[0, 2] - p[1, 2])
    return g_0, g_45, g_90, g_135


def _edge_weights(g_0, g_45, g_90, g_135, cfg):
    """GetEdgeMap's weight logic (NIS_Scaler.h:187-292). Returns
    [w0, w90, w45, w135]. The ratio is computed where denom is 0 as well
    (0/0 = NaN) and selected away, as in the oracle."""
    zero = torch.zeros_like(g_0)
    g090mx = torch.maximum(g_0, g_90)
    g090mn = torch.minimum(g_0, g_90)
    g45mx = torch.maximum(g_45, g_135)
    g45mn = torch.minimum(g_45, g_135)

    denom = g090mx + g45mx
    ratio = g090mx / denom
    nonzero = denom != 0
    e090 = torch.where(nonzero, torch.clamp(ratio, max=1.0), zero)
    e45 = torch.where(nonzero, 1.0 - e090, zero)

    ratio_k, thres_k = float(cfg.kDetectRatio), float(cfg.kDetectThres)
    c1 = (g090mx > g090mn * ratio_k) & (g090mx > thres_k) & (g090mx > g45mn)
    is0 = g090mx == g_0
    edge_0 = (c1 & is0).to(torch.float32)
    edge_90 = (c1 & ~is0).to(torch.float32)
    c2 = (g45mx > g45mn * ratio_k) & (g45mx > thres_k) & (g45mx > g090mn)
    is45 = g45mx == g_45
    edge_45 = (c2 & is45).to(torch.float32)
    edge_135 = (c2 & ~is45).to(torch.float32)

    total = edge_0 + edge_90 + edge_45 + edge_135
    ge2 = total >= 2.0
    ge1 = total >= 1.0
    e0_is1 = edge_0 == 1.0
    e45_is1 = edge_45 == 1.0
    w0 = torch.where(ge2, torch.where(e0_is1, e090, zero),
                     torch.where(ge1, edge_0, zero))
    w90 = torch.where(ge2, torch.where(e0_is1, zero, e090),
                      torch.where(ge1, edge_90, zero))
    w45 = torch.where(ge2, torch.where(e45_is1, e45, zero),
                      torch.where(ge1, edge_45, zero))
    w135 = torch.where(ge2, torch.where(e45_is1, zero, e45),
                       torch.where(ge1, edge_135, zero))
    return [w0, w90, w45, w135]


def edge_map_plane(y01, cfg):
    """GetEdgeMap at every pixel of the edge-clamped luma plane (..., H, W):
    the 4 weight planes [w0, w90, w45, w135]."""
    h, w = y01.shape[-2:]
    dev = y01.device
    ys, xs = np.arange(h), np.arange(w)
    p = {(i, j): _take2(y01, _t(np.clip(ys + i - 1, 0, h - 1), dev),
                        _t(np.clip(xs + j - 1, 0, w - 1), dev))
         for i in range(3) for j in range(3)}
    return _edge_weights(*_edge_grads(p), cfg)


def _div_dt(num, den, dt):
    """num / den in the working type dt: the f32 quotient of the widened
    operands, rounded once (the JAX package's _div_dt)."""
    return (num.float() / den.float()).to(dt)


def _lti_tail(a_cont, b_cont, eps, cfg, dt=torch.float32):
    cont_ratio = _div_dt(torch.maximum(a_cont, b_cont),
                         torch.minimum(a_cont, b_cont) + lit(eps, dt), dt)
    return ((1.0 - sat((cont_ratio - lit(cfg.kMinContrastRatio, dt))
                       * lit(cfg.kRatioNorm, dt)))
            * lit(cfg.kContrastBoost, dt))


def _min3(a, b, c):
    return torch.minimum(torch.minimum(a, b), c)


def _max3(a, b, c):
    return torch.maximum(torch.maximum(a, b), c)


def _calc_lti(p6, lo_mask, cfg, dt=torch.float32):
    """CalcLTI (NIS_Scaler.h:343-375); lo_mask: phase <= 32, the 5-tap
    window select; p6 in dt."""
    y = [torch.where(lo_mask, p6[i], p6[i + 1]) for i in range(5)]
    a_cont = _max3(y[0], y[1], y[2]) - _min3(y[0], y[1], y[2])
    b_cont = _max3(y[2], y[3], y[4]) - _min3(y[2], y[3], y[4])
    return _lti_tail(a_cont, b_cont, cfg.kEps, cfg, dt)


def eval_poly6_core(pxl6, cs, cu, lo_mask, cfg, dt=torch.float32):
    """EvalPoly6 (NIS_Scaler.h:399-434) with explicit coefficient planes:
    cs/cu are the 6 COEF_SCALE / COEF_USM taps at each pixel's phase,
    lo_mask is phase <= 32; taps and coefficients in dt, the result in
    dt."""
    y = cs[0] * pxl6[0]
    for i in range(1, 6):
        y = y + cs[i] * pxl6[i]
    y_usm = cu[0] * pxl6[0]
    for i in range(1, 6):
        y_usm = y_usm + cu[i] * pxl6[i]
    y_scale = 1.0 - sat((y * lit(1.0 / 255.0, dt) - lit(cfg.kSharpStartY, dt))
                        * lit(cfg.kSharpScaleY, dt))
    y_sharpness = (y_scale * lit(cfg.kSharpStrengthScale, dt)
                   + lit(cfg.kSharpStrengthMin, dt))
    y_usm = y_usm * y_sharpness
    y_limit = (y_scale * lit(cfg.kSharpLimitScale, dt)
               + lit(cfg.kSharpLimitMin, dt)) * y
    y_usm = torch.minimum(y_limit, torch.maximum(-y_limit, y_usm))
    y_usm = y_usm * _calc_lti(pxl6, lo_mask, cfg, dt)
    return y + y_usm


def _eval_poly6(pxl6, phase, tables, cfg, dt=torch.float32):
    """EvalPoly6 at int64 phases (a tensor of any broadcastable shape):
    the coefficient planes are the (64, 8) f32 tables indexed by phase,
    rounded to dt."""
    cs = [tables[0][:, i][phase].to(dt) for i in range(6)]
    cu = [tables[1][:, i][phase].to(dt) for i in range(6)]
    return eval_poly6_core(pxl6, cs, cu, phase <= 32, cfg, dt)


def nis_source_maps(out_w, out_h, cfg):
    """Per-axis source maps srcX = (0.5 + dst)*kScale - 0.5
    (NIS_Scaler.h:682): floor (int64) and f32 fraction per output column
    and row."""
    dstx = np.arange(out_w, dtype=np.float32)
    dsty = np.arange(out_h, dtype=np.float32)
    src_x = (F32(0.5) + dstx) * cfg.kScaleX - F32(0.5)
    src_y = (F32(0.5) + dsty) * cfg.kScaleY - F32(0.5)
    px = np.floor(src_x)
    py = np.floor(src_y)
    return (px.astype(np.int64), py.astype(np.int64),
            (src_x - px).astype(np.float32), (src_y - py).astype(np.float32))


def _diag_taps(p, pairs, tails, b, bp, hi):
    """One diagonal interpolation tree of GetDirFilters: t[1], t[3], t[5]
    lerp the `pairs` by b; t[0], t[2], t[4], t[6] lerp from a shared head
    to one of two `tails` by bp, chosen by hi (NIS_Scaler.h:489-583)."""
    t = [None] * 7
    for k, ((a0, a1), (b0, b1)) in zip((1, 3, 5), pairs):
        t[k] = hlsl_lerp(p[a0][a1], p[b0][b1], b)
    for k, ((h0, h1), (u0, u1), (d0, d1)) in zip((0, 2, 4, 6), tails):
        t[k] = torch.where(hi, hlsl_lerp(p[h0][h1], p[u0][u1], bp),
                           hlsl_lerp(p[h0][h1], p[d0][d1], bp))
    return t


def nvscaler(rgba, out_w, out_h, cfg: NisConfig, dt=torch.float32):
    """NVScaler (NIS_Scaler.h:589-770): rgba (..., 4, H, W) f32 -> (..., 4,
    out_h, out_w) f32: the luma-corrected bilinear RGBA tap, alpha the tap's
    alpha. Edge weights at clamped positions are those of the nearest
    in-image pixel, whose own 3x3 is clamped again (clip(clip(p)+-1),
    oracle/nis.py:58-74, 250). dt: the filters' working type (the JAX
    kernel's half policy for bf16, kernels/nis.py:841-1011): the scaled
    luma taps, the coefficients and the lerp fractions rounded to dt (the
    diagonal fractions computed and compared in f32 first), the phases,
    the edge map, the combine and the correction in f32."""
    h, w = rgba.shape[-2:]
    dev = rgba.device
    y01 = get_y(rgba, cfg.hdr_mode)
    ys255 = y01 * float(NIS_SCALE_FLOAT)
    emap = edge_map_plane(y01, cfg)

    pxi, pyi, fx1d, fy1d = nis_source_maps(out_w, out_h, cfg)
    u_full = (np.arange(out_w, dtype=np.float32) + F32(0.5)) * cfg.kDstNormX
    v_full = (np.arange(out_h, dtype=np.float32) + F32(0.5)) * cfg.kDstNormY
    fx, fy = _t(fx1d[None, :], dev), _t(fy1d[:, None], dev)
    fx_int = _t((fx1d * F32(64)).astype(np.int32)[None, :], dev)
    fy_int = _t((fy1d * F32(64)).astype(np.int32)[:, None], dev)
    tables = (_t(COEF_SCALE, dev), _t(COEF_USM, dev))

    rows = [ys255.index_select(-2, _t(np.clip(pyi + i - 2, 0, h - 1), dev))
            for i in range(6)]
    cols = [_t(np.clip(pxi + j - 2, 0, w - 1), dev) for j in range(6)]
    p = [[rows[i].index_select(-1, cols[j]).to(dt) for j in range(6)]
         for i in range(6)]

    # FilterNormal, column sums then the row sum (NIS_Scaler.h:436-453)
    cy = [tables[0][:, i][fy_int].to(dt) for i in range(6)]
    cx = [tables[0][:, i][fx_int].to(dt) for i in range(6)]
    pixel_n = None
    for j in range(6):
        v_acc = p[0][j] * cy[0]
        for i in range(1, 6):
            v_acc = v_acc + p[i][j] * cy[i]
        term = v_acc * cx[j]
        pixel_n = term if pixel_n is None else pixel_n + term

    # GetDirFilters (NIS_Scaler.h:455-583); the (Ho, Wo) fractions and
    # phases of the diagonals in f32 as the oracle's numpy computes them
    fxd, fyd = fx.to(dt), fy.to(dt)
    f0 = _eval_poly6([hlsl_lerp(p[i][2], p[i][3], fxd) for i in range(6)],
                     fy_int, tables, cfg, dt)
    f90 = _eval_poly6([hlsl_lerp(p[2][i], p[3][i], fyd) for i in range(6)],
                      fx_int, tables, cfg, dt)

    def diagonal(b, pairs, tails, phase_frac):
        hi = b >= 0.5
        t = _diag_taps(p, pairs, tails, b.to(dt),
                       torch.where(hi, b - 0.5, 0.5 - b).to(dt), hi)
        wrap = phase_frac >= 1.0
        phase_frac = torch.where(wrap, phase_frac - 1.0, phase_frac)
        return _eval_poly6(
            [torch.where(wrap, t[i + 1], t[i]) for i in range(6)],
            (phase_frac * 64.0).to(torch.int64), tables, cfg, dt)

    f45 = diagonal(0.5 + 0.5 * (fx - fy),
                   (((2, 1), (1, 2)), ((3, 2), (2, 3)), ((4, 3), (3, 4))),
                   (((1, 1), (0, 2), (2, 0)), ((2, 2), (1, 3), (3, 1)),
                    ((3, 3), (2, 4), (4, 2)), ((4, 4), (3, 5), (5, 3))),
                   fx + fy)
    f135 = diagonal(0.5 * (fx + fy),
                    (((3, 1), (4, 2)), ((2, 2), (3, 3)), ((1, 3), (2, 4))),
                    (((4, 1), (5, 2), (3, 0)), ((3, 2), (4, 3), (2, 1)),
                     ((2, 3), (3, 4), (1, 2)), ((1, 4), (2, 5), (0, 3))),
                    1.0 + (fx - fy))

    # 2x2 edge maps at floor(src)+{0,1}, clamped, interpolated by (fx, fy)
    ey = [_t(np.clip(pyi + i, 0, h - 1), dev) for i in range(2)]
    ex = [_t(np.clip(pxi + j, 0, w - 1), dev) for j in range(2)]
    ws = []
    for k in range(4):
        e = [[_take2(emap[k], ey[i], ex[j]) for j in range(2)]
             for i in range(2)]
        h0 = hlsl_lerp(e[0][0], e[0][1], fx)
        h1 = hlsl_lerp(e[1][0], e[1][1], fx)
        ws.append(hlsl_lerp(h0, h1, fy) * 255.0)

    op_y = (f0.float() * ws[0] + f90.float() * ws[1] + f45.float() * ws[2]
            + f135.float() * ws[3]
            + pixel_n.float() * (float(NIS_SCALE_FLOAT) - ws[0] - ws[1]
                                 - ws[2] - ws[3])) * _INV255

    op = bilinear_sample(rgba, u_full, v_full)
    if cfg.hdr_mode == 1:   # NIS_HDR_MODE_LINEAR: multiplicative luma fix
        # (NIS_Scaler.h:749-756)
        k_eps = float(F32(1e-4))
        k_norm = float(np.divide(F32(1.0), NIS_SCALE_FLOAT * KHDR_COMPRESSION,
                                 dtype=np.float32))
        op_yn = torch.clamp(op_y, min=0.0) * k_norm
        corr = (op_yn * op_yn + k_eps) / (
            torch.clamp(get_y_linear(op), min=0.0) + k_eps)
        return torch.cat([op[..., :3, :, :] * corr.unsqueeze(-3),
                          op[..., 3:4, :, :]], dim=-3)
    # SDR and PQ: additive luma correction (:758-761)
    corr = op_y * _INV255 - get_y(op, cfg.hdr_mode)
    return torch.cat([op[..., :3, :, :] + corr.unsqueeze(-3),
                      op[..., 3:4, :, :]], dim=-3)


def _calc_lti_fast(y5, cfg, dt=torch.float32):
    """CalcLTIFast (NIS_Scaler.h:790-803); y5: 5 unscaled lumas in dt. The
    epsilon is the f32 product kEps * f32(1/255), rounded to dt once."""
    a_cont = _max3(y5[0], y5[1], y5[2]) - _min3(y5[0], y5[1], y5[2])
    b_cont = _max3(y5[2], y5[3], y5[4]) - _min3(y5[2], y5[3], y5[4])
    return _lti_tail(a_cont, b_cont, cfg.kEps * F32(1.0 / 255.0), cfg, dt)


def _eval_usm(pxl5, strength, limit, cfg, dt=torch.float32):
    """EvalUSM (NIS_Scaler.h:805-817): the fixed [-0.6001, 1.2002, -0.6001]
    profile, limited and LTI-weighted; everything in dt."""
    y_usm = (lit(-0.6001, dt) * pxl5[1] + lit(1.2002, dt) * pxl5[2]
             - lit(0.6001, dt) * pxl5[3])
    y_usm = y_usm * strength
    y_usm = torch.minimum(limit, torch.maximum(-limit, y_usm))
    return y_usm * _calc_lti_fast(pxl5, cfg, dt)


def nvsharpen(rgba, cfg: NisConfig, dt=torch.float32):
    """NVSharpen (NIS_Scaler.h:876-971): rgba (..., 4, H, W) f32 -> the same
    shape; alpha passes through. dt: the USM's working type (the JAX
    kernel's half policy for bf16, kernels/nis.py:187-226): the luma plane
    rounded to dt once, GetDirUSM in dt, the edge map on the rounded luma
    widened to f32, the combine and the correction (of the f32 luma and
    colour) in f32."""
    h, w = rgba.shape[-2:]
    dev = rgba.device
    y01 = get_y(rgba, cfg.hdr_mode)
    yk = y01.to(dt)
    ys, xs = np.arange(h), np.arange(w)
    rows = [yk.index_select(-2, _t(np.clip(ys + i - 2, 0, h - 1), dev))
            for i in range(5)]
    cols = [_t(np.clip(xs + j - 2, 0, w - 1), dev) for j in range(5)]
    p = [[rows[i].index_select(-1, cols[j]) for j in range(5)]
         for i in range(5)]

    # GetDirUSM (NIS_Scaler.h:819-871)
    scale_y = 1.0 - sat((p[2][2] - lit(cfg.kSharpStartY, dt))
                        * lit(cfg.kSharpScaleY, dt))
    strength = (scale_y * lit(cfg.kSharpStrengthScale, dt)
                + lit(cfg.kSharpStrengthMin, dt))
    limit = (scale_y * lit(cfg.kSharpLimitScale, dt)
             + lit(cfg.kSharpLimitMin, dt)) * p[2][2]
    half = 0.5

    def usm(taps):
        return _eval_usm(taps, strength, limit, cfg, dt).float()
    d0 = usm([p[i][2] for i in range(5)])
    d90 = usm([p[2][i] for i in range(5)])
    d45 = usm([p[1][1], hlsl_lerp(p[2][1], p[1][2], half), p[2][2],
               hlsl_lerp(p[3][2], p[2][3], half), p[3][3]])
    d135 = usm([p[3][1], hlsl_lerp(p[3][2], p[2][1], half), p[2][2],
                hlsl_lerp(p[2][3], p[1][2], half), p[1][3]])

    # edge-map weights on the 3x3 centred in the 5x5
    pc = {(i, j): p[i + 1][j + 1].float() for i in range(3) for j in range(3)}
    wgt = _edge_weights(*_edge_grads(pc), cfg)
    usm_y = d0 * wgt[0] + d90 * wgt[1] + d45 * wgt[2] + d135 * wgt[3]
    rgb, alpha = rgba[..., :3, :, :], rgba[..., 3:4, :, :]
    if cfg.hdr_mode == 1:   # NIS_HDR_MODE_LINEAR (NIS_Scaler.h:951-959)
        k_eps = float(F32(1e-4) * KHDR_COMPRESSION * KHDR_COMPRESSION)
        new_y = torch.clamp(y01 + usm_y, min=0.0)
        old_y = y01
        corr = (new_y * new_y + k_eps) / (old_y * old_y + k_eps)
        return torch.cat([rgb * corr.unsqueeze(-3), alpha], dim=-3)
    return torch.cat([rgb + usm_y.unsqueeze(-3), alpha], dim=-3)
