"""EASU in torch: planar (..., 3, H, W) channels, static gather maps.

The math is a line-faithful port of FsrEasuF (reference
src/fsr/ffx_fsr1.h:315-437) in the op order of the JAX package's
ops/easu.py: the TAP_ORDER accumulation, the luma B*0.5 + (R*0.5 + G), and
the per-offset shared products of FsrEasuTapF. The gather of the 12 taps is
separable (the row map depends only on the output row, the column map only
on the output column), so each tap is two index_selects.
"""

import numpy as np
import torch

from .common import (aprx_lo_rcp, aprx_lo_rsq, lit, rcp, sat, min3, max3,
                     strip_rows, via_f32)

__all__ = ["easu", "easu_core", "easu_resolve", "easu_index_maps",
           "TAP_ORDER"]

# exact FsrEasuF accumulation order (ffx_fsr1.h:423-434)
TAP_ORDER = [
    (0, -1), (1, -1), (-1, 1), (0, 1), (0, 0), (-1, 0),
    (1, 1), (2, 1), (2, 0), (1, 0), (1, 2), (0, 2),
]

# f32 values of the FsrEasuTapF / FsrEasuF literals that are exact in
# bf16 too, as Python floats (lit gives the others in the working type)
_K_W25 = 25.0 / 16.0
_K_W25M = -(25.0 / 16.0 - 1.0)
_K_DIRMIN = 1.0 / 32768.0


def _easu_direction(L, ppx, ppy, dt=torch.float32):
    """The four FsrEasuSetF sums of the direction/anisotropy analysis from
    the luma dict L (ffx_fsr1.h:368-404): (dir_x, dir_y, length).

    dt=bf16 is the half schedule of the JAX package's _easu_weights: the
    sums and products of lumas, weights and directions in bf16, the
    approximations through f32 (via_f32), and where the JAX package's f32
    literals lift a value to f32 (sat's, in lenX and lenY), everything that
    follows from it in f32: the length sum here, and len2, lob and the tap
    weights in easu_resolve."""
    lo_rcp = via_f32(aprx_lo_rcp, dt)
    bL, cL = L[(0, -1)], L[(1, -1)]
    eL, fL, gL, hL = L[(-1, 0)], L[(0, 0)], L[(1, 0)], L[(2, 0)]
    iL, jL, kL, lL = L[(-1, 1)], L[(0, 1)], L[(1, 1)], L[(2, 1)]
    nL, oL = L[(0, 2)], L[(1, 2)]

    def easu_set(acc, w, lA, lB, lC, lD, lE):
        dir_x, dir_y, length = acc
        dc = lD - lC
        cb = lC - lB
        lenX = lo_rcp(torch.maximum(torch.abs(dc), torch.abs(cb)))
        dirX = lD - lB
        dir_x = dir_x + dirX * w
        lenX = sat((torch.abs(dirX) * lenX).float())
        length = length + (lenX * lenX) * w
        ec = lE - lC
        ca = lC - lA
        lenY = lo_rcp(torch.maximum(torch.abs(ec), torch.abs(ca)))
        dirY = lE - lA
        dir_y = dir_y + dirY * w
        lenY = sat((torch.abs(dirY) * lenY).float())
        length = length + (lenY * lenY) * w
        return dir_x, dir_y, length

    z = torch.zeros_like(fL)
    acc = (z, z, z)
    acc = easu_set(acc, (1.0 - ppx) * (1.0 - ppy), bL, eL, fL, gL, jL)
    acc = easu_set(acc, ppx * (1.0 - ppy), cL, fL, gL, hL, kL)
    acc = easu_set(acc, (1.0 - ppx) * ppy, fL, iL, jL, kL, nL)
    return easu_set(acc, ppx * ppy, gL, jL, kL, lL, oL)


def _easu_weights(direction, ppx, ppy, dt=torch.float32):
    """The rest of the analysis after the sums `direction` (_easu_direction;
    ffx_fsr1.h:405-421). Returns tap_w, the per-tap weight function."""
    lo_rcp, lo_rsq = via_f32(aprx_lo_rcp, dt), via_f32(aprx_lo_rsq, dt)
    k_lob = lit((1.0 / 4.0 - 0.04) - 0.5, dt)
    k_wb = lit(2.0 / 5.0, dt)
    dir_x, dir_y, length = direction

    dirR = dir_x * dir_x + dir_y * dir_y
    zro = dirR < _K_DIRMIN
    dirR = lo_rsq(dirR)
    dirR = torch.where(zro, 1.0, dirR)
    dir_x = torch.where(zro, 1.0, dir_x)
    dir_x = dir_x * dirR
    dir_y = dir_y * dirR

    length = length * 0.5
    length = length * length
    stretch = (dir_x * dir_x + dir_y * dir_y) * lo_rcp(
        torch.maximum(torch.abs(dir_x), torch.abs(dir_y)))
    len2_x = 1.0 + (stretch - 1.0) * length
    len2_y = 1.0 + -0.5 * length
    lob = 0.5 + k_lob * length
    clp = lo_rcp(lob)

    # Shared per-offset products: in FsrEasuTapF (ffx_fsr1.h:250-253)
    #   vx = off_x*dir_x + off_y*dir_y,  vy = off_x*(-dir_y) + off_y*dir_x
    # with off_x, off_y depending on dx, dy alone; the same values the
    # per-tap form computes, de-duplicated.
    ndir_y = -dir_y
    offx = {dx: float(dx) - ppx for dx in (-1, 0, 1, 2)}
    offy = {dy: float(dy) - ppy for dy in (-1, 0, 1, 2)}
    pvx_x = {dx: o * dir_x for dx, o in offx.items()}
    pvx_y = {dy: o * dir_y for dy, o in offy.items()}
    pvy_x = {dx: o * ndir_y for dx, o in offx.items()}
    pvy_y = {dy: o * dir_x for dy, o in offy.items()}

    def tap_w(dx, dy):
        """The (dx, dy) tap weight (FsrEasuTapF, ffx_fsr1.h:239-272)."""
        vx = pvx_x[dx] + pvx_y[dy]
        vy = pvy_x[dx] + pvy_y[dy]
        vx = vx * len2_x
        vy = vy * len2_y
        d2 = torch.minimum(vx * vx + vy * vy, clp)
        wB = k_wb * d2 + -1.0
        wA = lob * d2 + -1.0
        wB = wB * wB
        wA = wA * wA
        wB = _K_W25 * wB + _K_W25M
        return wB * wA

    return tap_w


def easu_core(taps, ppx, ppy, dt=torch.float32):
    """The FsrEasuF math after the 12 taps are gathered (ffx_fsr1.h:363-437).

    taps: dict (dx, dy) -> (..., 3, h, w) f32 tensors for the 12 offsets in
    TAP_ORDER. ppx/ppy: fractional coordinates broadcastable against
    (h, w), typically (1, w) and (h, 1). dt: the working type, f32, or
    bf16 for precision="half" (the JAX package's easu_core_split at
    dt=bfloat16: taps and fractions rounded to bf16, the resolve's rcp
    through f32 and rounded to bf16, no exact_div). Returns the
    dering-clamped (..., 3, h, w) RGB in f32 either way."""
    taps = {off: c.to(dt) for off, c in taps.items()}
    ppx, ppy = ppx.to(dt), ppy.to(dt)
    L = {}
    for off, c in taps.items():
        r, g, b = c.unbind(-3)
        L[off] = b * 0.5 + (r * 0.5 + g)    # luma*2 (ffx_fsr1.h:363-366)
    return easu_resolve(taps, _easu_direction(L, ppx, ppy, dt), ppx, ppy, dt)


def easu_resolve(taps, direction, ppx, ppy, dt=torch.float32):
    """FsrEasuF after the four FsrEasuSetF sums (ffx_fsr1.h:405-437): the
    tap weights from `direction` ((dir_x, dir_y, length): the four sums),
    the 12-tap filter and the dering clamp. taps, ppx and ppy as easu_core
    has them, already in dt. Returns the (..., 3, h, w) RGB in f32."""
    tap_w = _easu_weights(direction, ppx, ppy, dt)

    cf, cg, cj, ck = taps[(0, 0)], taps[(1, 0)], taps[(0, 1)], taps[(1, 1)]
    min4 = torch.minimum(min3(cf, ck, cj), cg)
    max4 = torch.maximum(max3(cf, ck, cj), cg)

    aC = torch.zeros_like(cf)
    aW = torch.zeros_like(cf.select(-3, 0))   # a luma plane's shape and dt
    for dx, dy in TAP_ORDER:
        w = tap_w(dx, dy)
        aC = aC + taps[(dx, dy)] * w.unsqueeze(-3)
        aW = aW + w
    # the resolve multiplies by the reciprocal (ARcpF1, ffx_fsr1.h:434)
    inv_w = via_f32(rcp, dt)(aW).unsqueeze(-3)
    return torch.minimum(max4, torch.maximum(min4, aC * inv_w))


def easu_index_maps(in_w, in_h, out_w, out_h, con0):
    """Static (numpy) per-axis index and fraction maps.

    Returns (fxi, fyi, ppx, ppy): int64 floor maps and f32 fractions, where
    pp = ip*con0.xy + con0.zw (ffx_fsr1.h:324-326). A copy of the JAX
    package's ops/easu.py::easu_index_maps."""
    ix = np.arange(out_w, dtype=np.float32)
    iy = np.arange(out_h, dtype=np.float32)
    ppx = ix * con0[0] + con0[2]
    ppy = iy * con0[1] + con0[3]
    fpx = np.floor(ppx)
    fpy = np.floor(ppy)
    return (
        fpx.astype(np.int64),
        fpy.astype(np.int64),
        (ppx - fpx).astype(np.float32),
        (ppy - fpy).astype(np.float32),
    )


def easu_gather(rgb, fxi, fyi, row_base=0, in_h=None):
    """The 12 EASU taps of rgb (..., 3, H, W) at the floor maps fxi (Wo,)
    and fyi (Ho,) (tensors), edge-clamped: dict (dx, dy) -> (..., 3, Ho, Wo).
    rgb may be a row strip of an image of in_h rows that starts at the
    image's row row_base: a tap's row is clamped into the image, then
    rebased to the strip and clamped into it (strip_rows)."""
    h, w = rgb.shape[-2:]
    fxi, fyi = fxi.long(), fyi.long()
    rows = {dy: rgb.index_select(-2, strip_rows(fyi + dy, h, row_base, in_h))
            for dy in (-1, 0, 1, 2)}
    cols = {dx: (fxi + dx).clamp(0, w - 1) for dx in (-1, 0, 1, 2)}
    return {(dx, dy): rows[dy].index_select(-1, cols[dx])
            for dx, dy in TAP_ORDER}


def easu(rgb, out_w, out_h, con):
    """rgb: (..., 3, H_in, W_in) f32 in [0,1]. con: fsr_easu_con tuple
    (numpy). Returns (..., 3, out_h, out_w) f32."""
    con0 = np.asarray(con[0], np.float32)
    h_in, w_in = rgb.shape[-2:]
    fxi, fyi, ppx, ppy = easu_index_maps(w_in, h_in, out_w, out_h, con0)
    dev = rgb.device
    taps = easu_gather(rgb, torch.from_numpy(fxi).to(dev),
                       torch.from_numpy(fyi).to(dev))
    return easu_core(taps, torch.from_numpy(ppx).to(dev)[None, :],
                     torch.from_numpy(ppy).to(dev)[:, None])
