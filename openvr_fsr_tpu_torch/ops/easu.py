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

from .common import (aprx_lo_rcp, aprx_lo_rsq, rcp, sat, min3, max3,
                     strip_rows)

__all__ = ["easu", "easu_core", "easu_index_maps", "TAP_ORDER"]

# exact FsrEasuF accumulation order (ffx_fsr1.h:423-434)
TAP_ORDER = [
    (0, -1), (1, -1), (-1, 1), (0, 1), (0, 0), (-1, 0),
    (1, 1), (2, 1), (2, 0), (1, 0), (1, 2), (0, 2),
]

# f32 values of the FsrEasuTapF / FsrEasuF literals, as Python floats
_K_LOB = float(np.float32((1.0 / 4.0 - 0.04) - 0.5))
_K_WB = float(np.float32(2.0 / 5.0))
_K_W25 = float(np.float32(25.0 / 16.0))
_K_W25M = float(np.float32(-(25.0 / 16.0 - 1.0)))
_K_DIRMIN = float(np.float32(1.0 / 32768.0))


def _easu_weights(L, ppx, ppy):
    """Direction/anisotropy analysis from the luma dict L
    (ffx_fsr1.h:368-421). Returns tap_w, the per-tap weight function."""
    bL, cL = L[(0, -1)], L[(1, -1)]
    eL, fL, gL, hL = L[(-1, 0)], L[(0, 0)], L[(1, 0)], L[(2, 0)]
    iL, jL, kL, lL = L[(-1, 1)], L[(0, 1)], L[(1, 1)], L[(2, 1)]
    nL, oL = L[(0, 2)], L[(1, 2)]

    def easu_set(acc, w, lA, lB, lC, lD, lE):
        dir_x, dir_y, length = acc
        dc = lD - lC
        cb = lC - lB
        lenX = aprx_lo_rcp(torch.maximum(torch.abs(dc), torch.abs(cb)))
        dirX = lD - lB
        dir_x = dir_x + dirX * w
        lenX = sat(torch.abs(dirX) * lenX)
        length = length + (lenX * lenX) * w
        ec = lE - lC
        ca = lC - lA
        lenY = aprx_lo_rcp(torch.maximum(torch.abs(ec), torch.abs(ca)))
        dirY = lE - lA
        dir_y = dir_y + dirY * w
        lenY = sat(torch.abs(dirY) * lenY)
        length = length + (lenY * lenY) * w
        return dir_x, dir_y, length

    z = torch.zeros_like(fL)
    acc = (z, z, z)
    acc = easu_set(acc, (1.0 - ppx) * (1.0 - ppy), bL, eL, fL, gL, jL)
    acc = easu_set(acc, ppx * (1.0 - ppy), cL, fL, gL, hL, kL)
    acc = easu_set(acc, (1.0 - ppx) * ppy, fL, iL, jL, kL, nL)
    acc = easu_set(acc, ppx * ppy, gL, jL, kL, lL, oL)
    dir_x, dir_y, length = acc

    dirR = dir_x * dir_x + dir_y * dir_y
    zro = dirR < _K_DIRMIN
    dirR = aprx_lo_rsq(dirR)
    dirR = torch.where(zro, 1.0, dirR)
    dir_x = torch.where(zro, 1.0, dir_x)
    dir_x = dir_x * dirR
    dir_y = dir_y * dirR

    length = length * 0.5
    length = length * length
    stretch = (dir_x * dir_x + dir_y * dir_y) * aprx_lo_rcp(
        torch.maximum(torch.abs(dir_x), torch.abs(dir_y)))
    len2_x = 1.0 + (stretch - 1.0) * length
    len2_y = 1.0 + -0.5 * length
    lob = 0.5 + _K_LOB * length
    clp = aprx_lo_rcp(lob)

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
        wB = _K_WB * d2 + -1.0
        wA = lob * d2 + -1.0
        wB = wB * wB
        wA = wA * wA
        wB = _K_W25 * wB + _K_W25M
        return wB * wA

    return tap_w


def easu_core(taps, ppx, ppy):
    """The FsrEasuF math after the 12 taps are gathered (ffx_fsr1.h:363-437).

    taps: dict (dx, dy) -> (..., 3, h, w) f32 tensors for the 12 offsets in
    TAP_ORDER. ppx/ppy: fractional coordinates broadcastable against
    (h, w), typically (1, w) and (h, 1). Returns the dering-clamped
    (..., 3, h, w) RGB."""
    L = {}
    for off, c in taps.items():
        r, g, b = c.unbind(-3)
        L[off] = b * 0.5 + (r * 0.5 + g)    # luma*2 (ffx_fsr1.h:363-366)
    tap_w = _easu_weights(L, ppx, ppy)

    cf, cg, cj, ck = taps[(0, 0)], taps[(1, 0)], taps[(0, 1)], taps[(1, 1)]
    min4 = torch.minimum(min3(cf, ck, cj), cg)
    max4 = torch.maximum(max3(cf, ck, cj), cg)

    aC = torch.zeros_like(cf)
    aW = torch.zeros_like(L[(0, 0)])
    for dx, dy in TAP_ORDER:
        w = tap_w(dx, dy)
        aC = aC + taps[(dx, dy)] * w.unsqueeze(-3)
        aW = aW + w
    # the resolve multiplies by the reciprocal (ARcpF1, ffx_fsr1.h:434)
    return torch.minimum(max4, torch.maximum(min4, aC * rcp(aW).unsqueeze(-3)))


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
