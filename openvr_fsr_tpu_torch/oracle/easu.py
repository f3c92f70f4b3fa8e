"""NumPy golden reference for FSR1 EASU (Edge-Adaptive Spatial Upsampling).

Literal float32 port of FsrEasuF / FsrEasuSetF / FsrEasuTapF
(reference src/fsr/ffx_fsr1.h:239-437), vectorized over output pixels.

The HLSL kernel fetches its 12 taps via four gather4s with a linear-clamp
sampler (src/fsr/fsr_easu.hlsl:21-23); the gather quads resolve to the fixed
tap footprint below, edge-clamped — so the oracle indexes the image directly:

        b c          b(0,-1)  c(1,-1)
      e f g h        e(-1,0)  f(0,0)  g(1,0)  h(2,0)
      i j k l        i(-1,1)  j(0,1)  k(1,1)  l(2,1)
        n o          n(0,2)   o(1,2)          (offsets from fp)
"""

import numpy as np

from .intrinsics import (
    F32,
    aprx_lo_rcp,
    aprx_lo_rsq,
    rcp,
    sat,
    min3,
    max3,
)

__all__ = ["easu_oracle"]

# The 12 taps in the exact accumulation order of FsrEasuF (ffx_fsr1.h:423-434).
_TAP_ORDER = [
    (0, -1),   # b
    (1, -1),   # c
    (-1, 1),   # i
    (0, 1),    # j
    (0, 0),    # f
    (-1, 0),   # e
    (1, 1),    # k
    (2, 1),    # l
    (2, 0),    # h
    (1, 0),    # g
    (1, 2),    # o
    (0, 2),    # n
]


def _easu_set(dir_x, dir_y, length, ppx, ppy, which, lA, lB, lC, lD, lE):
    """FsrEasuSetF (ffx_fsr1.h:275-313). `which` in {s,t,u,v} selects the
    bilinear weight; all other math is data-parallel."""
    one = F32(1.0)
    if which == "s":
        w = (one - ppx) * (one - ppy)
    elif which == "t":
        w = ppx * (one - ppy)
    elif which == "u":
        w = (one - ppx) * ppy
    else:
        w = ppx * ppy
    # x axis
    dc = lD - lC
    cb = lC - lB
    lenX = np.maximum(np.abs(dc), np.abs(cb))
    lenX = aprx_lo_rcp(lenX)
    dirX = lD - lB
    dir_x = dir_x + dirX * w
    lenX = sat(np.abs(dirX) * lenX)
    lenX = lenX * lenX
    length = length + lenX * w
    # y axis
    ec = lE - lC
    ca = lC - lA
    lenY = np.maximum(np.abs(ec), np.abs(ca))
    lenY = aprx_lo_rcp(lenY)
    dirY = lE - lA
    dir_y = dir_y + dirY * w
    lenY = sat(np.abs(dirY) * lenY)
    lenY = lenY * lenY
    length = length + lenY * w
    return dir_x, dir_y, length


def _easu_tap(aC, aW, off_x, off_y, dir_x, dir_y, len2_x, len2_y, lob, clp, c):
    """FsrEasuTapF (ffx_fsr1.h:239-272). c: (..., 3) tap color."""
    vx = off_x * dir_x + off_y * dir_y
    vy = off_x * (-dir_y) + off_y * dir_x
    vx = vx * len2_x
    vy = vy * len2_y
    d2 = vx * vx + vy * vy
    d2 = np.minimum(d2, clp)
    wB = F32(2.0 / 5.0) * d2 + F32(-1.0)
    wA = lob * d2 + F32(-1.0)
    wB = wB * wB
    wA = wA * wA
    wB = F32(25.0 / 16.0) * wB + F32(-(25.0 / 16.0 - 1.0))
    w = wB * wA
    return aC + c * w[..., None], aW + w


def easu_oracle(img, out_w, out_h, con=None, in_view=None):
    """EASU upscale.

    img:    (H_in, W_in, C>=3) float32 in [0,1] (UNORM-decoded texels).
    out_w/out_h: output size.
    con:    optional (con0, con1, con2, con3) from fsr_easu_con; derived from
            shapes when omitted.
    Returns (out_h, out_w, 3) float32 (the shader writes alpha=1 separately).
    """
    from ..core.constants import fsr_easu_con

    img = np.asarray(img, np.float32)
    h_in, w_in = img.shape[:2]
    if con is None:
        vw, vh = in_view or (w_in, h_in)
        con = fsr_easu_con(vw, vh, w_in, h_in, out_w, out_h)
    con0, _, _, _ = con

    ix = np.arange(out_w, dtype=np.float32)
    iy = np.arange(out_h, dtype=np.float32)
    ppx = ix * con0[0] + con0[2]            # (W,)
    ppy = iy * con0[1] + con0[3]            # (H,)
    fpx = np.floor(ppx)
    fpy = np.floor(ppy)
    ppx = (ppx - fpx)[None, :]              # (1, W)
    ppy = (ppy - fpy)[None, :].reshape(-1, 1)  # (H, 1)
    fxi = fpx.astype(np.int64)
    fyi = fpy.astype(np.int64)

    def tap(dx, dy):
        xs = np.clip(fxi + dx, 0, w_in - 1)
        ys = np.clip(fyi + dy, 0, h_in - 1)
        return img[:, :, :3].take(ys, axis=0).take(xs, axis=1)

    taps = {off: tap(*off) for off in set(_TAP_ORDER)}

    def luma(c):
        # luma*2 in 2 MADs: B*0.5 + (R*0.5 + G)   (ffx_fsr1.h:363-366)
        return c[..., 2] * F32(0.5) + (c[..., 0] * F32(0.5) + c[..., 1])

    L = {off: luma(taps[off]) for off in taps}
    bL, cL = L[(0, -1)], L[(1, -1)]
    eL, fL, gL, hL = L[(-1, 0)], L[(0, 0)], L[(1, 0)], L[(2, 0)]
    iL, jL, kL, lL = L[(-1, 1)], L[(0, 1)], L[(1, 1)], L[(2, 1)]
    nL, oL = L[(0, 2)], L[(1, 2)]

    zero = np.zeros((out_h, out_w), dtype=np.float32)
    dir_x, dir_y, length = zero, zero.copy(), zero.copy()
    dir_x, dir_y, length = _easu_set(dir_x, dir_y, length, ppx, ppy, "s", bL, eL, fL, gL, jL)
    dir_x, dir_y, length = _easu_set(dir_x, dir_y, length, ppx, ppy, "t", cL, fL, gL, hL, kL)
    dir_x, dir_y, length = _easu_set(dir_x, dir_y, length, ppx, ppy, "u", fL, iL, jL, kL, nL)
    dir_x, dir_y, length = _easu_set(dir_x, dir_y, length, ppx, ppy, "v", gL, jL, kL, lL, oL)

    # Normalize direction with the low-precision rsqrt (ffx_fsr1.h:389-395).
    dirR = dir_x * dir_x + dir_y * dir_y
    zro = dirR < F32(1.0 / 32768.0)
    dirR = aprx_lo_rsq(dirR)
    dirR = np.where(zro, F32(1.0), dirR)
    dir_x = np.where(zro, F32(1.0), dir_x)
    dir_x = dir_x * dirR
    dir_y = dir_y * dirR

    length = length * F32(0.5)
    length = length * length
    stretch = (dir_x * dir_x + dir_y * dir_y) * aprx_lo_rcp(
        np.maximum(np.abs(dir_x), np.abs(dir_y))
    )
    len2_x = F32(1.0) + (stretch - F32(1.0)) * length
    len2_y = F32(1.0) + F32(-0.5) * length
    lob = F32(0.5) + F32((1.0 / 4.0 - 0.04) - 0.5) * length
    clp = aprx_lo_rcp(lob)

    # Dering bounds from the nearest 2x2 (f, g, j, k) (ffx_fsr1.h:416-419).
    cf, cg, cj, ck = taps[(0, 0)], taps[(1, 0)], taps[(0, 1)], taps[(1, 1)]
    min4 = np.minimum(min3(cf, ck, cj), cg)
    max4 = np.maximum(max3(cf, ck, cj), cg)

    aC = np.zeros((out_h, out_w, 3), dtype=np.float32)
    aW = np.zeros((out_h, out_w), dtype=np.float32)
    for dx, dy in _TAP_ORDER:
        off_x = F32(float(dx)) - ppx
        off_y = F32(float(dy)) - ppy
        aC, aW = _easu_tap(aC, aW, off_x, off_y, dir_x, dir_y,
                           len2_x, len2_y, lob, clp, taps[(dx, dy)])

    pix = np.minimum(max4, np.maximum(min4, aC * rcp(aW)[..., None]))
    return pix
