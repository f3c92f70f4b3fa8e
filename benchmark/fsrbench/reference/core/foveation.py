"""Foveated-radius tile predicate.

The reference shaders run the expensive kernel only for workgroups whose
centre lies within `radius` of either eye's projection centre, and a cheap
bilinear/copy path outside (src/fsr/fsr_easu.hlsl:41-63,
src/nis/NIS_Upscale.hlsl:95-107, NIS_Sharpen.hlsl:93-105).

Predicate (HLSL): dc = Centre - groupCentre in *uint* arithmetic; inside iff
dot(dc, dc) <= Radius.y (= floor(r_px^2)). Unsigned wraparound squaring is
congruent mod 2^32 to signed squaring, and for any realistic image size the
true signed dot fits in 32 bits, so signed int64 math below is exact.

Tile geometry per stage, (width, height):
  FSR EASU / RCAS:  16x16 px tiles, centre +(8, 8)
  NIS scaler:       32x24 tiles,    centre +(16, 12)
  NIS sharpen:      32x32 tiles,    centre +(16, 16)

A copy of openvr_fsr_tpu/core/foveation.py (the port cannot import that
package: its __init__ imports jax); tests/test_torch_core.py holds the two
equal.
"""

import numpy as np

__all__ = ["tile_mask", "pixel_mask", "nis_optimal_block",
           "TILE_FSR", "TILE_NIS_SCALER", "TILE_NIS_SHARPEN"]

TILE_FSR = (16, 16)
TILE_NIS_SCALER = (32, 24)
TILE_NIS_SHARPEN = (32, 32)


def nis_optimal_block(is_upscaling=True, gpu_arch="nvidia"):
    """NISOptimizer port (src/nis/NIS_Config.h:81-141): the dispatch
    block geometry NIS advertises per GPU architecture.

    Returns ((block_w, block_h), thread_group_size). Every architecture
    the reference enumerates (NVIDIA/AMD/Intel generic) resolves to the
    same 32x24 (upscale) / 32x32 (sharpen) blocks with 256 threads, which
    is why the tiles above are fixed constants."""
    if gpu_arch not in ("nvidia", "amd", "intel"):
        raise ValueError(f"unknown gpu_arch {gpu_arch!r}")
    return (TILE_NIS_SCALER if is_upscaling else TILE_NIS_SHARPEN), 256


def tile_mask(out_w, out_h, tile, centres, radius_sq):
    """Boolean (tiles_y, tiles_x): True = run the expensive kernel.

    centres: ((cx1, cy1), (cx2, cy2)) — the Centre.xy / Centre.zw uint pairs.
    radius_sq: Radius.y (already floor(r_px^2))."""
    tw, th = tile
    tx = -(-out_w // tw)
    ty = -(-out_h // th)
    gx = np.arange(tx, dtype=np.int64) * tw + tw // 2
    gy = np.arange(ty, dtype=np.int64) * th + th // 2
    gxx, gyy = np.meshgrid(gx, gy)
    mask = np.zeros((ty, tx), dtype=bool)
    for cx, cy in centres:
        dx = np.int64(cx) - gxx
        dy = np.int64(cy) - gyy
        mask |= (dx * dx + dy * dy) <= np.int64(radius_sq)
    return mask


def pixel_mask(out_w, out_h, tile, centres, radius_sq):
    """Per-pixel expansion of tile_mask, cropped to (out_h, out_w)."""
    tw, th = tile
    m = tile_mask(out_w, out_h, tile, centres, radius_sq)
    return np.repeat(np.repeat(m, th, axis=0), tw, axis=1)[:out_h, :out_w]
