"""Static per-build tables the fused FSR kernel reads (host numpy).

The port of the host parts of the JAX package's kernels/_band.py and
kernels/fsr.py:156-175. Every sample coordinate of the main path is
separable, so the kernel gets per-column and per-row maps instead of
evaluating any coordinate math on the device:

  col_i (2, OW) int32    EASU floor fxi, bilinear floor x0   per output column
  col_f (2, OW) float32  EASU fraction ppx, bilinear fx
  row_i (2, OH) int32    EASU floor fyi, bilinear floor y0   per output row
  row_f (2, OH) float32  EASU fraction ppy, bilinear fy
  tile_x0 / tile_y0      first input column / row of the footprint each
                         16x16 output tile (with its 1-pixel halo) stages
  centres (B, 5) int64   the foveation cbuffer rows (core.constants)

The tables depend only on the build's shapes and centres, so one build
serves every frame of a stream.
"""

import dataclasses

import numpy as np
import torch

from ..core import constants as C
from ..ops.bilinear import bilinear_axis
from ..ops.easu import easu_index_maps

__all__ = ["FsrMaps", "fsr_maps", "input_padding", "TILE", "IN_TILE"]

TILE = 16      # output tile edge: one CTA per tile, the 16x16 foveation group
IN_TILE = 24   # staged input footprint edge (csrc/fsr_fused.cu kInTile)
ROW_ALIGN = 8  # ring-pitch row alignment (kernels/_band.py ROW_ALIGN)


def input_padding(h, w):
    """(HP, WP): the pre-padded ring pitch of the JAX package's device
    frames (kernels/_band.py:97-99): rows to 8, width to 128."""
    return -(-int(h) // ROW_ALIGN) * ROW_ALIGN, -(-int(w) // 128) * 128


def _footprint_origins(lo, hi, n_out, n_in):
    """Per-tile first input index of the footprint of output indices
    [t*TILE - 1, t*TILE + TILE] (the halo), from per-output lowest/highest
    input index lo/hi. Raises if a footprint exceeds IN_TILE."""
    n_tiles = -(-n_out // TILE)
    origins = np.empty(n_tiles, np.int32)
    for t in range(n_tiles):
        a, b = max(t * TILE - 1, 0), min(t * TILE + TILE, n_out - 1)
        first, last = int(lo[a:b + 1].min()), int(hi[a:b + 1].max())
        if last - first + 1 > IN_TILE:
            raise ValueError(
                f"tile {t}: input footprint {last - first + 1} exceeds "
                f"{IN_TILE} (scale {n_out}/{n_in} outside the fused kernel's "
                f"range)")
        origins[t] = first
    return origins


@dataclasses.dataclass(frozen=True)
class FsrMaps:
    """The fused kernel's tables: numpy arrays from fsr_maps, torch tensors
    after .to(device)."""

    in_h: int
    in_w: int
    out_h: int
    out_w: int
    col_i: object
    col_f: object
    row_i: object
    row_f: object
    tile_x0: object
    tile_y0: object
    centres: object

    _ARRAYS = ("col_i", "col_f", "row_i", "row_f", "tile_x0", "tile_y0",
               "centres")

    def to(self, device):
        return dataclasses.replace(self, **{
            k: torch.as_tensor(getattr(self, k), device=device)
            for k in self._ARRAYS})


def fsr_maps(batch, in_h, in_w, out_w, out_h, centres):
    """Build the tables for one (shape, centres) configuration."""
    H, W, OH, OW = int(in_h), int(in_w), int(out_h), int(out_w)
    con = C.fsr_easu_con(W, H, W, H, OW, OH)
    fxi, fyi, ppx, ppy = easu_index_maps(W, H, OW, OH,
                                         np.asarray(con[0], np.float32))
    bx0, fbx = bilinear_axis(OW, W)
    by0, fby = bilinear_axis(OH, H)
    # lowest / highest input index any tap of each output column/row reads:
    # EASU taps fxi-1 .. fxi+2, bilinear x0 .. x0+1, all edge-clamped
    lo_x = np.minimum(np.clip(fxi - 1, 0, W - 1), np.clip(bx0, 0, W - 1))
    hi_x = np.maximum(np.clip(fxi + 2, 0, W - 1), np.clip(bx0 + 1, 0, W - 1))
    lo_y = np.minimum(np.clip(fyi - 1, 0, H - 1), np.clip(by0, 0, H - 1))
    hi_y = np.maximum(np.clip(fyi + 2, 0, H - 1), np.clip(by0 + 1, 0, H - 1))
    cen = np.asarray(centres, np.int64).reshape(int(batch), 5)
    return FsrMaps(
        in_h=H, in_w=W, out_h=OH, out_w=OW,
        col_i=np.stack([fxi.astype(np.int32), bx0]),
        col_f=np.stack([ppx, fbx]),
        row_i=np.stack([fyi.astype(np.int32), by0]),
        row_f=np.stack([ppy, fby]),
        tile_x0=_footprint_origins(lo_x, hi_x, OW, W),
        tile_y0=_footprint_origins(lo_y, hi_y, OH, H),
        centres=np.ascontiguousarray(cen))
