"""Static per-build tables the kernels read (host numpy).

The port of the host parts of the JAX package's kernels/_band.py,
kernels/fsr.py:156-175 and kernels/nis.py:443-455. Every sample coordinate
is separable, so a kernel gets per-column and per-row maps instead of
evaluating coordinate math on the device. The fused FSR kernel's:

  col_i (2, OW) int32    EASU floor fxi, bilinear floor x0   per output column
  col_f (2, OW) float32  EASU fraction ppx, bilinear fx
  row_i (2, OH) int32    EASU floor fyi, bilinear floor y0   per output row
  row_f (2, OH) float32  EASU fraction ppy, bilinear fy
  tile_x0 / tile_y0      first input column / row of the footprint each
                         16x16 output tile (with its 1-pixel halo) stages
  centres (B, 5) int64   the foveation cbuffer rows (core.constants)

CAS upscale's (cas_upscale_maps) have the same layout, with the CasFilter
floor and fraction of pp in place of EASU's. NVScaler's (NisMaps) are set
out at nvscaler_maps. The tables depend
only on the build's shapes, config and centres, so one build serves every
frame of a stream.
"""

import dataclasses

import numpy as np
import torch

from ..core import constants as C
from ..core.foveation import TILE_NIS_SCALER
from ..core.nis_tables import COEF_SCALE, COEF_USM
from ..ops.bilinear import bilinear_axis, bilinear_texel_axis
from ..ops.cas import cas_upscale_index_maps
from ..ops.easu import easu_index_maps
from ..ops.nis import nis_source_maps

__all__ = ["FsrMaps", "fsr_maps", "cas_upscale_maps", "NisMaps",
           "nvscaler_maps", "input_padding", "TILE", "IN_TILE",
           "CAS_IN_TILE", "NIS_IN_TILE"]

TILE = 16      # output tile edge: one CTA per tile, the 16x16 foveation group
IN_TILE = 24   # staged input footprint edge (csrc/fsr_fused.cu kInTile)
# CAS upscale's staged footprint edge (csrc/cas_upscale.cu kInTile): out >=
# in on every path, so 16 outputs span at most 16 input positions + 3 taps
CAS_IN_TILE = 20
# NVScaler's staged luma footprint cap, (width, height), per 32x24 output
# block (csrc/nis_scaler.cu kInW, kInH)
NIS_IN_TILE = (40, 32)
ROW_ALIGN = 8  # ring-pitch row alignment (kernels/_band.py ROW_ALIGN)


def input_padding(h, w):
    """(HP, WP): the pre-padded ring pitch of the JAX package's device
    frames (kernels/_band.py:97-99): rows to 8, width to 128."""
    return -(-int(h) // ROW_ALIGN) * ROW_ALIGN, -(-int(w) // 128) * 128


def _footprint_origins(lo, hi, tile, halo, cap):
    """Per-tile first input index of the footprint of output indices
    [t*tile - halo, t*tile + tile - 1 + halo], from per-output lowest /
    highest input index lo / hi. Raises if a footprint exceeds `cap`."""
    n_out = len(lo)
    n_tiles = -(-n_out // tile)
    origins = np.empty(n_tiles, np.int32)
    for t in range(n_tiles):
        a = max(t * tile - halo, 0)
        b = min(t * tile + tile - 1 + halo, n_out - 1)
        first, last = int(lo[a:b + 1].min()), int(hi[a:b + 1].max())
        if last - first + 1 > cap:
            raise ValueError(
                f"tile {t}: input footprint {last - first + 1} exceeds the "
                f"kernel's {cap}")
        origins[t] = first
    return origins


class _Tables:
    """Host numpy tables; .to(device) gives the same with torch tensors."""

    _ARRAYS = ()

    def to(self, device):
        return dataclasses.replace(self, **{
            k: torch.as_tensor(getattr(self, k), device=device)
            for k in self._ARRAYS})


@dataclasses.dataclass(frozen=True)
class FsrMaps(_Tables):
    """The fused kernel's tables (and CAS upscale's): numpy arrays from
    fsr_maps or cas_upscale_maps, torch tensors after .to(device)."""

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
        tile_x0=_footprint_origins(lo_x, hi_x, TILE, 1, IN_TILE),
        tile_y0=_footprint_origins(lo_y, hi_y, TILE, 1, IN_TILE),
        centres=np.ascontiguousarray(cen))


def cas_upscale_maps(batch, in_h, in_w, out_w, out_h, centres):
    """CAS upscale's tables for one (shape, centres) configuration: row 0
    of col_i / col_f / row_i / row_f is the CasFilter floor and fraction of
    pp (ops/cas.py::cas_upscale_index_maps), row 1 the bilinear fallback's
    floor and fraction (the JAX package's kernels/cas.py:97-100).

    Unlike EASU's, CAS taps are not clamped into the image: a tap at
    floor-1 < 0 or floor+2 >= the size reads 0 (CasLoad). So a footprint
    may start at -2 and the kernel stages zeros there; only the bilinear
    taps clamp."""
    H, W, OH, OW = int(in_h), int(in_w), int(out_h), int(out_w)
    fxi, ppx = cas_upscale_index_maps(W, OW)
    fyi, ppy = cas_upscale_index_maps(H, OH)
    bx0, fbx = bilinear_axis(OW, W)
    by0, fby = bilinear_axis(OH, H)
    # lowest / highest input index any tap of each output column/row reads:
    # CAS taps fxi-1 .. fxi+2 as they are, bilinear x0 .. x0+1 edge-clamped
    lo_x = np.minimum(fxi - 1, np.clip(bx0, 0, W - 1))
    hi_x = np.maximum(fxi + 2, np.clip(bx0 + 1, 0, W - 1))
    lo_y = np.minimum(fyi - 1, np.clip(by0, 0, H - 1))
    hi_y = np.maximum(fyi + 2, np.clip(by0 + 1, 0, H - 1))
    cen = np.asarray(centres, np.int64).reshape(int(batch), 5)
    return FsrMaps(
        in_h=H, in_w=W, out_h=OH, out_w=OW,
        col_i=np.stack([fxi.astype(np.int32), bx0]),
        col_f=np.stack([ppx, fbx]),
        row_i=np.stack([fyi.astype(np.int32), by0]),
        row_f=np.stack([ppy, fby]),
        tile_x0=_footprint_origins(lo_x, hi_x, TILE, 0, CAS_IN_TILE),
        tile_y0=_footprint_origins(lo_y, hi_y, TILE, 0, CAS_IN_TILE),
        centres=np.ascontiguousarray(cen))


@dataclasses.dataclass(frozen=True)
class NisMaps(_Tables):
    """NVScaler's tables: numpy arrays from nvscaler_maps, torch tensors
    after .to(device).

      col_i (4, OW) int32    source floor pxi (NIS_Scaler.h:682), phase
                             fx_int = trunc(fx*64), RGBA-tap floor x0 at
                             u = (x+0.5)*kDstNormX, DirectCopy floor x0 at
                             u = x/OW (NIS_Upscale.hlsl:77-90)
      col_f (3, OW) float32  fx, RGBA-tap fraction, DirectCopy fraction
      row_i / row_f          the same per output row
      tile_x0 / tile_y0      first input column / row of the luma footprint
                             (6x6 taps) of each 32x24 output block
      centres (B, 5) int64   the foveation cbuffer rows
      coef (2, 64, 8) f32    COEF_SCALE, COEF_USM (core/nis_tables.py)
    """

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
    coef: object

    _ARRAYS = ("col_i", "col_f", "row_i", "row_f", "tile_x0", "tile_y0",
               "centres", "coef")


def _nis_axis(src_i, frac, u_tap, n_out, n_in, tile, cap):
    """One axis of NVScaler's maps: (int rows, float rows, footprint
    origins), sized from the maps themselves, so any scale the config
    admits (valid or not) runs or raises here."""
    phase = (frac * np.float32(64)).astype(np.int32)
    t0, tf = bilinear_texel_axis(u_tap, n_in)
    b0, bf = bilinear_axis(n_out, n_in)
    ints = np.stack([src_i.astype(np.int32), phase, t0, b0])
    floats = np.stack([frac, tf, bf]).astype(np.float32)
    lo = np.clip(src_i - 2, 0, n_in - 1)
    hi = np.clip(src_i + 3, 0, n_in - 1)
    return ints, floats, _footprint_origins(lo, hi, tile, 0, cap)


def nvscaler_maps(batch, in_h, in_w, out_w, out_h, nis_cfg, centres):
    """Build NVScaler's tables for one (shape, config, centres)."""
    H, W, OH, OW = int(in_h), int(in_w), int(out_h), int(out_w)
    pxi, pyi, fx, fy = nis_source_maps(OW, OH, nis_cfg)
    u = (np.arange(OW, dtype=np.float32) + np.float32(0.5)) * nis_cfg.kDstNormX
    v = (np.arange(OH, dtype=np.float32) + np.float32(0.5)) * nis_cfg.kDstNormY
    (tw, th), (cap_w, cap_h) = TILE_NIS_SCALER, NIS_IN_TILE
    col_i, col_f, tile_x0 = _nis_axis(pxi, fx, u, OW, W, tw, cap_w)
    row_i, row_f, tile_y0 = _nis_axis(pyi, fy, v, OH, H, th, cap_h)
    cen = np.asarray(centres, np.int64).reshape(int(batch), 5)
    return NisMaps(
        in_h=H, in_w=W, out_h=OH, out_w=OW, col_i=col_i, col_f=col_f,
        row_i=row_i, row_f=row_f, tile_x0=tile_x0, tile_y0=tile_y0,
        centres=np.ascontiguousarray(cen),
        coef=np.ascontiguousarray(np.stack([COEF_SCALE, COEF_USM]),
                                  np.float32))
