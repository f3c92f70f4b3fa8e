"""Static per-build tables the kernels read (host numpy).

The port of the host parts of the JAX package's kernels/_band.py,
kernels/fsr.py:156-175 and kernels/nis.py:443-455. Every sample coordinate
is separable, so a kernel gets per-column and per-row maps instead of
evaluating coordinate math on the device. The fused FSR kernel's:

  col_i (2, OW) int32    EASU floor fxi, bilinear floor x0   per output column
  col_f (2, OW) float32  EASU fraction ppx, bilinear fx
  row_i (2, OH) int32    EASU floor fyi, bilinear floor y0   per output row
  row_f (2, OH) float32  EASU fraction ppy, bilinear fy
  tile_x0 / tile_y0      first input column / row (before the edge clamp;
                         may be -1 or -2) of the window each 32x32 output
                         tile (with its 1-pixel halo) stages, edge-clamped
  centres (B, 5) int64   the foveation cbuffer rows (core.constants)
  group_cls (B, GY, GX)  int32 1 where the 16x16 foveation group passes the
                         reference's circle test, else 0
  inside_tiles           int32 ids b * TY * TX + ty * TX + tx of the 32x32
                         tiles with an output inside the circle; the EASU
                         kernel walks them
  outside_tiles          the other tiles (every output outside), in the
                         same order; the bilinear pass runs them

The foveation test is evaluated here, once per build, in int64 from the
same rows as the plain version's (kernels/_common.py::circle_mask), so the
device does no int64 arithmetic. CAS upscale's (cas_upscale_maps) have the
same layout, with the CasFilter floor and fraction of pp in place of
EASU's, 36x36 windows and the same classes and tile lists. NVScaler's
(NisMaps) are set out at nvscaler_maps. The sharpen-only class kernels
(RCAS sharpen, CAS sharpen, NVSharpen: SharpenMaps) need only the classes
and the lists of their 32x32 tiles (sharpen_maps). The tables depend only
on the build's shapes, config and centres, so one build serves every frame
of a stream.

A row-band strip of B1 or B5 (the JAX builders' band_range) keeps the full
image's tables and restricts the tile lists to the 32-row tiles that
overlap the band's output rows; band_strip finds the input rows those
tiles read, which the strip must hold, and band_geometry the strip
kernels' DMA geometry (a band form: the floor loads what each band tile
loads and stores only the band's rows).

Every build also publishes its DMA geometry (dma_geometry,
sharpen_geometry): what its CUDA kernel loads from the frame and stores,
which kernels/sol.py::build_dma_floor turns into the kernel's
zero-compute floor. The geometry is in 4-byte words: one per RGBA8 texel,
two per R10G10B10A2 texel (word_geometry).
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

__all__ = ["FsrMaps", "fsr_maps", "cas_upscale_maps", "band_strip",
           "band_layout", "band_output_rows",
           "NisMaps", "nvscaler_maps", "SharpenMaps", "sharpen_maps",
           "input_padding", "dma_geometry", "sharpen_geometry",
           "word_geometry", "band_geometry",
           "group_classes", "tile_lists", "launch_work", "analysed_texels",
           "TILE", "FSR_TILE",
           "IN_TILE", "CAS_IN_TILE", "NIS_TILE", "NIS_IN_TILE", "NIS_EDGE_TILE",
           "SHARPEN_TILE", "CAS_SHARPEN_IN_TILE", "NIS_SHARPEN_IN_TILE",
           "THREADS"]

THREADS = 256  # threads per CTA of every kernel (csrc/*.cu kThreads)
TILE = 16      # the 16x16 foveation group of FSR and CAS
# the fused FSR kernel's CTA output tile edge (2x2 foveation groups) and
# its staged input window edge (csrc/fsr_fused.cu kTile, kWin): 34 haloed
# outputs span at most 34 inputs + 3 taps + 1 when out >= in, as on every
# FSR path
FSR_TILE = 32
IN_TILE = 40
# CAS upscale's staged window edge per FSR_TILE output tile (csrc/
# cas_upscale.cu kWin): out >= in on every path, so 32 outputs span at most
# 32 input positions + 3 taps + 1
CAS_IN_TILE = 36
# NVScaler's CTA output tile, two stacked 32x24 foveation blocks, (width,
# height) (csrc/nis_scaler.cu kTileW, kTileH); its staged luma window cap
# (kWinW, kWinH: at a scale <= 1, 48 rows span at most 47 + 6 inputs); and
# the cap of the edge-map extent its 2x2 edge taps read (kEdgeW, kEdgeH)
NIS_TILE = (32, 48)
NIS_IN_TILE = (40, 56)
NIS_EDGE_TILE = (36, 52)
# the sharpen-only class kernels' CTA tile edge (csrc/cas_sharpen.cu kTile,
# nis_sharpen.cu kBlock) and their staged windows' edges (kWin): CAS's 3x3
# taps, NVSharpen's +-2 luma support
SHARPEN_TILE = 32
CAS_SHARPEN_IN_TILE = SHARPEN_TILE + 2
NIS_SHARPEN_IN_TILE = SHARPEN_TILE + 4
ROW_ALIGN = 8  # ring-pitch row alignment (kernels/_band.py ROW_ALIGN)


def input_padding(h, w):
    """(HP, WP): the pre-padded ring pitch of the JAX package's device
    frames (kernels/_band.py:97-99): rows to 8, width to 128."""
    return -(-int(h) // ROW_ALIGN) * ROW_ALIGN, -(-int(w) // 128) * 128


def _footprints(lo, hi, tile, halo, cap, what="input footprint"):
    """Per-tile (first, last) input index, (2, n_tiles) int32, of the
    footprint of output indices [t*tile - halo, t*tile + tile - 1 + halo],
    from per-output lowest / highest input index lo / hi. Raises if a
    footprint exceeds `cap`."""
    n_out = len(lo)
    n_tiles = -(-n_out // tile)
    out = np.empty((2, n_tiles), np.int32)
    for t in range(n_tiles):
        a = max(t * tile - halo, 0)
        b = min(t * tile + tile - 1 + halo, n_out - 1)
        first, last = int(lo[a:b + 1].min()), int(hi[a:b + 1].max())
        if last - first + 1 > cap:
            raise ValueError(
                f"tile {t}: {what} {last - first + 1} exceeds the "
                f"kernel's {cap}")
        out[:, t] = first, last
    return out


def _footprint_origins(lo, hi, tile, halo, cap):
    """Per-tile first input index of _footprints."""
    return _footprints(lo, hi, tile, halo, cap)[0]


class _Tables:
    """Host numpy tables; .to(device) gives the same with torch tensors."""

    _ARRAYS = ()

    def to(self, device):
        return dataclasses.replace(self, **{
            k: torch.as_tensor(getattr(self, k), device=device)
            for k in self._ARRAYS})


@dataclasses.dataclass(frozen=True)
class FsrMaps(_Tables):
    """The fused kernel's tables and CAS upscale's: numpy arrays from
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
    group_cls: object
    inside_tiles: object
    outside_tiles: object

    _ARRAYS = ("col_i", "col_f", "row_i", "row_f", "tile_x0", "tile_y0",
               "centres", "group_cls", "inside_tiles", "outside_tiles")

    @property
    def tile_inside(self):
        """(B, TY, TX) bool: the tiles the inside kernel runs."""
        return _tile_flags(self.inside_tiles, (
            self.group_cls.shape[0], len(self.tile_y0), len(self.tile_x0)))


def group_classes(centres, out_h, out_w, group=(TILE, TILE)):
    """(B, GY, GX) bool: the reference's circle test per (width, height)
    group (fsr_easu.hlsl:41-45, NIS_Upscale.hlsl:95-107; kernels/_common.py::
    circle_mask at one pixel of each group), in int64 from the (B, 5)
    centres rows."""
    (tw, th), c = group, np.asarray(centres, np.int64)[:, :, None, None]
    gx = np.arange(-(-int(out_w) // tw), dtype=np.int64) * tw + tw // 2
    gy = np.arange(-(-int(out_h) // th), dtype=np.int64) * th + th // 2
    d1 = (c[:, 0] - gx) ** 2 + (c[:, 1] - gy[:, None]) ** 2
    d2 = (c[:, 2] - gx) ** 2 + (c[:, 3] - gy[:, None]) ** 2
    return (d1 <= c[:, 4]) | (d2 <= c[:, 4])


def tile_lists(cls, out_h, out_w, tile=(FSR_TILE, FSR_TILE),
               group=(TILE, TILE)):
    """(inside, outside) int32 tile ids b * TY * TX + ty * TX + tx of the
    (width, height) `tile`s, each a whole number of `group`s: inside where
    any of the tile's groups passes the circle test (cls, from
    group_classes at `group`), outside where none does."""
    (tw, th), (gw, gh) = tile, group
    kx, ky = tw // gw, th // gh
    b, gy, gx = cls.shape
    ty, tx = -(-int(out_h) // th), -(-int(out_w) // tw)
    pad = np.zeros((b, ty * ky, tx * kx), bool)
    pad[:, :gy, :gx] = cls
    inside = pad.reshape(b, ty, ky, tx, kx).any(axis=(2, 4)).ravel()
    return (np.flatnonzero(inside).astype(np.int32),
            np.flatnonzero(~inside).astype(np.int32))


def launch_work(cls, group, out_h, out_w, n_inside, n_outside, rows=None):
    """What one call of a class-kernel build computes, which kernels/
    _common.py::kernel_fn publishes in its launch records: the CUDA kernels
    its C entry point enqueues (one per non-empty tile list) and its
    outputs by class, `inside` those of the (width, height) `group`s that
    cls (group_classes) marks inside the circle, `outside` the rest (by
    the bilinear or the copy pass), counted in the output rows
    rows = (r0, r1) (a strip's; default every row) of the image."""
    (gw, gh), oh, ow = group, int(out_h), int(out_w)
    r0, r1 = (0, oh) if rows is None else (int(rows[0]), int(rows[1]))
    gy = np.arange(r0, r1) // gh
    cols = np.bincount(np.arange(ow) // gw, minlength=cls.shape[2])
    per_row = np.asarray(cls, bool) @ cols           # (B, GY) outputs a row
    inside = int(per_row[:, gy].sum())
    return {"kernels": int(n_inside > 0) + int(n_outside > 0),
            "inside": inside,
            "outside": cls.shape[0] * (r1 - r0) * ow - inside}


def analysed_texels(maps):
    """The input positions whose EASU analysis terms one launch of a B1
    build computes (its launch work's `analysed`): per inside tile, the
    quadrant centres fi + 0 and fi + 1 (fi the EASU floor, row_i[0] and
    col_i[0]) of its haloed outputs in the image, which csrc/fsr_fused.cu
    (tile_spans) bounds by the floors of the first and last of them (a
    floor map is nondecreasing): (last - first + 2) columns times as many
    rows."""
    def spans(fi, n_out):
        t = np.arange(-(-n_out // FSR_TILE)) * FSR_TILE
        fi = np.asarray(fi, np.int64)
        last, first = np.minimum(t + FSR_TILE, n_out - 1), np.maximum(t - 1, 0)
        return fi[last] - fi[first] + 2

    sx, sy = spans(maps.col_i[0], maps.out_w), spans(maps.row_i[0], maps.out_h)
    tile = np.asarray(maps.inside_tiles) % (len(sy) * len(sx))
    return int((sy[tile // len(sx)] * sx[tile % len(sx)]).sum())


def _tile_flags(ids, shape):
    """(B, TY, TX) bool: True at the tile ids `ids`."""
    flags = np.zeros(int(np.prod(shape)), bool)
    flags[np.asarray(ids)] = True
    return flags.reshape(shape)


def fsr_maps(batch, in_h, in_w, out_w, out_h, centres):
    """Build the fused kernel's tables for one (shape, centres)
    configuration."""
    H, W, OH, OW = int(in_h), int(in_w), int(out_h), int(out_w)
    con = C.fsr_easu_con(W, H, W, H, OW, OH)
    fxi, fyi, ppx, ppy = easu_index_maps(W, H, OW, OH,
                                         np.asarray(con[0], np.float32))
    bx0, fbx = bilinear_axis(OW, W)
    by0, fby = bilinear_axis(OH, H)
    # lowest / highest input index any tap of each output column/row reads
    # before its edge clamp: EASU taps fxi-1 .. fxi+2, bilinear x0 .. x0+1
    # (the kernel stages its windows edge-clamped and reads them unclamped)
    lo_x = np.minimum(fxi - 1, bx0)
    hi_x = np.maximum(fxi + 2, bx0 + 1)
    lo_y = np.minimum(fyi - 1, by0)
    hi_y = np.maximum(fyi + 2, by0 + 1)
    cen = np.asarray(centres, np.int64).reshape(int(batch), 5)
    cls = group_classes(cen, OH, OW)
    inside, outside = tile_lists(cls, OH, OW)
    return FsrMaps(
        in_h=H, in_w=W, out_h=OH, out_w=OW,
        col_i=np.stack([fxi.astype(np.int32), bx0]),
        col_f=np.stack([ppx, fbx]),
        row_i=np.stack([fyi.astype(np.int32), by0]),
        row_f=np.stack([ppy, fby]),
        tile_x0=_footprint_origins(lo_x, hi_x, FSR_TILE, 1, IN_TILE),
        tile_y0=_footprint_origins(lo_y, hi_y, FSR_TILE, 1, IN_TILE),
        centres=np.ascontiguousarray(cen),
        group_cls=cls.astype(np.int32), inside_tiles=inside,
        outside_tiles=outside)


def cas_upscale_maps(batch, in_h, in_w, out_w, out_h, centres):
    """CAS upscale's tables for one (shape, centres) configuration: row 0
    of col_i / col_f / row_i / row_f is the CasFilter floor and fraction of
    pp (ops/cas.py::cas_upscale_index_maps), row 1 the bilinear fallback's
    floor and fraction (the JAX package's kernels/cas.py:97-100); the
    foveation classes and tile lists are fsr_maps' (CAS's group is FSR's
    16x16), with CAS_IN_TILE windows per FSR_TILE tile.

    Unlike EASU's, CAS taps are not clamped into the image: a tap at
    floor-1 < 0 or floor+2 >= the size reads 0 (CasLoad). So a window
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
    cls = group_classes(cen, OH, OW)
    inside, outside = tile_lists(cls, OH, OW)
    return FsrMaps(
        in_h=H, in_w=W, out_h=OH, out_w=OW,
        col_i=np.stack([fxi.astype(np.int32), bx0]),
        col_f=np.stack([ppx, fbx]),
        row_i=np.stack([fyi.astype(np.int32), by0]),
        row_f=np.stack([ppy, fby]),
        tile_x0=_footprint_origins(lo_x, hi_x, FSR_TILE, 0, CAS_IN_TILE),
        tile_y0=_footprint_origins(lo_y, hi_y, FSR_TILE, 0, CAS_IN_TILE),
        centres=np.ascontiguousarray(cen),
        group_cls=cls.astype(np.int32), inside_tiles=inside,
        outside_tiles=outside)


def band_layout(out_w, out_h, band_rows, scratch_bytes, chunk=128):
    """(TH, GY): the JAX builders' output band height and band count
    (kernels/fsr.py:178-189, kernels/cas.py:56-64): band_rows (any multiple
    of 8, or at least out_h; else ValueError) halved while it is above 32
    and scratch_bytes(band_rows, padded width) exceeds 24 MiB, the JAX
    kernel's VMEM budget, whose band splits parallel/spatial.py follows."""
    oh, ow, br = int(out_h), int(out_w), int(band_rows)
    if br <= 0 or (br % ROW_ALIGN and br < oh):
        raise ValueError(f"band_rows={band_rows!r}: a multiple of "
                         f"{ROW_ALIGN}, or at least out_h ({oh})")
    owp = -(-ow // int(chunk)) * int(chunk)
    while br > 32 and scratch_bytes(br, owp) > 24 * 2**20:
        br //= 2
    th = oh if oh <= br else br
    return th, -(-oh // th)


def band_output_rows(th, gy, out_h, band_range):
    """The output rows [g0 * th, min(g1 * th, out_h)) of bands
    band_range = (g0, g1) of a (th, gy) band_layout; ValueError unless
    0 <= g0 < g1 <= gy."""
    g0, g1 = (int(g) for g in band_range)
    if not 0 <= g0 < g1 <= gy:
        raise ValueError(f"band_range={tuple(band_range)!r}: need 0 <= g0 "
                         f"< g1 <= {gy} bands")
    return g0 * th, min(g1 * th, int(out_h))


def band_strip(maps, rows, window, oob):
    """The strip of the output rows [r0, r1) = `rows` of a B1 or B5 build:
    (maps with the tile lists restricted to the FSR_TILE tile rows that
    overlap the band, in_row_base, in_rows), the strip the first input row
    and the number of rows that those tiles read. An inside tile reads its
    `window`-row window from tile_y0 (oob "clamp": edge-clamped into the
    image, B1; "zero": the rows inside the image, B5), an outside tile the
    two edge-clamped bilinear rows (row_i[1], + 1) of each of its outputs
    in the band. The whole output is the whole image: (maps, 0, in_h)."""
    m = maps
    r0, r1 = int(rows[0]), int(rows[1])
    if not 0 <= r0 < r1 <= m.out_h:
        raise ValueError(f"band rows [{r0}, {r1}) outside [0, {m.out_h})")
    if (r0, r1) == (0, m.out_h):
        return m, 0, m.in_h
    n_ty, n_tx = len(m.tile_y0), len(m.tile_x0)
    t0, t1 = r0 // FSR_TILE, -(-r1 // FSR_TILE)

    def tile_rows(ids):
        return ids % (n_ty * n_tx) // n_tx

    def band(ids):
        ty = tile_rows(ids)
        return np.ascontiguousarray(ids[(ty >= t0) & (ty < t1)])

    inside, outside = band(m.inside_tiles), band(m.outside_tiles)
    h = m.in_h
    lo, hi = [], []
    for ty in np.unique(tile_rows(inside)):
        y0 = int(m.tile_y0[ty])
        a, b = y0, y0 + int(window) - 1
        lo.append(min(max(a, 0), h - 1) if oob == "clamp" else max(a, 0))
        hi.append(min(max(b, 0), h - 1) if oob == "clamp" else min(b, h - 1))
    for ty in np.unique(tile_rows(outside)):
        oy = np.arange(max(r0, ty * FSR_TILE), min(r1, (ty + 1) * FSR_TILE))
        y0 = np.asarray(m.row_i[1])[oy]
        lo.append(int(np.clip(y0, 0, h - 1).min()))
        hi.append(int(np.clip(y0 + 1, 0, h - 1).max()))
    base = min(lo)
    return (dataclasses.replace(m, inside_tiles=inside, outside_tiles=outside),
            base, max(hi) - base + 1)


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
      tile_x0 / tile_y0      first input column / row of the luma window
                             (the 6x6 taps and the edge map's 3x3s) of
                             each NIS_TILE output tile
      edge_x / edge_y (2, n) int32 first and last input column / row the
                             2x2 edge taps of each tile's outputs read,
                             clip(pxi .. pxi + 1): where the kernel
                             computes the edge map
      centres (B, 5) int64   the foveation cbuffer rows
      block_cls (B, BY, BX)  int32 1 where the 32x24 block passes the
                             reference's circle test (NIS_Upscale.hlsl:
                             95-107), else 0
      inside_tiles           int32 ids b * TY * TX + ty * TX + tx of the
                             NIS_TILE tiles with a block inside the circle
      outside_tiles          the others, for the DirectCopy pass
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
    edge_x: object
    edge_y: object
    centres: object
    block_cls: object
    inside_tiles: object
    outside_tiles: object
    coef: object

    _ARRAYS = ("col_i", "col_f", "row_i", "row_f", "tile_x0", "tile_y0",
               "edge_x", "edge_y", "centres", "block_cls", "inside_tiles",
               "outside_tiles", "coef")

    @property
    def tile_inside(self):
        """(B, TY, TX) bool: the tiles the inside kernel runs."""
        return _tile_flags(self.inside_tiles, (
            self.block_cls.shape[0], len(self.tile_y0), len(self.tile_x0)))


def _nis_axis(src_i, frac, u_tap, n_out, n_in, tile, cap, edge_cap):
    """One axis of NVScaler's maps: (int rows, float rows, window origins,
    edge extents), sized from the maps themselves, so any scale the config
    admits (valid or not) runs or raises here. The window holds the 6x6
    taps clip(src - 2 .. src + 3) and the edge map's 3x3s at the 2x2 edge
    taps, clip(clip(src .. src + 1) +- 1)."""
    phase = (frac * np.float32(64)).astype(np.int32)
    t0, tf = bilinear_texel_axis(u_tap, n_in)
    b0, bf = bilinear_axis(n_out, n_in)
    ints = np.stack([src_i.astype(np.int32), phase, t0, b0])
    floats = np.stack([frac, tf, bf]).astype(np.float32)
    e0 = np.clip(src_i, 0, n_in - 1)
    e1 = np.clip(src_i + 1, 0, n_in - 1)
    lo = np.minimum(np.clip(src_i - 2, 0, n_in - 1),
                    np.clip(e0 - 1, 0, n_in - 1))
    hi = np.maximum(np.clip(src_i + 3, 0, n_in - 1),
                    np.clip(e1 + 1, 0, n_in - 1))
    return (ints, floats, _footprint_origins(lo, hi, tile, 0, cap),
            _footprints(e0, e1, tile, 0, edge_cap, "edge-map extent"))


def nvscaler_maps(batch, in_h, in_w, out_w, out_h, nis_cfg, centres):
    """Build NVScaler's tables for one (shape, config, centres)."""
    H, W, OH, OW = int(in_h), int(in_w), int(out_h), int(out_w)
    pxi, pyi, fx, fy = nis_source_maps(OW, OH, nis_cfg)
    u = (np.arange(OW, dtype=np.float32) + np.float32(0.5)) * nis_cfg.kDstNormX
    v = (np.arange(OH, dtype=np.float32) + np.float32(0.5)) * nis_cfg.kDstNormY
    (tw, th), (cap_w, cap_h), (ecap_w, ecap_h) = (NIS_TILE, NIS_IN_TILE,
                                                  NIS_EDGE_TILE)
    col_i, col_f, tile_x0, edge_x = _nis_axis(pxi, fx, u, OW, W, tw, cap_w,
                                              ecap_w)
    row_i, row_f, tile_y0, edge_y = _nis_axis(pyi, fy, v, OH, H, th, cap_h,
                                              ecap_h)
    cen = np.asarray(centres, np.int64).reshape(int(batch), 5)
    cls = group_classes(cen, OH, OW, TILE_NIS_SCALER)
    inside, outside = tile_lists(cls, OH, OW, NIS_TILE, TILE_NIS_SCALER)
    return NisMaps(
        in_h=H, in_w=W, out_h=OH, out_w=OW, col_i=col_i, col_f=col_f,
        row_i=row_i, row_f=row_f, tile_x0=tile_x0, tile_y0=tile_y0,
        edge_x=edge_x, edge_y=edge_y, centres=np.ascontiguousarray(cen),
        block_cls=cls.astype(np.int32), inside_tiles=inside,
        outside_tiles=outside,
        coef=np.ascontiguousarray(np.stack([COEF_SCALE, COEF_USM]),
                                  np.float32))


@dataclasses.dataclass(frozen=True)
class SharpenMaps(_Tables):
    """The sharpen-only class kernels' tables (RCAS sharpen, CAS sharpen,
    NVSharpen): numpy arrays from sharpen_maps, torch tensors after
    .to(device).

      centres (B, 5) int64   the foveation cbuffer rows
      group_cls (B, GY, GX)  int32 1 where the foveation group passes the
                             reference's circle test, else 0
      inside_tiles           int32 ids b * TY * TX + ty * TX + tx of the
                             SHARPEN_TILE tiles with a group inside the
                             circle; the inside kernel walks them
      outside_tiles          the others, for the copy pass
    """

    h: int
    w: int
    centres: object
    group_cls: object
    inside_tiles: object
    outside_tiles: object

    _ARRAYS = ("centres", "group_cls", "inside_tiles", "outside_tiles")

    @property
    def tile_inside(self):
        """(B, TY, TX) bool: the tiles the inside kernel runs."""
        return _tile_flags(self.inside_tiles, (
            self.group_cls.shape[0], -(-self.h // SHARPEN_TILE),
            -(-self.w // SHARPEN_TILE)))


def sharpen_maps(batch, h, w, centres, group):
    """The sharpen-only class kernels' tables for one (shape, centres):
    the circle test per (width, height) foveation `group` (RCAS's and CAS's
    16x16, NVSharpen's 32x32 block) and the inside and outside lists of the
    SHARPEN_TILE tiles."""
    H, W = int(h), int(w)
    cen = np.asarray(centres, np.int64).reshape(int(batch), 5)
    cls = group_classes(cen, H, W, group)
    inside, outside = tile_lists(cls, H, W, (SHARPEN_TILE, SHARPEN_TILE),
                                 group)
    return SharpenMaps(h=H, w=W, centres=np.ascontiguousarray(cen),
                       group_cls=cls.astype(np.int32), inside_tiles=inside,
                       outside_tiles=outside)


def dma_geometry(out_h, out_w, tile, window, tile_x0, tile_y0, centres, *,
                 oob, stage, tap_x, tap_y, quad_x=None, quad_y=None,
                 group=None, staged=None, stage_quads=False):
    """What one CUDA kernel loads from the frame and stores, for its DMA
    floor (kernels/sol.py::build_dma_floor; the counterpart of the JAX
    package's fn.dma_geometry, kernels/_band.py::make_io_fn). kernel_fn adds
    batch, in_h, in_w and the ring pitch hp, wp.

      out_h, out_w      the output plane; every output word is stored once
      tile              (width, height) output block of one CTA of THREADS
      window            (width, height) of the window a staging CTA loads
                        into shared memory, one word per position
      tile_x0, tile_y0  window origin per tile column / tile row (int32)
      oob               "zero": window words outside the image are staged
                        as 0 and not loaded; "clamp": loaded edge-clamped
      stage             "copy" (the sharpen-only kernels): only the CTAs
                        `staged` marks stage, the others copy their own
                        texels, 4 of one row per thread (copy_pass.cuh);
                        "list" (the upscalers): only the CTAs `staged`
                        marks stage, the others load four bilinear taps per
                        output
      centres           (B, 5) int64 foveation rows of the circle test
      tap_x, tap_y      per output column / row, the in-image input index
                        of the output's own tap (the clamped floor of its
                        sample position): inside every window of its tile
      quad_x, quad_y    for stage "list", (2, out_w) / (2, out_h) floors
                        of four bilinear taps each output loads from device
                        memory (edge-clamped): row 0 in a staging CTA (where
                        stage_quads: NVScaler's RGBA tap), row 1 in the
                        others (the upscalers' shared outside pass)
      group             (width, height) of the foveation group the circle
                        test classes (default: the tile)
      staged            (B, tiles_y, tiles_x) bool: the CTAs that stage
    """
    def ints(a):
        return None if a is None else np.ascontiguousarray(a, np.int32)

    return dict(out_h=int(out_h), out_w=int(out_w), tile=tuple(tile),
                group=tuple(tile if group is None else group),
                threads=THREADS, window=tuple(window),
                tile_x0=ints(tile_x0), tile_y0=ints(tile_y0), oob=oob,
                stage=stage, stage_quads=bool(stage_quads),
                staged=None if staged is None else np.ascontiguousarray(
                    staged, bool),
                centres=np.ascontiguousarray(np.asarray(centres, np.int64)
                                             .reshape(-1, 5)),
                tap_x=ints(tap_x), tap_y=ints(tap_y), quad_x=ints(quad_x),
                quad_y=ints(quad_y))


def sharpen_geometry(h, w, tile, halo, centres, oob, staged, group=None):
    """The DMA geometry of a renderScale-1 class kernel (RCAS, NVSharpen,
    CAS sharpen; stage "copy"): the CTAs `staged` marks (its tile_inside)
    stage their (tile + 2 halo)-square window at (t * tile - halo); the
    others copy their own texels. group: the foveation group (default: the
    tile)."""
    return dma_geometry(
        h, w, (tile, tile), (tile + 2 * halo,) * 2,
        np.arange(-(-w // tile)) * tile - halo,
        np.arange(-(-h // tile)) * tile - halo, centres, oob=oob,
        stage="copy", staged=staged, group=group, tap_x=np.arange(w),
        tap_y=np.arange(h))


def word_geometry(geom, texel_words):
    """A texel geometry (dma_geometry, sharpen_geometry) in 4-byte words,
    for a frame of `texel_words` words per texel (1: RGBA8, returned as it
    is; 2: R10G10B10A2's 8-byte texels): every column quantity (the tile
    and window widths, out_w, the window origins, the per-output taps and
    bilinear floors) per word, word k of texel x being texel x's word k,
    and texel_words added, which the floor's clamps read
    (kernels/sol.py::clip_words). The rows, the foveation group and the
    centres stay in texels."""
    n = int(texel_words)
    if n == 1:
        return geom
    g = dict(geom)

    def words(cols):
        cols = np.asarray(cols, np.int64)
        return np.ascontiguousarray(
            (cols[..., None] * n + np.arange(n)).reshape(
                *cols.shape[:-1], -1), np.int32)

    (tw, th), (ww, wh) = geom["tile"], geom["window"]
    g.update(tile=(tw * n, th), window=(ww * n, wh),
             out_w=geom["out_w"] * n, texel_words=n,
             tile_x0=np.ascontiguousarray(geom["tile_x0"] * n, np.int32),
             tap_x=words(geom["tap_x"]))
    if geom["quad_x"] is not None:
        g["quad_x"] = words(geom["quad_x"])
    return g


def band_geometry(geom, rows, in_row_base, in_rows):
    """The DMA geometry of a row-band strip of B1 or B5: what the CUDA strip
    kernels load and store, from the whole build's geometry `geom`
    (dma_geometry, texels or words: only rows change here) and the band's
    output rows [r0, r1) = `rows`. It keeps the tile rows [t0, t1) that
    overlap the band (band_strip's lists), their window origins and their
    staged table, and the band rows' own taps and bilinear floors, every
    input row rebased by the strip's in_row_base. `band` = (row0, row1) are
    the band's rows in the grid of those tile rows (row0 = r0 - t0 * tile
    height): the rows a floor stores, out_h = row1 - row0. A tile that a band
    edge cuts loads its whole window in both strips, each storing its own
    rows, as the strip kernels do. Each output's own tap row is clipped
    into the strip's in_rows rows: a no-op where its tile stages (its
    window lies in the strip), and in a tile row where no tile stages the
    floor reads the bilinear floors instead."""
    r0, r1 = int(rows[0]), int(rows[1])
    th = geom["tile"][1]
    t0, t1 = r0 // th, -(-r1 // th)
    base = int(in_row_base)
    g = dict(geom)
    g.update(out_h=r1 - r0, band=(r0 - t0 * th, r1 - t0 * th),
             tile_y0=np.ascontiguousarray(geom["tile_y0"][t0:t1] - base,
                                          np.int32),
             tap_y=np.ascontiguousarray(np.clip(
                 geom["tap_y"][r0:r1] - base, 0, int(in_rows) - 1), np.int32),
             staged=np.ascontiguousarray(geom["staged"][:, t0:t1]))
    if geom["quad_y"] is not None:
        g["quad_y"] = np.ascontiguousarray(geom["quad_y"][:, r0:r1] - base,
                                           np.int32)
    return g
