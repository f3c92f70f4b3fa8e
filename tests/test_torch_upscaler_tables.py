"""The host tables of the redesigned upscalers, B3 NVScaler (csrc/
nis_scaler.cu) and B5 CAS upscale (csrc/cas_upscale.cu), and the DMA
geometries they publish, on the CPU.

Each kernel launches two class kernels from host tile lists
(kernels/_maps.py): the shared bilinear pass over the tiles outside the
foveation circle and the inside kernel over the others. Held here:
  - the classes are the reference's circle test (kernels/_common.py::
    circle_mask, the plain versions' select) read at every pixel;
  - the inside and outside lists partition the tiles;
  - CAS's classes and lists are the fused FSR kernel's for the same centres;
  - NVScaler's edge-map extents hold every 2x2 edge tap of their tiles'
    outputs, and its windows their 6x6 taps and the edge taps' 3x3s;
  - each geometry is a numpy statement of what the two kernels load and
    store, and the DMA floor's own check passes.

The CUDA kernels run only on the card: `python3 chip_smoke.py` holds them
against their plain versions there, texel for texel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.core.config import Config  # noqa: E402
from openvr_fsr_tpu_torch.core.foveation import TILE_NIS_SCALER  # noqa: E402
from openvr_fsr_tpu_torch.kernels import _maps, sol  # noqa: E402
from openvr_fsr_tpu_torch.kernels._common import circle_mask  # noqa: E402
from openvr_fsr_tpu_torch.kernels.cas import build_cas_upscale  # noqa: E402
from openvr_fsr_tpu_torch.kernels.nis import build_nvscaler  # noqa: E402

CENTRED = ((0.5, 0.5), (0.5, 0.5))
OFF_CENTRE = ((0.3, 0.6), (0.7, 0.4))
# (in_h, in_w, rs): the main path, the supersample, NVScaler's test scales
# (tests/test_torch_kernels_sharpen.py, the invalid 0.3 and 1.3 included)
# and small shapes not a multiple of any tile
SHAPES = [(1869, 1683, 0.75), (2492, 2244, 1.3), (48, 56, 0.75),
          (40, 45, 0.75), (30, 33, 0.5), (48, 56, 0.77), (24, 28, 0.3),
          (40, 45, 1.3), (72, 96, 0.75), (45, 61, 0.75)]
CIRCLES = [(0.0, CENTRED), (0.3, OFF_CENTRE), (0.5, CENTRED),
           (2.0, CENTRED)]
SHAPE_IDS = [f"{w}x{h}-rs{rs}" for h, w, rs in SHAPES]
CIRCLE_IDS = [f"r{r}" for r, _ in CIRCLES]


def _sizes(h, w, rs):
    ow, oh = Config(render_scale=rs).output_size(w, h)
    return ow, oh


def _centres(ow, oh, radius, eyes, batch):
    return C.centres_payload(ow, oh, radius, eyes,
                             tuple(i % 2 for i in range(batch)))


def _nis_maps(h, w, rs, radius, eyes, batch):
    ow, oh = _sizes(h, w, rs)
    cfg = C.nvscaler_update_config(0.9, w, h, w, h, ow, oh, ow, oh)
    cen = _centres(ow, oh, radius, eyes, batch)
    return _maps.nvscaler_maps(batch, h, w, ow, oh, cfg, cen), cen


def _tiles_any(mask, tile):
    """(B, TY, TX) bool: a (width, height) tile holds a True pixel."""
    (tw, th), (b, oh, ow) = tile, mask.shape
    ty, tx = -(-oh // th), -(-ow // tw)
    pad = np.zeros((b, ty * th, tx * tw), bool)
    pad[:, :oh, :ow] = mask
    return pad.reshape(b, ty, th, tx, tw).any(axis=(2, 4))


def _check_lists(inside, outside, flags):
    """The lists are the flagged tiles' ids and the others', in order."""
    ids = np.arange(flags.size)
    assert inside.dtype == outside.dtype == np.int32
    assert np.array_equal(inside, ids[flags.ravel()])
    assert np.array_equal(outside, ids[~flags.ravel()])
    assert len(np.intersect1d(inside, outside)) == 0
    assert len(inside) + len(outside) == flags.size


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("radius,eyes", CIRCLES, ids=CIRCLE_IDS)
@pytest.mark.parametrize("h,w,rs", SHAPES, ids=SHAPE_IDS)
def test_nis_block_classes_and_lists(h, w, rs, radius, eyes, batch):
    """B3's block classes are the circle test at TILE_NIS_SCALER read at
    every pixel of each 32x24 block; its lists partition the 32x48 tiles,
    a tile inside where any of its outputs is."""
    m, cen = _nis_maps(h, w, rs, radius, eyes, batch)
    mask = circle_mask(torch.from_numpy(cen), m.out_h, m.out_w,
                       TILE_NIS_SCALER).numpy()
    bw, bh = TILE_NIS_SCALER
    assert m.block_cls.dtype == np.int32
    assert m.block_cls.shape == (batch, -(-m.out_h // bh), -(-m.out_w // bw))
    per_pixel = np.repeat(np.repeat(m.block_cls.astype(bool), bh, 1), bw, 2)
    assert np.array_equal(per_pixel[:, :m.out_h, :m.out_w], mask)
    flags = _tiles_any(mask, _maps.NIS_TILE)
    _check_lists(m.inside_tiles, m.outside_tiles, flags)
    assert np.array_equal(m.tile_inside, flags)


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("radius,eyes", CIRCLES, ids=CIRCLE_IDS)
@pytest.mark.parametrize("h,w,rs", SHAPES, ids=SHAPE_IDS)
def test_cas_classes_and_lists_are_fsr_fused(h, w, rs, radius, eyes, batch):
    """B5's 16x16 group classes and 32x32 tile lists equal the fused FSR
    kernel's for the same centres, partition the tiles, and are the circle
    test at every pixel."""
    ow, oh = _sizes(h, w, rs)
    cen = _centres(ow, oh, radius, eyes, batch)
    m = _maps.cas_upscale_maps(batch, h, w, ow, oh, cen)
    f = _maps.fsr_maps(batch, h, w, ow, oh, cen)
    for key in ("group_cls", "inside_tiles", "outside_tiles"):
        assert np.array_equal(getattr(m, key), getattr(f, key)), key
    mask = circle_mask(torch.from_numpy(cen), oh, ow).numpy()
    assert np.array_equal(m.group_cls, mask[:, ::16, ::16].astype(np.int32))
    _check_lists(m.inside_tiles, m.outside_tiles, _tiles_any(mask, (32, 32)))


@pytest.mark.parametrize("h,w,rs", SHAPES, ids=SHAPE_IDS)
def test_nis_edge_extents_and_windows_hold_the_taps(h, w, rs):
    """Each 32x48 tile's edge-map extent holds its outputs' 2x2 edge taps
    clip(pxi .. pxi + 1) and fits its cap; its luma window holds the 6x6
    taps and the 3x3 of every edge tap, clip(clip(p) +- 1)."""
    m, _ = _nis_maps(h, w, rs, 0.5, CENTRED, 2)
    for axis, (src, origins, extents, tile, win, cap, n) in enumerate((
            (m.col_i[0], m.tile_x0, m.edge_x, 32, 40, 36, w),
            (m.row_i[0], m.tile_y0, m.edge_y, 48, 56, 52, h))):
        assert (_maps.NIS_TILE[axis], _maps.NIS_IN_TILE[axis],
                _maps.NIS_EDGE_TILE[axis]) == (tile, win, cap)
        assert extents.shape == (2, len(origins)) and extents.dtype == np.int32
        edge = np.clip(src[:, None] + np.arange(2), 0, n - 1)
        taps = np.clip(src[:, None] + np.arange(-2, 4), 0, n - 1)
        nbrs = np.clip(edge[..., None] + np.arange(-1, 2), 0, n - 1)
        for t, o in enumerate(origins):
            seg = slice(t * tile, (t + 1) * tile)
            first, last = extents[:, t]
            assert first == edge[seg].min() and last == edge[seg].max()
            assert last - first + 1 <= cap
            for idx in (taps[seg], nbrs[seg]):
                assert o <= idx.min() and idx.max() < o + win


def test_nis_extent_beyond_its_cap_raises():
    """A downscale needs more than the kernel's caps hold."""
    cfg = C.nvscaler_update_config(0.9, 128, 96, 128, 96, 64, 48, 64, 48)
    with pytest.raises(ValueError, match="exceeds"):
        _maps.nvscaler_maps(1, 96, 128, 64, 48, cfg,
                            np.zeros((1, 5), np.int64))


@pytest.mark.parametrize("tile,group", [((32, 32), (16, 16)),
                                        ((32, 48), (32, 24)),
                                        ((32, 24), (32, 24))])
def test_tile_lists_take_tile_and_group_shapes(tile, group):
    """tile_lists over any whole number of groups per tile: a tile is
    inside where any of its groups is."""
    rng = np.random.default_rng(sum(tile + group))
    oh, ow = 100, 70
    cls = _maps.group_classes(np.zeros((3, 5), np.int64), oh, ow, group)
    cls = rng.random(cls.shape) < 0.2
    inside, outside = _maps.tile_lists(cls, oh, ow, tile, group)
    pixels = np.repeat(np.repeat(cls, group[1], 1), group[0], 2)
    _check_lists(inside, outside, _tiles_any(pixels[:, :oh, :ow], tile))


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("radius,eyes", CIRCLES, ids=CIRCLE_IDS)
@pytest.mark.parametrize("kernel", ["nis_scaler", "cas_upscale"])
@pytest.mark.parametrize("h,w,rs", [(1869, 1683, 0.75), (2492, 2244, 1.3),
                                    (72, 96, 0.75), (45, 61, 0.75)],
                         ids=["main", "supersample", "72x96", "45x61"])
def test_geometry_is_the_two_kernels(h, w, rs, kernel, radius, eyes, batch):
    """B3's and B5's DMA geometries against a numpy statement of what their
    two kernels load and store: an inside tile stages its window (B3: 40x56
    edge-clamped, plus the four RGBA taps of each output; B5: 36x36, the
    words outside the image staged as 0 without a load); every other tile
    loads four bilinear taps per output; every output word is stored once.
    The floor's own check passes, so every output's tap lies in its tile's
    window."""
    ow, oh = _sizes(h, w, rs)
    cen = _centres(ow, oh, radius, eyes, batch)
    if kernel == "nis_scaler":
        cfg = C.nvscaler_update_config(0.9, w, h, w, h, ow, oh, ow, oh)
        fn = build_nvscaler(batch, h, w, ow, oh, nis_cfg=cfg, centres=cen)
        m = _maps.nvscaler_maps(batch, h, w, ow, oh, cfg, cen)
        tile, win, group, quads = (32, 48), (40, 56), (32, 24), (2, 3)
    else:
        fn = build_cas_upscale(batch, h, w, ow, oh, sharpness=0.9,
                               centres=cen)
        m = _maps.cas_upscale_maps(batch, h, w, ow, oh, cen)
        tile, win, group, quads = (32, 32), (36, 36), (16, 16), (1, 1)
    g = fn.dma_geometry
    sol.check_geometry(g)
    assert (g["tile"], g["window"], g["group"]) == (tile, win, group)
    assert g["stage"] == "list"
    assert g["stage_quads"] == (kernel == "nis_scaler")
    assert g["oob"] == ("clamp" if kernel == "nis_scaler" else "zero")
    staged = m.tile_inside
    assert np.array_equal(g["staged"], staged)
    assert np.array_equal(g["quad_x"], m.col_i[list(quads)])
    assert np.array_equal(g["quad_y"], m.row_i[list(quads)])
    assert np.array_equal(g["tap_x"], np.clip(m.col_i[0], 0, w - 1))
    assert np.array_equal(g["tap_y"], np.clip(m.row_i[0], 0, h - 1))
    (tw, th), (ww, wh) = tile, win
    # the floor moves those words by TMA, one box per tile, reading only
    # its in-image words: an inside tile's window (B3's RGBA taps lie in
    # it), another tile the footprint of its four bilinear taps; each box
    # from its first column rounded down to 4 words (rows start on 16
    # bytes), as wide as the widest span from there rounded up to 4 words
    def in_image(x0, y0, bw, bh):
        nx = np.clip(np.asarray(x0) + bw, 0, w) - np.clip(x0, 0, w)
        ny = np.clip(np.asarray(y0) + bh, 0, h) - np.clip(y0, 0, h)
        return ny[:, None] * nx[None, :]

    def box(first, last, align):
        origin = first // align * align
        ext = int((last - origin).max()) + 1
        return origin, -(-ext // align) * align

    foot = []
    for t, q, n_in, align in ((tw, g["quad_x"][1], w, 4),
                              (th, g["quad_y"][1], h, 1)):
        lo, hi = np.clip(q, 0, n_in - 1), np.clip(q + 1, 0, n_in - 1)
        first = np.array([lo[a:a + t].min() for a in range(0, len(q), t)])
        last = np.array([hi[a:a + t].max() for a in range(0, len(q), t)])
        foot.append(box(first, last, align))
    (fx, fw), (fy, fh) = foot
    (sx, sw), (sy, sh) = (box(m.tile_x0, m.tile_x0 + ww - 1, 4),
                          box(m.tile_y0, m.tile_y0 + wh - 1, 1))
    floor = sol.build_dma_floor(g)
    assert floor.boxes.box == ((fw, fh), (sw, sh)) and sh == wh
    assert ww <= sw <= ww + 4
    assert floor.read_bytes == 4 * int(np.where(
        staged, in_image(sx, sy, sw, sh), in_image(fx, fy, fw, fh)).sum())
    assert floor.write_bytes == 4 * batch * oh * ow


@pytest.mark.parametrize("table", ["COEF_SCALE", "COEF_USM"])
def test_constant_tables_are_the_host_tables(table):
    """csrc/nis_coef.cuh's __constant__ c_coef (COEF_SCALE then COEF_USM,
    exact hexadecimal literals) holds core/nis_tables.py's float32 bits,
    phase by phase, and nothing else."""
    import re
    from openvr_fsr_tpu_torch.core import nis_tables
    from openvr_fsr_tpu_torch.kernels import _build
    text = (_build.CSRC / "nis_coef.cuh").read_text()
    body = text[text.index("c_coef[2 * 64 * 8] = {"):text.index("};")]
    lits = re.findall(r"(-?0x[0-9a-f.]+p[+-]\d+)f", body)
    vals = np.array([float.fromhex(s) for s in lits])
    assert vals.size == 2 * 64 * 8
    assert np.array_equal(vals.astype(np.float32).astype(np.float64), vals)
    got = vals.astype(np.float32).reshape(2, 64, 8)[
        ["COEF_SCALE", "COEF_USM"].index(table)]
    want = np.asarray(getattr(nis_tables, table), np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
