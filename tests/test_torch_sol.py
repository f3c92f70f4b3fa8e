"""The DMA floor (kernels/sol.py, csrc/dma_floor.cu) and the DMA geometry
every kernel build publishes, on the CPU.

Each of the six kernel builds is built through Pipeline._build at two small
shapes (one not a multiple of any tile) and radius 0.5, 2.0 and 0.0, and
its geometry is held against:
  - the JAX package's: the same build through its Pipeline in Pallas
    interpret mode, and its own build_dma_floor over it (batch, out_h,
    out_w, the ring pitch hp/wp and write_bytes are equal; read_bytes
    differ by design, band windows against tile windows, so the port's is
    held against the words its own windows load);
  - a numpy statement of the floor kernel, CTA by CTA: the windows it
    stages, the words it loads, the word each output stores.

The CUDA kernel itself runs only on the card: `python3 chip_smoke.py`
holds it against dma_floor_reference there, word for word.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu import Config as JConfig  # noqa: E402
from openvr_fsr_tpu import Pipeline as JPipeline  # noqa: E402
from openvr_fsr_tpu.kernels import sol as jsol  # noqa: E402

from openvr_fsr_tpu_torch import Config, Pipeline  # noqa: E402
from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.kernels import _build, _maps  # noqa: E402
from openvr_fsr_tpu_torch.kernels import sol  # noqa: E402

from torch_entry_calls import entry_calls  # noqa: E402,F401

PLANS = {
    "fsr_fused": dict(render_scale=0.75),
    "rcas_sharpen": dict(render_scale=1.0),
    "nvscaler": dict(render_scale=0.75, use_nis=True),
    "nvsharpen": dict(render_scale=1.0, use_nis=True),
    "cas_upscale": dict(render_scale=0.75, use_cas=True),
    "cas_sharpen": dict(render_scale=1.0, use_cas=True),
}
SHAPES = [(72, 96), (45, 61)]
RADII = [0.5, 2.0, 0.0]
CASES = [(p, h, w, r) for p in PLANS for h, w in SHAPES for r in RADII]
IDS = [f"{p}-{h}x{w}-r{r}" for p, h, w, r in CASES]


def _config(cls, plan, radius):
    return cls(enabled=True, sharpness=0.9, radius=radius, **PLANS[plan])


def _geometry(plan, h, w, radius):
    pipe = Pipeline(_config(Config, plan, radius), device="cpu")
    return pipe._build(2, h, w, (0, 1), True).dma_geometry


def _frames(h, w, seed=0):
    rng = np.random.default_rng(seed + h * w)
    return rng.integers(0, 2**32, (2, h, w), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)


def _class_boxes(g):
    """{class: [(origins per tile, extent) along x, along y]}: the box a
    tile of class 1 (it stages) or 0 (it does not) loads. Its span of taps
    per tile: class 1 its window; class 0, stage "copy", its own texels,
    "list", its four edge-clamped bilinear taps (quad row 1). The box
    starts at the span's first tap, rounded down to 4 words along x (TMA
    starts a row on 16 bytes), and is as wide as the largest span from
    there, rounded up to 4 words along x."""
    out = {0: [], 1: []}
    for tile, win, quad, n_in, n_out, origins, align in (
            (g["tile"][0], g["window"][0], g["quad_x"], g["in_w"],
             g["out_w"], g["tile_x0"], 4),
            (g["tile"][1], g["window"][1], g["quad_y"], g["in_h"],
             g["out_h"], g["tile_y0"], 1)):
        if g["stage"] == "list":
            lo = np.clip(quad[1], 0, n_in - 1)
            hi = np.clip(quad[1] + 1, 0, n_in - 1)
        else:
            lo = hi = np.arange(n_out)
        starts = range(0, n_out, tile)
        spans = {0: (np.array([lo[a:a + tile].min() for a in starts]),
                     np.array([hi[a:a + tile].max() for a in starts])),
                 1: (origins.astype(np.int64), origins + win - 1)}
        for c, (first, last) in spans.items():
            origin = first // align * align
            ext = int((last - origin).max()) + 1
            out[c].append((origin, -(-ext // align) * align))
    return out


def _in_image(x0, y0, bw, bh, h, w):
    """(tiles_y, tiles_x): the in-image words of (bw, bh) boxes at the
    origins x0 per tile column and y0 per tile row."""
    nx = np.clip(np.asarray(x0) + bw, 0, w) - np.clip(x0, 0, w)
    ny = np.clip(np.asarray(y0) + bh, 0, h) - np.clip(y0, 0, h)
    return ny[:, None] * nx[None, :]


def _emulate(img, g):
    """The floor kernel in numpy, tile by tile: (output, words loaded).
    Each tile loads one box into a zero-filled buffer, reading only its
    in-image words (TMA fills the others with 0), and each output stores
    the box word at its tap, the box of its class (_class_boxes). Asserts
    that
    every tap an output (and its four bilinear or RGBA taps) reads lies in
    its tile's box."""
    B, H, W = g["batch"], g["in_h"], g["in_w"]
    OH, OW = g["out_h"], g["out_w"]
    (tw, th) = g["tile"]
    boxes = _class_boxes(g)
    out = np.zeros((B, OH, OW), np.int32)
    loads = 0
    for b in range(B):
        for ty in range(-(-OH // th)):
            oy = np.arange(ty * th, min(ty * th + th, OH))
            for tx in range(-(-OW // tw)):
                ox = np.arange(tx * tw, min(tx * tw + tw, OW))
                c = int(g["staged"][b, ty, tx])
                (xo, bw), (yo, bh) = boxes[c]
                x0, y0 = xo[tx], yo[ty]
                if c:
                    ys, xs = g["tap_y"][oy], g["tap_x"][ox]
                    quad = 0 if g["stage_quads"] else None
                elif g["stage"] == "list":
                    ys = np.clip(g["quad_y"][1][oy], 0, H - 1)
                    xs = np.clip(g["quad_x"][1][ox], 0, W - 1)
                    quad = 1
                else:
                    ys, xs, quad = oy, ox, None
                y, x = y0 + np.arange(bh), x0 + np.arange(bw)
                valid = (((y >= 0) & (y < H))[:, None]
                         & ((x >= 0) & (x < W))[None, :])
                box = np.where(valid, img[b][np.ix_(np.clip(y, 0, H - 1),
                                                    np.clip(x, 0, W - 1))], 0)
                loads += int(valid.sum())
                taps = [(ys, xs)]
                if quad is not None:
                    qy, qx = g["quad_y"][quad][oy], g["quad_x"][quad][ox]
                    taps += [(np.clip(qy + dy, 0, H - 1),
                              np.clip(qx + dx, 0, W - 1))
                             for dy in (0, 1) for dx in (0, 1)]
                for ty_, tx_ in taps:
                    assert ty_.min() >= y0 and ty_.max() < y0 + bh
                    assert tx_.min() >= x0 and tx_.max() < x0 + bw
                out[b][np.ix_(oy, ox)] = box[np.ix_(ys - y0, xs - x0)]
    return out, loads


@pytest.mark.parametrize("plan,h,w,radius", CASES, ids=IDS)
class TestGeometry:
    def test_matches_the_jax_package(self, plan, h, w, radius):
        g = _geometry(plan, h, w, radius)
        jpipe = JPipeline(_config(JConfig, plan, radius),
                          backend="pallas-interpret")
        jfn = jpipe._build(2, h, w, (0, 1))
        jg = jfn.dma_geometry
        for key in ("batch", "out_h", "out_w", "hp", "wp"):
            assert g[key] == jg[key], key
        assert tuple(jfn.pad_to) == (g["hp"], g["wp"])
        jfloor = jsol.build_dma_floor(jg, interpret=True)
        floor = sol.build_dma_floor(g)
        assert floor.write_bytes == jfloor.write_bytes
        assert floor.pad_to == tuple(jfloor.pad_to)
        # read_bytes: the JAX floor counts row-band windows, the port's the
        # CUDA kernel's tile windows; each equals the words its own loads
        _, loads = _emulate(_frames(h, w), g)
        assert floor.read_bytes == 4 * loads
        assert floor.hbm_bytes == 4 * 2 * h * w + floor.write_bytes

    def test_reference_is_the_numpy_statement(self, plan, h, w, radius):
        g = _geometry(plan, h, w, radius)
        img = _frames(h, w)
        want, _ = _emulate(img, g)
        got = sol.dma_floor_reference(torch.from_numpy(img), g)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want)

    def test_ring_pitch_equals_unpadded(self, plan, h, w, radius):
        g = _geometry(plan, h, w, radius)
        floor = sol.build_dma_floor(g)
        img = _frames(h, w, seed=1)
        hp, wp = floor.pad_to
        ring = np.full((2, hp, wp), -1, np.int32)   # junk in the padding
        ring[:, :h, :w] = img
        a = floor(torch.from_numpy(img))
        b = floor(torch.from_numpy(ring))
        assert torch.equal(a, b) and floor.launches == 0

    def test_tile_list_covers_every_tile_once(self, plan, h, w, radius):
        """The floor's host list: every (b, ty, tx) of the grid in exactly
        one item, the span items first (one CTA each, the launch's
        n_spans), then the persistent CTAs' box items, each part in order;
        kind 1 where the compute kernel stages the tile, else 0 (a box of
        stage "list") or, in stage "copy" with output rows of whole 16-byte
        units, -n: a span of n <= 4 outside tiles of one tile row, as long
        as the row allows."""
        g = _geometry(plan, h, w, radius)
        items = sol.floor_tiles(g)
        assert items.dtype == np.int32 and items.shape[1] == 4
        assert items.flags["C_CONTIGUOUS"]      # the kernel reads it as int4
        n_spans = int((items[:, 3] < 0).sum())
        assert (items[:n_spans, 3] < 0).all()
        assert sol.build_dma_floor(g).n_spans == n_spans
        grid = np.shape(g["staged"])
        staged = np.asarray(g["staged"], bool)
        seen = np.zeros(grid, np.int64)
        tiles = []
        for b, ty, tx, kind in items:
            for t in range(tx, tx + max(-kind, 1)):
                seen[b, ty, t] += 1
                tiles.append((b, ty, t, int(kind == 1)))
        assert (seen == 1).all()
        span_tiles = -int(items[:n_spans, 3].sum())
        for part in (tiles[:span_tiles], tiles[span_tiles:]):
            assert part == sorted(part)
        assert sorted(tiles) == [(b, ty, tx, int(staged[b, ty, tx]))
                                 for b, ty, tx in np.ndindex(grid)]
        spans = g["stage"] == "copy" and g["out_w"] % 4 == 0
        assert ((items[:, 3] < 0).any() if spans and not staged.all()
                else (items[:, 3] >= 0).all())
        assert (items[:, 3] >= -sol.FLOOR_SPAN).all()
        for b, ty, tx, kind in items[:n_spans]:
            end = tx - kind
            if kind > -sol.FLOOR_SPAN and end < grid[2]:
                assert staged[b, ty, end]     # a span ends at a staged tile

    def test_boxes_hold_every_tap(self, plan, h, w, radius):
        """Each tile's TMA box (the tables the kernel launches with) holds
        every tap its outputs read: a staging tile's window holds each
        output's tap (and NVScaler's four RGBA taps), another tile's box
        each output's own texel or its four edge-clamped bilinear taps.
        The boxes' rows start and end on 16-byte boundaries."""
        g = _geometry(plan, h, w, radius)
        b = sol.floor_boxes(g)
        H, W = g["in_h"], g["in_w"]
        (tw, th) = g["tile"]
        assert all(bw % 4 == 0 and 0 < bw <= 256 and 0 < bh <= 256
                   for bw, bh in b.box)
        assert (b.x0 % 4 == 0).all()      # rows start on 16 bytes
        for c in (0, 1):
            for axis, tile, n_in, rel, origins, taps, quad in (
                    ("x", tw, W, b.rel_x[c], b.x0[c], g["tap_x"],
                     g["quad_x"]),
                    ("y", th, H, b.rel_y[c], b.y0[c], g["tap_y"],
                     g["quad_y"])):
                ext = b.box[c][0 if axis == "x" else 1]
                first = np.repeat(origins, tile)[:len(taps)].astype(np.int64)
                assert rel.min() >= 0 and rel.max() < ext
                if c == 1:
                    assert np.array_equal(rel[:len(taps)], taps - first)
                    reads = [taps]
                    if g["stage_quads"]:
                        reads += [np.clip(quad[0] + d, 0, n_in - 1)
                                  for d in (0, 1)]
                elif g["stage"] == "list":
                    reads = [np.clip(quad[1] + d, 0, n_in - 1)
                             for d in (0, 1)]
                    assert np.array_equal(rel[:len(taps)], reads[0] - first)
                else:
                    reads = [np.arange(len(taps))]
                    assert np.array_equal(rel[:len(taps)], reads[0] - first)
                for r in reads:
                    assert (r >= first).all() and (r < first + ext).all()

    def test_clamped_tap_from_zero_filled_box(self, plan, h, w, radius):
        """The kernel's reading, in numpy, from the tables it launches with:
        each tile's box zero-filled outside the image (TMA), each output
        the box word at its box-relative tap (the edge-clamped tap, on the
        clamp geometries) equals dma_floor_reference."""
        g = _geometry(plan, h, w, radius)
        b = sol.floor_boxes(g)
        img = _frames(h, w, seed=2)
        H, W, (tw, th) = g["in_h"], g["in_w"], g["tile"]
        out = np.zeros((2, g["out_h"], g["out_w"]), np.int32)
        for bi, ty, tx0, kind in sol.floor_tiles(g):
            # a span's tiles copy their own texels: the class-0 box, the tile
            for tx in range(tx0, tx0 + max(-kind, 1)):
                c = int(kind == 1)
                (bw, bh), x0, y0 = b.box[c], b.x0[c][tx], b.y0[c][ty]
                y, x = y0 + np.arange(bh), x0 + np.arange(bw)
                valid = (((y >= 0) & (y < H))[:, None]
                         & ((x >= 0) & (x < W))[None, :])
                box = np.where(valid, img[bi][np.ix_(np.clip(y, 0, H - 1),
                                                     np.clip(x, 0, W - 1))],
                               0)
                oy = np.arange(ty * th, min(ty * th + th, g["out_h"]))
                ox = np.arange(tx * tw, min(tx * tw + tw, g["out_w"]))
                out[bi][np.ix_(oy, ox)] = box[np.ix_(b.rel_y[c][oy],
                                                     b.rel_x[c][ox])]
        want = sol.dma_floor_reference(torch.from_numpy(img), g).numpy()
        assert np.array_equal(out, want)

    def test_windows_cover_the_taps_of_their_tiles(self, plan, h, w, radius):
        g = _geometry(plan, h, w, radius)
        sol.check_geometry(g)
        for tile, win, origins, taps in (
                (g["tile"][0], g["window"][0], g["tile_x0"], g["tap_x"]),
                (g["tile"][1], g["window"][1], g["tile_y0"], g["tap_y"])):
            assert len(origins) == -(-len(taps) // tile)
            for t, o in enumerate(origins):
                seg = taps[t * tile:(t + 1) * tile]
                assert o <= seg.min() and seg.max() < o + win
        # the tables are the ones the kernel launches with
        ow, oh = _config(Config, plan, radius).output_size(w, h)
        cen = C.centres_payload(ow, oh, radius, Pipeline(device="cpu").eye_centers,
                                (0, 1))
        assert np.array_equal(g["centres"], np.asarray(cen).reshape(2, 5))
        if plan in ("fsr_fused", "cas_upscale"):
            maps = (_maps.fsr_maps if plan == "fsr_fused"
                    else _maps.cas_upscale_maps)(2, h, w, ow, oh, cen)
            assert np.array_equal(g["tile_x0"], maps.tile_x0)
            assert np.array_equal(g["tile_y0"], maps.tile_y0)
            assert np.array_equal(g["tap_x"], np.clip(maps.col_i[0], 0, w - 1))
            assert g["oob"] == ("clamp" if plan == "fsr_fused" else "zero")
        if plan in ("fsr_fused", "cas_upscale"):
            # the inside tiles stage, the outside ones load four bilinear
            # taps per output, and only those
            assert g["stage"] == "list" and not g["stage_quads"]
            assert np.array_equal(g["staged"], maps.tile_inside)
            assert np.array_equal(g["quad_x"][1], maps.col_i[1])
            assert np.array_equal(g["quad_y"][1], maps.row_i[1])
            assert g["tile"] == (32, 32) and g["group"] == (16, 16)
            assert g["window"] == ((40, 40) if plan == "fsr_fused"
                                   else (36, 36))
        elif plan == "nvscaler":
            cfg = C.nvscaler_update_config(0.9, w, h, w, h, ow, oh, ow, oh)
            maps = _maps.nvscaler_maps(2, h, w, ow, oh, cfg, cen)
            assert np.array_equal(g["tile_x0"], maps.tile_x0)
            assert np.array_equal(g["quad_y"], maps.row_i[2:4])
            # the inside tiles stage and load each pixel's RGBA tap
            assert (g["stage"], g["oob"]) == ("list", "clamp")
            assert g["stage_quads"]
            assert np.array_equal(g["staged"], maps.tile_inside)
            assert (g["tile"], g["window"], g["group"]) == (
                (32, 48), (40, 56), (32, 24))
        else:
            halo = 2 if plan == "nvsharpen" else 1
            assert g["tile"] == (32, 32)
            assert g["tile_x0"][1] == 32 - halo
            assert np.array_equal(g["tap_y"], np.arange(h))
            assert g["oob"] == ("clamp" if plan == "nvsharpen" else "zero")
            # the class kernels: the host's inside tiles stage, the others
            # copy their texels (copy_pass.cuh)
            group = (32, 32) if plan == "nvsharpen" else (16, 16)
            maps = _maps.sharpen_maps(2, h, w, cen, group)
            assert (g["stage"], g["group"]) == ("copy", group)
            assert np.array_equal(g["staged"], maps.tile_inside)
            assert g["quad_x"] is None and not g["stage_quads"]


def test_full_size_geometries_fit_the_floor():
    """The seven bench paths' geometries at full size pass the floor's own
    check (host tables only; nothing runs)."""
    from openvr_fsr_tpu_torch.tools.bench_paths import PATHS, path_config
    for name in PATHS:
        cfg, h, w = path_config(name)
        g = Pipeline(cfg, device="cpu")._build(2, h, w, (0, 1), True).dma_geometry
        floor = sol.build_dma_floor(g)
        assert floor.write_bytes == 2 * g["out_h"] * g["out_w"] * 4
        assert floor.read_bytes >= 2 * h * w * 4


@pytest.mark.parametrize("name", ["fsr_fused", "fsr_supersample",
                                  "rcas_only", "nvscaler", "nvsharpen",
                                  "cas_upscale", "cas_sharpen"])
def test_full_size_boxes_fit_tma(name):
    """At each bench path's full size the floor's boxes suit TMA: rows
    that start and end on 16-byte boundaries (a window loads from its
    origin rounded down to 4 words: B2's and B6's 34-word windows, which
    start a word before a boundary, load 40), at most 256 words a side,
    the ring of boxes within a CTA's shared memory; the ring pitch is a
    multiple of the floor's pitch_words."""
    from openvr_fsr_tpu_torch.tools.bench_paths import path_config
    cfg, h, w = path_config(name)
    g = Pipeline(cfg, device="cpu")._build(2, h, w, (0, 1), True).dma_geometry
    floor = sol.build_dma_floor(g)
    (bw0, bh0), (bw1, bh1) = floor.boxes.box
    assert bw0 % 4 == bw1 % 4 == 0 and max(bw0, bh0, bw1, bh1) <= 256
    assert (floor.boxes.x0 % 4 == 0).all()
    lead = int((g["tile_x0"] % 4).max())
    assert bw1 == -(-(lead + g["window"][0]) // 4) * 4 and bh1 == g["window"][1]
    if name in ("rcas_only", "cas_sharpen"):
        assert bw1 == 40
    assert sol.FLOOR_STAGES * max(bw0 * bh0, bw1 * bh1) * 4 <= sol.SMEM_MAX
    assert floor.pad_to[1] % floor.pitch_words == 0
    assert floor.read_bytes == 4 * sol.floor_loads(g)


def test_floor_refuses_a_pitch_tma_cannot_take(entry_calls):
    """On the card the floor's launch refuses a frame whose row pitch is not
    a multiple of 16 bytes (the upscalers' unpadded 1683-word rows) with a
    ValueError, before any launch; the ring pitch reaches the entry point
    with the tables, the shapes and the boxes, in the types of its
    argtypes."""
    g = _geometry("fsr_fused", 45, 61, 0.5)
    floor = sol.build_dma_floor(g)
    with pytest.raises(ValueError, match="pitch"):
        floor.launch(torch.zeros((2, 45, 61), dtype=torch.int32))
    assert not entry_calls
    hp, wp = floor.pad_to
    out, err = floor.launch(torch.zeros((2, hp, wp), dtype=torch.int32))
    assert err == 0 and out.shape == (2, g["out_h"], g["out_w"])
    ((library, entry, args),) = entry_calls
    assert (library, entry) == ("dma_floor", "dma_floor_launch")
    types = _build.argtypes(entry, (_build.CSRC / "dma_floor.cu").read_text())
    assert len(args) == len(types)
    for a, t in zip(args, types):      # in the types of its argtypes
        assert isinstance(a, float if t is ctypes.c_float else int), (a, t)
    assert args[3] == len(floor.tiles) == 2 * len(g["tile_y0"]) * len(
        g["tile_x0"])
    assert args[4] == floor.n_spans == 0        # the list form has no spans
    assert args[9:16] == (2, 45, 61, hp, wp, g["out_h"], g["out_w"])
    assert args[16:22] == (32, 32, *floor.boxes.box[0], *floor.boxes.box[1])
    assert floor.launches == 0


def test_tap_outside_its_window_is_refused():
    g = _geometry("fsr_fused", 72, 96, 0.5)
    bad = dict(g, tap_x=g["tap_x"] + _maps.IN_TILE)
    with pytest.raises(ValueError, match="outside"):
        sol.build_dma_floor(bad)
    with pytest.raises(ValueError, match="threads"):
        sol.build_dma_floor(dict(g, threads=128))
    nis = _geometry("nvscaler", 72, 96, 0.5)
    quad_x = nis["quad_x"].copy()
    quad_x[0] += 40
    with pytest.raises(ValueError, match="RGBA tap"):
        sol.build_dma_floor(dict(nis, quad_x=quad_x))


@pytest.mark.parametrize("plan,change,match", [
    ("rcas_sharpen", dict(stage="all"), "no floor form"),
    ("rcas_sharpen", dict(stage="circle"), "no floor form"),
    ("rcas_sharpen", dict(stage_quads=True), "one texel per output"),
    ("rcas_sharpen", "quads", "one texel per output"),
    ("fsr_fused", dict(quad_x=None, quad_y=None), "four-tap floors"),
    ("cas_upscale", dict(staged=None), "staged table"),
    ("nvsharpen", "quads", "one texel per output"),
    ("cas_sharpen", dict(stage_quads=True), "one texel per output"),
    ("cas_sharpen", dict(staged=None), "staged table"),
    ("nvsharpen", "shifted", "identity"),
], ids=["all", "circle", "rcas-copy-stage-quads", "rcas-copy-quads",
        "list-no-quads", "list-no-table", "copy-quads", "copy-stage-quads",
        "copy-no-table", "copy-not-own-texel"])
def test_floor_has_two_forms(plan, change, match):
    """The floor runs two forms: "copy" (the sharpen-only class kernels,
    RCAS sharpen among them: a staged table, each output's own texel
    outside) and "list" (the upscalers, four bilinear taps per output
    outside); any other is refused on the host, the "circle" form of the
    earlier one-CTA-per-16x16-tile RCAS kernel among them."""
    g = _geometry(plan, 45, 61, 0.5)
    if change == "quads":
        change = dict(quad_x=np.zeros((2, g["out_w"]), np.int32),
                      quad_y=np.zeros((2, g["out_h"]), np.int32))
    elif change == "shifted":
        change = dict(tap_x=np.clip(g["tap_x"] + 1, 0, g["in_w"] - 1))
    with pytest.raises(ValueError, match=match):
        sol.build_dma_floor(dict(g, **change))


FUSED_SHAPES = [(1869, 1683, 0.75), (2492, 2244, 1.3), (1246, 1122, 0.5),
                (96, 128, 0.75), (45, 61, 0.75)]
FUSED_CIRCLES = [(0.0, ((0.5, 0.5), (0.5, 0.5))),
                 (0.3, ((0.3, 0.6), (0.7, 0.4))),
                 (0.5, ((0.5, 0.5), (0.5, 0.5))),
                 (2.0, ((0.5, 0.5), (0.5, 0.5)))]


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("radius,eyes", FUSED_CIRCLES,
                         ids=[f"r{r}" for r, _ in FUSED_CIRCLES])
@pytest.mark.parametrize("h,w,rs", FUSED_SHAPES,
                         ids=[f"{w}x{h}-rs{rs}" for h, w, rs in FUSED_SHAPES])
def test_fused_geometry_is_the_two_kernels(h, w, rs, radius, eyes, batch):
    """B1's DMA geometry against a numpy statement of what its two kernels
    load and store (csrc/fsr_fused.cu): a 32x32 tile with an output inside
    the circle stages its 40x40 window, every word loaded edge-clamped;
    every other tile loads four bilinear taps per output from device
    memory; every output word is stored once. The floor moves those words:
    each tile's box, by TMA."""
    from openvr_fsr_tpu_torch.kernels.fsr import build_fsr_fused
    from openvr_fsr_tpu_torch.kernels._common import circle_mask
    ow, oh = Config(render_scale=rs).output_size(w, h)
    cen = C.centres_payload(ow, oh, radius, eyes,
                            tuple(i % 2 for i in range(batch)))
    g = build_fsr_fused(batch, h, w, ow, oh, sharpness=0.9,
                        centres=cen).dma_geometry
    m = _maps.fsr_maps(batch, h, w, ow, oh, cen)
    ty, tx = -(-oh // 32), -(-ow // 32)
    mask = np.zeros((batch, ty * 32, tx * 32), bool)
    mask[:, :oh, :ow] = circle_mask(torch.from_numpy(cen), oh, ow).numpy()
    inside = mask.reshape(batch, ty, 32, tx, 32).any(axis=(2, 4))
    # the floor loads one box per tile by TMA, only its in-image words: an
    # inside tile its 40x40 window, another the footprint of its four
    # bilinear taps
    words = {c: _in_image(x0, y0, bw, bh, h, w)
             for c, ((x0, bw), (y0, bh)) in _class_boxes(g).items()}
    loads = int(np.where(inside, words[1], words[0]).sum())
    assert _class_boxes(g)[1][1][1] == 40
    assert (g["tile"], g["window"], g["group"]) == ((32, 32), (40, 40),
                                                    (16, 16))
    assert (g["stage"], g["stage_quads"], g["oob"]) == ("list", False,
                                                       "clamp")
    assert np.array_equal(g["staged"], inside)
    assert np.array_equal(g["quad_x"][1], m.col_i[1])
    assert np.array_equal(g["quad_y"][1], m.row_i[1])
    assert np.array_equal(g["tap_x"], np.clip(m.col_i[0], 0, w - 1))
    assert np.array_equal(g["tap_y"], np.clip(m.row_i[0], 0, h - 1))
    floor = sol.build_dma_floor(g)
    assert floor.read_bytes == 4 * loads
    assert floor.write_bytes == 4 * batch * oh * ow
