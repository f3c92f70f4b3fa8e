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

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu import Config as JConfig  # noqa: E402
from openvr_fsr_tpu import Pipeline as JPipeline  # noqa: E402
from openvr_fsr_tpu.kernels import sol as jsol  # noqa: E402

from openvr_fsr_tpu_torch import Config, Pipeline  # noqa: E402
from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.kernels import _maps  # noqa: E402
from openvr_fsr_tpu_torch.kernels import sol  # noqa: E402

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


def _emulate(img, g):
    """The floor kernel in numpy, CTA by CTA: (output, words loaded).
    Asserts that every staged read lies inside the CTA's window."""
    B, H, W = g["batch"], g["in_h"], g["in_w"]
    OH, OW = g["out_h"], g["out_w"]
    (tw, th), (ww, wh) = g["tile"], g["window"]
    out = np.zeros((B, OH, OW), np.int32)
    loads = 0
    for b in range(B):
        for ty in range(-(-OH // th)):
            oy = np.arange(ty * th, min(ty * th + th, OH))
            for tx in range(-(-OW // tw)):
                ox = np.arange(tx * tw, min(tx * tw + tw, OW))
                n = len(oy) * len(ox)
                if g["staged"][b, ty, tx]:
                    y = g["tile_y0"][ty] + np.arange(wh)
                    x = g["tile_x0"][tx] + np.arange(ww)
                    win = img[b][np.ix_(np.clip(y, 0, H - 1),
                                        np.clip(x, 0, W - 1))]
                    if g["oob"] == "zero":
                        valid = (((y >= 0) & (y < H))[:, None]
                                 & ((x >= 0) & (x < W))[None, :])
                        win = np.where(valid, win, 0)
                        loads += int(valid.sum())
                    else:
                        loads += ww * wh
                    ry = g["tap_y"][oy] - y[0]
                    rx = g["tap_x"][ox] - x[0]
                    assert ry.min() >= 0 and ry.max() < wh
                    assert rx.min() >= 0 and rx.max() < ww
                    out[b][np.ix_(oy, ox)] = win[np.ix_(ry, rx)]
                    loads += 4 * n if g["stage_quads"] else 0
                elif g["stage"] == "list":
                    qy = np.clip(g["quad_y"][1][oy], 0, H - 1)
                    qx = np.clip(g["quad_x"][1][ox], 0, W - 1)
                    out[b][np.ix_(oy, ox)] = img[b][np.ix_(qy, qx)]
                    loads += 4 * n
                else:
                    out[b][np.ix_(oy, ox)] = \
                        img[b][np.ix_(g["tap_y"][oy], g["tap_x"][ox])]
                    loads += n
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


def test_tap_outside_its_window_is_refused():
    g = _geometry("fsr_fused", 72, 96, 0.5)
    bad = dict(g, tap_x=g["tap_x"] + _maps.IN_TILE)
    with pytest.raises(ValueError, match="outside"):
        sol.build_dma_floor(bad)
    with pytest.raises(ValueError, match="threads"):
        sol.build_dma_floor(dict(g, threads=128))


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
    memory; every output word is stored once."""
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
    outs = (np.minimum(32, oh - np.arange(ty) * 32)[:, None]
            * np.minimum(32, ow - np.arange(tx) * 32)[None, :])
    loads = int(np.where(inside, 40 * 40, 4 * outs).sum())
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
