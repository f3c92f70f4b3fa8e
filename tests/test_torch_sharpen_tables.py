"""The host tables of the redesigned sharpen-only kernels, B6 CAS sharpen
(csrc/cas_sharpen.cu), B4 NVSharpen (csrc/nis_sharpen.cu) and B2 RCAS
sharpen (csrc/rcas_sharpen.cu), their entry points and the DMA geometries
they publish, on the CPU.

Each kernel launches two class kernels from host tile lists
(kernels/_maps.py::sharpen_maps): the shared copy pass (csrc/copy_pass.cuh)
over the 32x32 tiles outside the foveation circle and the inside kernel
over the others. Held here:
  - the classes are the reference's circle test (kernels/_common.py::
    circle_mask, the plain versions' select) read at every pixel, per 16x16
    group (B6, B2) and per 32x32 block (B4), and the lists partition the
    tiles;
  - each geometry is a numpy statement of what the two kernels load and
    store, and the DMA floor's own check passes;
  - the wrappers pass the lists to one C entry point whose ctypes argtypes
    are its prototype in the source;
  - the shared words per inside pixel the audit prices are the sources'.

The CUDA kernels run only on the card: `python3 chip_smoke.py` holds them
against their plain versions there, texel for texel.
"""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.kernels import (  # noqa: E402
    _build, _maps, cas, nis, rcas, sol)
from openvr_fsr_tpu_torch.kernels._common import circle_mask  # noqa: E402
from openvr_fsr_tpu_torch.tools import ab  # noqa: E402
from openvr_fsr_tpu_torch.tools import vpu_audit as A  # noqa: E402

CENTRED = ((0.5, 0.5), (0.5, 0.5))
OFF_CENTRE = ((0.3, 0.6), (0.7, 0.4))
SHAPES = [(45, 61), (96, 128), (2492, 2244)]
CIRCLES = [(0.0, CENTRED), (0.3, OFF_CENTRE), (0.5, CENTRED),
           (2.0, CENTRED)]
SHAPE_IDS = [f"{w}x{h}" for h, w in SHAPES]
CIRCLE_IDS = [f"r{r}" for r, _ in CIRCLES]
# kernel -> (foveation group, staged window edge, out-of-image words)
KERNELS = {"cas_sharpen": ((16, 16), 34, "zero"),
           "nis_sharpen": ((32, 32), 36, "clamp"),
           "rcas_sharpen": ((16, 16), 34, "zero")}
# kernel -> (its wrapper module, the module's entry-point getter)
ENTRIES = {"cas_sharpen": (cas, "_sharpen_launch_fn"),
           "nis_sharpen": (nis, "_sharpen_fn"),
           "rcas_sharpen": (rcas, "_launch_fn")}


def _centres(h, w, radius, eyes, batch):
    return C.centres_payload(w, h, radius, eyes,
                             tuple(i % 2 for i in range(batch)))


def _build_kernel(kernel, batch, h, w, cen, hdr=0):
    if kernel == "cas_sharpen":
        return cas.build_cas_sharpen(batch, h, w, sharpness=0.8, centres=cen)
    if kernel == "rcas_sharpen":
        return rcas.build_rcas_sharpen(batch, h, w, sharpness=0.9,
                                       centres=cen)
    cfg = C.nvsharpen_update_config(0.9, w, h, w, h, hdr_mode=hdr)
    return nis.build_nvsharpen(batch, h, w, nis_cfg=cfg, centres=cen)


def _tiles_any(mask, tile):
    """(B, TY, TX) bool: a tile-square tile holds a True pixel."""
    b, oh, ow = mask.shape
    ty, tx = -(-oh // tile), -(-ow // tile)
    pad = np.zeros((b, ty * tile, tx * tile), bool)
    pad[:, :oh, :ow] = mask
    return pad.reshape(b, ty, tile, tx, tile).any(axis=(2, 4))


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("radius,eyes", CIRCLES, ids=CIRCLE_IDS)
@pytest.mark.parametrize("h,w", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_classes_and_lists_are_the_circle_test(kernel, h, w, radius, eyes,
                                               batch):
    """The group classes are the circle test read at every pixel of each
    group; the lists partition the 32x32 tiles, a tile inside where any of
    its outputs is, in order."""
    group = KERNELS[kernel][0]
    cen = _centres(h, w, radius, eyes, batch)
    m = _maps.sharpen_maps(batch, h, w, cen, group)
    mask = circle_mask(torch.from_numpy(cen), h, w, group).numpy()
    gw, gh = group
    assert m.group_cls.dtype == np.int32
    assert m.group_cls.shape == (batch, -(-h // gh), -(-w // gw))
    per_pixel = np.repeat(np.repeat(m.group_cls.astype(bool), gh, 1), gw, 2)
    assert np.array_equal(per_pixel[:, :h, :w], mask)
    flags = _tiles_any(mask, _maps.SHARPEN_TILE)
    ids = np.arange(flags.size)
    assert m.inside_tiles.dtype == m.outside_tiles.dtype == np.int32
    assert np.array_equal(m.inside_tiles, ids[flags.ravel()])
    assert np.array_equal(m.outside_tiles, ids[~flags.ravel()])
    assert np.array_equal(m.tile_inside, flags)
    assert np.array_equal(m.centres, np.asarray(cen).reshape(batch, 5))
    if radius == 2.0:
        assert len(m.outside_tiles) == 0
    if radius == 0.0:
        assert len(m.inside_tiles) == 0


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("radius,eyes", CIRCLES, ids=CIRCLE_IDS)
@pytest.mark.parametrize("h,w", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_geometry_is_the_two_kernels(kernel, h, w, radius, eyes, batch):
    """B6's, B4's and B2's DMA geometries against a numpy statement of what
    their two kernels load and store: an inside tile stages its window at
    (32 t - halo) (B6, B2: 34x34, the words outside the image staged as 0
    without a load; B4: 36x36 edge-clamped, its centre texels from the
    window too); every other tile copies its own texels; every output word
    is stored once."""
    group, win, oob = KERNELS[kernel]
    halo = (win - 32) // 2
    cen = _centres(h, w, radius, eyes, batch)
    g = _build_kernel(kernel, batch, h, w, cen).dma_geometry
    m = _maps.sharpen_maps(batch, h, w, cen, group)
    sol.check_geometry(g)
    assert (g["tile"], g["window"], g["group"]) == ((32, 32), (win, win),
                                                    group)
    assert (g["stage"], g["oob"], g["stage_quads"]) == ("copy", oob, False)
    assert g["quad_x"] is None and g["quad_y"] is None
    assert np.array_equal(g["staged"], m.tile_inside)
    ty, tx = m.tile_inside.shape[1:]
    assert np.array_equal(g["tile_x0"], np.arange(tx) * 32 - halo)
    assert np.array_equal(g["tile_y0"], np.arange(ty) * 32 - halo)
    assert np.array_equal(g["tap_x"], np.arange(w))
    assert np.array_equal(g["tap_y"], np.arange(h))
    outs = (np.minimum(32, h - np.arange(ty) * 32)[:, None]
            * np.minimum(32, w - np.arange(tx) * 32)[None, :])
    # the floor moves those words by TMA, one box per tile, reading only
    # its in-image words (edge-clamped or zero, the window's in-image words
    # are the same): an inside tile's window from 4 words before the tile
    # (its rows start on 16 bytes) to the window's end, 40 words wide,
    # another tile's own texels
    x0 = np.arange(tx) * 32 - 4
    nx = np.clip(x0 + 40, 0, w) - np.clip(x0, 0, w)
    ny = np.clip(g["tile_y0"] + win, 0, h) - np.clip(g["tile_y0"], 0, h)
    stage = ny[:, None] * nx[None, :]
    floor = sol.build_dma_floor(g)
    assert floor.boxes.box == ((32, 32), (40, win))
    assert np.array_equal(floor.boxes.x0[1], x0)
    assert floor.read_bytes == 4 * int(np.where(m.tile_inside, stage,
                                                outs).sum())
    assert floor.write_bytes == floor.hbm_bytes - 4 * batch * h * w \
        == 4 * batch * h * w


# the entry point of the earlier RCAS sharpen source (one CTA per 16x16
# tile with its own circle test), which tools/ab.py drives as the parent
PARENT_RCAS_PROTOTYPE = """
extern "C" int rcas_sharpen_launch(const void* img, void* out, const void* centres, int batch,
                                   int h, int w, int rows, int pitch, float sharp, float tint,
                                   void* stream) {
"""


# the entry points of the earlier tensor-core probe (mma.sync; the same
# prototype as the current wgmma one) and DMA floor (one CTA per tile in the
# compute kernel's launch shape), which tools/ab.py drives as the parents
PARENT_MXU_PROTOTYPE = """
extern "C" int mxu_rate_launch(const void* x, const void* w, void* partials, void* out,
                               int tile, int k, int steps, void* stream) {
"""
PARENT_FLOOR_PROTOTYPE = """
extern "C" int dma_floor_launch(const void* img, void* out, const void* tile_x0,
                                const void* tile_y0, const void* tap_x, const void* tap_y,
                                const void* quad_x, const void* quad_y, const void* staged,
                                int batch, int in_h, int in_w, int rows,
                                int pitch, int out_h, int out_w, int tile_w, int tile_h, int win_w,
                                int win_h, int threads, int stage, int stage_quads, int clamp,
                                unsigned int mask, void* stream) {
"""


def _prototype_argtypes(kernel, entry, text=None):
    """The ctypes types of the C prototype `entry` in csrc/<kernel>.cu (or
    in `text`): pointers as c_void_p, int as c_int, float as c_float."""
    if text is None:
        text = (_build.CSRC / f"{kernel}.cu").read_text()
    (params,) = re.findall(rf'extern "C" int {entry}\((.*?)\)\s*\{{', text,
                           re.S)
    types = []
    for p in params.split(","):
        p = " ".join(p.split())
        types.append(ctypes.c_void_p if "*" in p else
                     {"int": ctypes.c_int, "float": ctypes.c_float,
                      "unsigned": ctypes.c_uint}[p.split()[0]])
    return types


@pytest.mark.parametrize("kernel,module", [("cas_sharpen", cas),
                                           ("nis_sharpen", nis),
                                           ("rcas_sharpen", rcas)])
def test_argtypes_are_the_prototype(kernel, module):
    """The wrapper binds the entry point with the types of its prototype,
    one per parameter (a pointer bound as c_int would be cut to 32 bits)."""
    assert module.SHARPEN_ARGTYPES == _prototype_argtypes(
        kernel, f"{kernel}_launch")


@pytest.mark.parametrize("kernel,text", [
    ("rcas_sharpen", PARENT_RCAS_PROTOTYPE), ("mxu_rate", PARENT_MXU_PROTOTYPE),
    ("dma_floor", PARENT_FLOOR_PROTOTYPE)])
def test_parent_argtypes_are_the_earlier_prototypes(kernel, text):
    """tools/ab.py binds each earlier entry point it drives with the types
    of that source's prototype; the tensor-core probe's is also the current
    source's, so the parent runs through the current wrapper."""
    assert ab.PARENT_ARGTYPES[kernel] == _prototype_argtypes(
        kernel, f"{kernel}_launch", text)
    if kernel == "mxu_rate":
        assert ab.PARENT_ARGTYPES[kernel] == _prototype_argtypes(
            kernel, f"{kernel}_launch")


def test_floor_argtypes_are_the_prototype():
    assert sol.FLOOR_ARGTYPES == _prototype_argtypes("dma_floor",
                                                     "dma_floor_launch")


def _conforms(args, argtypes):
    """Each argument is a Python value ctypes converts to its type."""
    assert len(args) == len(argtypes)
    for a, t in zip(args, argtypes):
        if t is ctypes.c_float:
            assert isinstance(a, float), (a, t)
        elif t in (ctypes.c_int, ctypes.c_uint):
            assert isinstance(a, int) and not isinstance(a, bool), (a, t)
        else:
            assert a is None or isinstance(a, int), (a, t)


def _launch_closure(fn):
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return cells["launch"]


@pytest.mark.parametrize("radius", [0.0, 0.5, 2.0])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_launch_passes_the_lists(kernel, radius, monkeypatch):
    """The launch hands the entry point the inside and outside lists with
    their lengths, the 32x32 tile and the window edge, the frame's pitch,
    and nothing the prototype does not take."""
    h, w, hp, wp = 70, 75, 72, 128
    cen = _centres(h, w, radius, CENTRED, 2)
    fn = _build_kernel(kernel, 2, h, w, cen, hdr=2)
    m = _maps.sharpen_maps(2, h, w, cen, KERNELS[kernel][0])
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0
    module, getter = ENTRIES[kernel]
    monkeypatch.setattr(module, getter, lambda: entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "S", (), {"cuda_stream": 0})())
    out, err = _launch_closure(fn)(torch.zeros((2, hp, wp), dtype=torch.int32))
    assert err == 0 and out.shape == (2, h, w)
    args = seen["args"]
    _conforms(args, module.SHARPEN_ARGTYPES)
    win = KERNELS[kernel][1]
    assert args[-3:-1] == (_maps.SHARPEN_TILE, win)
    n_in, n_out = len(m.inside_tiles), len(m.outside_tiles)
    if kernel == "cas_sharpen":
        assert (args[4], args[6]) == (n_in, n_out)
        assert args[7:12] == (2, h, w, hp, wp)
        assert args[13] == np.float32(1.0)            # max_color_delta
    elif kernel == "rcas_sharpen":
        assert (args[4], args[6]) == (n_in, n_out)
        assert args[7:12] == (2, h, w, hp, wp)
        assert args[12:14] == (float(C.fsr_rcas_con(
            C.rcas_stops_from_slider(0.9))), 1.0)    # sharp, tint
    else:
        assert (args[3], args[5]) == (n_in, n_out)
        assert args[7:14] == (16, 2, h, w, hp, wp, 2)   # consts, hdr_mode
    assert n_in + n_out == 2 * 3 * 3


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("kernel", list(ab.SHARPEN_KERNELS))
def test_parent_launchers_take_the_earlier_entry_points(kernel, case,
                                                        monkeypatch):
    """The A/B tool drives the earlier sharpen kernels (one CTA per tile
    with its own circle test) with the centres and the constants each case
    asks for, in the types of their argtypes."""
    if kernel == "rcas_sharpen" and case == 0:
        assert ab.PARENT_ARGTYPES[kernel] == _prototype_argtypes(
            "rcas_sharpen", "rcas_sharpen_launch", PARENT_RCAS_PROTOTYPE)
    label, h, w, rs, radius, hdr, mcd = ab.CASES[kernel][case]
    assert (h, w, rs) == (2492, 2244, 1.0)
    h, w = 45, 61
    cen = _centres(h, w, radius, CENTRED, 2)
    fn, maps, kw = ab._build_current(kernel, 2, h, w, w, h, cen, hdr, mcd)
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "S", (), {"cuda_stream": 0})())
    run = ab.parent_launcher(kernel, entry, maps, 2, torch.device("cpu"),
                             **kw)
    assert run(torch.zeros((2, h, w), dtype=torch.int32)).shape == (2, h, w)
    args = seen["args"]
    _conforms(args, ab.PARENT_ARGTYPES[kernel])
    assert np.array_equal(maps.centres, np.asarray(cen).reshape(2, 5))
    if kernel == "cas_sharpen":
        assert args[3:8] == (2, h, w, h, w)
        assert args[8:10] == (float(cas.cas_setup(ab.SHARPNESS)), mcd)
    elif kernel == "rcas_sharpen":
        assert args[3:8] == (2, h, w, h, w)
        assert args[8:10] == (float(C.fsr_rcas_con(
            C.rcas_stops_from_slider(ab.SHARPNESS))), 1.0)
    else:
        assert args[4:12] == (16, 2, h, w, h, w, hdr, 1.0)
    assert fn.dma_geometry["stage"] == "copy"


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\w+)", text).group(1))


@pytest.mark.parametrize("kernel,edge,first,later", [
    ("cas_sharpen", "kTile", (3, 3, 3), (1, 3, 3)),
    ("nis_sharpen", "kBlock", (5, 5, 1), (1, 5, 1)),
    ("rcas_sharpen", "kTile", (1, 5, 1), (1, 3, 1))])
def test_smem_words_recounted_from_the_sources(kernel, edge, first, later):
    """A thread's run of outputs down one column reads its taps at the
    first output, (rows, taps per row, planes): B6 3 rows of 3 taps x 3
    f32 planes, B4 5 rows of 5 lumas, B2 (on the levels, at RGBA8 and
    full precision) the 5 taps of the cross, one packed word each; and at
    each later one only what slides in: B6 and B4 one new row, B2 its new
    left, right and bottom taps (the top and centre are the last row's
    centre and bottom): 13.5, 10 and 3.5 words. B4 also reads its staged
    centre texel, and B2 per channel one float2 of each of its two level
    tables (4 words). The audit's words per inside pixel are that sum:
    13.5, 11 and 15.5."""
    text = (_build.CSRC / f"{kernel}.cu").read_text()
    tile = _constant(text, edge)
    run = tile * tile // _constant(text, "kThreads")
    assert (tile, run) == (_maps.SHARPEN_TILE, 4)
    taps = (np.prod(first) + (run - 1) * np.prod(later)) / run
    assert taps == {"cas_sharpen": 13.5, "nis_sharpen": 10,
                    "rcas_sharpen": 3.5}[kernel]
    words = taps + (1 if kernel == "nis_sharpen" else 0)
    if kernel == "rcas_sharpen":   # its loop over the 3 channels
        reads = re.findall(r"const float2 \w+ = s\.(lo|hi)\[m[nx]\.level\(c\)\];",
                           text)
        assert sorted(reads) == ["hi", "lo"]
        words += 3 * 2 * len(reads)
    assert A.SMEM_WORDS[kernel] == (words, 0)
    assert words == {"cas_sharpen": 13.5, "nis_sharpen": 11,
                     "rcas_sharpen": 15.5}[kernel]
    # the slide is the one text the ablation edits
    old, new = ab.ABLATIONS[kernel]["noslide"][1][0]
    assert text.count(old) == 1


@pytest.mark.parametrize("radius,eyes", CIRCLES, ids=CIRCLE_IDS)
def test_rcas_reference_selects_by_the_group_classes(radius, eyes):
    """rcas_sharpen_reference's select (sharpened, alpha 1, inside; the
    source's alpha outside) is the per-pixel expansion of the 16x16 group
    classes that the class kernels launch from."""
    h, w = 45, 61
    cen = _centres(h, w, radius, eyes, 2)
    m = _maps.sharpen_maps(2, h, w, cen, (16, 16))
    img = torch.zeros((2, h, w), dtype=torch.int32)   # alpha 0 everywhere
    out = rcas.rcas_sharpen_reference(img, torch.from_numpy(m.centres), 0.5,
                                      1.0)
    alpha = (out.numpy().view(np.uint32) >> 24).astype(np.int64)
    per_pixel = np.repeat(np.repeat(m.group_cls, 16, 1), 16, 2)[:, :h, :w]
    assert np.array_equal(alpha, per_pixel * 255)


@pytest.mark.parametrize("plan", ["rcas_sharpen", "nvsharpen", "fsr_fused",
                                  "nvscaler", "cas_upscale"])
def test_parent_floor_takes_the_earlier_entry_point(plan, monkeypatch):
    """The A/B tool drives the earlier DMA floor with the tables it was
    written for: window origins, null taps where they are the identity,
    the four-tap floors of stage "list", the staged table, and the
    geometry's shape, in the types of its argtypes."""
    from openvr_fsr_tpu_torch import Config, Pipeline
    kw = {"rcas_sharpen": dict(render_scale=1.0),
          "nvsharpen": dict(render_scale=1.0, use_nis=True),
          "fsr_fused": dict(render_scale=0.75),
          "nvscaler": dict(render_scale=0.75, use_nis=True),
          "cas_upscale": dict(render_scale=0.75, use_cas=True)}[plan]
    h, w = 45, 61
    g = Pipeline(Config(enabled=True, radius=0.5, **kw), device="cpu")._build(
        2, h, w, (0, 1), True).dma_geometry
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "S", (), {"cuda_stream": 0})())
    run = ab.parent_floor(entry, g, torch.device("cpu"))
    assert run(torch.zeros((2, h, w), dtype=torch.int32)).shape == (
        2, g["out_h"], g["out_w"])
    args = seen["args"]
    _conforms(args, ab.PARENT_ARGTYPES["dma_floor"])
    copy = g["stage"] == "copy"
    assert (args[4] is None) == (args[5] is None) == copy    # taps
    assert (args[6] is None) == (args[7] is None) == copy    # four-tap floors
    assert args[9:16] == (2, h, w, h, w, g["out_h"], g["out_w"])
    assert args[16:21] == (*g["tile"], *g["window"], 256)
    assert args[21:25] == ({"list": 0, "copy": 1}[g["stage"]],
                           int(g["stage_quads"]), int(g["oob"] == "clamp"), 0)
