"""The memory speed-of-light yardstick (B7): the DMA floor of one compute
kernel, as a CUDA kernel (csrc/dma_floor.cu), and its plain version.

The port of the JAX package's kernels/sol.py::build_dma_floor.
`build_dma_floor` consumes the DMA geometry a kernel build publishes
(`fn.dma_geometry`, kernels/_maps.py::dma_geometry) and builds a kernel
that moves the words that kernel moves and computes nothing, with perfect
overlap: per output tile the window of a tile the kernel stages, or what
its outside pass reads there (the footprint of its four bilinear taps),
loaded by TMA as one box by persistent CTAs, or its own texels, copied
straight in spans of neighbouring tiles, a CTA each; every output word
stored once. Where the persistent CTAs would take one box each (a strip,
or a frame small enough), a kernel of its own takes a CTA per tile and
gathers each output's word straight from the frame: at such sizes the
compute kernel runs near a launch's floor, and the TMA's set-up would
cost more than its loads save.
Its time is the least time this card needs to move the kernel's exact
words, so vs_sol = floor / kernel <= 1
when both are timed in one process over the same frames (bench.py,
tools/bench_paths.py).

What it describes is the CUDA kernel's own traffic, not the TPU kernel's:
the TPU floor DMAs one row band per grid step (its read_bytes count band
windows); this one loads tile boxes, overlaps included. It runs in 4-byte
words: a 10-bit build's geometry holds two words per R10G10B10A2 texel
(kernels/_maps.py::word_geometry), its tiles are 64 words wide, and its
floor takes and returns the kernel's own uint16 frames, moving their
words.

The rate probes (B8) follow: the FP32 rate (build_vpu_rate,
csrc/vpu_rate.cu), the shared-memory rate (build_vmem_rate,
csrc/vmem_rate.cu) and the tensor-core rate (build_mxu_rate,
csrc/mxu_rate.cu), the ports of the JAX package's sol.py:106-338, each with
its plain version. tools/vpu_audit.py times two k of each and takes the
slope. The TPU probes accumulate into one output block over a sequential
grid; here CTAs write partials that a second pass adds in a fixed order,
which the plain versions repeat.
"""

import dataclasses

import numpy as np
import torch

from . import _build
from ._common import DeviceTables, kernel_fn
from ._maps import THREADS, _Tables

__all__ = ["build_dma_floor", "dma_floor_reference", "check_geometry",
           "floor_tiles", "floor_boxes", "floor_loads", "tile_loads",
           "clip_words", "band_rows", "grid_rows", "wt_swizzle_offset",
           "vpu_cycle", "build_vpu_rate", "vpu_rate_reference",
           "build_vmem_rate", "vmem_rate_reference", "build_mxu_rate",
           "mxu_rate_reference", "MXU_TOLERANCE", "PITCH_WORDS"]

# csrc/dma_floor.cu: TMA boxes are at most BOX_MAX words on a side, their
# rows start and end on 16-byte boundaries (multiples of BOX_ALIGN words),
# and the frame's row pitch is a multiple of PITCH_WORDS words (16 bytes);
# a tile is 32 outputs wide: FLOOR_TILE_W words per texel word
BOX_MAX = 256
BOX_ALIGN = 4
PITCH_WORDS = 4
FLOOR_STAGES = 4            # boxes in flight per CTA (kStages)
FLOOR_SPAN = 4              # outside tiles per span item of the copy form
FLOOR_TILE_W = 32


def clip_words(cols, n_in, texel_words, right=0):
    """The word of the edge-clamped texel `right` texels to the right of
    each word column in `cols` (word k of texel x is x * texel_words + k):
    clip(x + right, 0, texels - 1) * texel_words + k, over n_in words. At
    one word per texel, clip(cols + right, 0, n_in - 1)."""
    cols = np.asarray(cols, np.int64)
    n = int(texel_words)
    return np.clip(cols // n + right, 0, n_in // n - 1) * n + cols % n


def floor_tiles(geom):
    """The floor's item list: (n, 4) int32 rows (b, ty, tx, kind), each
    (b, ty, tx) in exactly one item, the span items first (one CTA each),
    then the box items (the persistent CTAs'), each part in (b, ty, tx)
    order. kind 1: a tile the compute kernel stages (its window's box); 0:
    another tile of stage "list" (its footprint's box); -n: in stage
    "copy" with output rows of whole 16-byte units, a span of n <=
    FLOOR_SPAN neighbouring outside tiles of one tile row from tx, copied
    straight."""
    staged = np.asarray(geom["staged"], bool)
    spans = geom["stage"] == "copy" and geom["out_w"] % BOX_ALIGN == 0
    items = []
    for b, ty, tx in np.ndindex(staged.shape):
        if staged[b, ty, tx] or not spans:
            items.append([b, ty, tx, int(staged[b, ty, tx])])
        elif (items and items[-1][:2] == [b, ty] and items[-1][3] < 0
              and items[-1][2] - items[-1][3] == tx
              and items[-1][3] > -FLOOR_SPAN):
            items[-1][3] -= 1
        else:
            items.append([b, ty, tx, -1])
    items = np.array(items, np.int32).reshape(-1, 4)
    return items[np.argsort(items[:, 3] >= 0, kind="stable")]


@dataclasses.dataclass(frozen=True)
class FloorBoxes:
    """The box each tile loads, per class (0: a tile that does not stage,
    1: a staging tile): box[c] its (width, height) in words; x0[c] / y0[c]
    its origin per tile column / row (may lie outside the image, whose
    words read as 0); rel_x[c] / rel_y[c] each output column's / row's tap
    as a box column / row, padded to whole tiles with 0."""

    box: tuple
    x0: np.ndarray
    y0: np.ndarray
    rel_x: np.ndarray
    rel_y: np.ndarray


def _rel(origins, taps, tile):
    """taps - the origin of their tile, padded to whole tiles with 0."""
    rel = np.zeros(len(origins) * tile, np.int64)
    rel[:len(taps)] = taps - np.repeat(origins, tile)[:len(taps)]
    return rel


def _spans(lo, hi, tile):
    """Per tile, the first of lo and the last of hi."""
    starts = range(0, len(lo), tile)
    return (np.array([lo[a:a + tile].min() for a in starts]),
            np.array([hi[a:a + tile].max() for a in starts]))


def _box(first, last, align):
    """One axis of a class's boxes over per-tile spans [first, last]: the
    origins, first rounded down to a multiple of `align` words (TMA starts
    a box's rows on a 16-byte boundary), and the one extent, the largest
    span from its origin rounded up to a multiple of `align`."""
    start = first // align * align
    return start, -(-int((last - start).max() + 1) // align) * align


def floor_boxes(geom):
    """The boxes of the floor's two tile classes (FloorBoxes). A staging
    tile loads its window; another tile of stage "copy" its own texels (the
    tile), of stage "list" the footprint of its four edge-clamped bilinear
    taps (quad row 1). Each class's box starts its rows on a 16-byte
    boundary (the origin's column rounded down to BOX_ALIGN words) and is
    as wide as the widest span from there, rounded up to BOX_ALIGN words,
    and as high as the highest; the words that adds are loaded too. Raises
    ValueError on a box beyond BOX_MAX or a ring beyond shared memory."""
    g = geom
    (tw, th), (ww, wh) = g["tile"], g["window"]
    axes = []
    for tile, win, n_in, origins, taps, quad, align, words in (
            (tw, ww, g["in_w"], g["tile_x0"], g["tap_x"], g["quad_x"],
             BOX_ALIGN, g.get("texel_words", 1)),
            (th, wh, g["in_h"], g["tile_y0"], grid_rows(g, g["tap_y"]),
             grid_rows(g, g["quad_y"]), 1, 1)):
        origins = origins.astype(np.int64)
        if g["stage"] == "list":
            q = quad[1]
            outside_taps = clip_words(q, n_in, words)
            spans = _spans(outside_taps, clip_words(q, n_in, words, 1),
                           tile)
        else:
            outside_taps = np.arange(len(taps))
            spans = _spans(outside_taps, outside_taps, tile)
        boxes = [_box(*spans, align), _box(origins, origins + win - 1, align)]
        exts = tuple(ext for _, ext in boxes)
        if max(exts) > BOX_MAX:
            raise ValueError(f"a floor box of {max(exts)} words exceeds "
                             f"TMA's {BOX_MAX}")
        axes.append((exts, np.stack([start for start, _ in boxes]).astype(
            np.int32), np.stack([_rel(boxes[0][0], outside_taps, tile),
                                 _rel(boxes[1][0], taps, tile)]).astype(
            np.int32)))
    (ex, x0, rel_x), (ey, y0, rel_y) = axes
    ring = FLOOR_STAGES * max(ex[0] * ey[0], ex[1] * ey[1]) * 4
    if ring > SMEM_MAX - 256:
        raise ValueError(f"{FLOOR_STAGES} floor boxes take {ring} bytes of "
                         f"shared memory, above {SMEM_MAX - 256}")
    return FloorBoxes(((ex[0], ey[0]), (ex[1], ey[1])), x0, y0, rel_x, rel_y)


def tile_loads(geom, boxes=None):
    """(B, tiles_y, tiles_x) words each tile of the floor loads from the
    frame: the in-image words of its class's box (TMA reads no word
    outside the image); a span item's tiles read the same words, their own
    texels."""
    g = geom
    b = floor_boxes(g) if boxes is None else boxes
    (bw0, bh0), (bw1, bh1) = b.box
    x0, y0 = b.x0.astype(np.int64), b.y0.astype(np.int64)
    nx = (np.clip(x0 + np.array([[bw0], [bw1]]), 0, g["in_w"])
          - np.clip(x0, 0, g["in_w"]))
    ny = (np.clip(y0 + np.array([[bh0], [bh1]]), 0, g["in_h"])
          - np.clip(y0, 0, g["in_h"]))
    words = ny[:, :, None] * nx[:, None, :]          # (2, tiles_y, tiles_x)
    return np.where(g["staged"], words[1], words[0])


def floor_loads(geom, boxes=None):
    """Words one launch loads from the frame, overlaps included: the sum
    of tile_loads."""
    return int(tile_loads(geom, boxes).sum())


def band_rows(geom):
    """(row0, row1): the rows of the geometry's tile grid that its outputs
    are, the band of a strip geometry (kernels/_maps.py::band_geometry),
    else (0, out_h)."""
    return tuple(geom.get("band") or (0, geom["out_h"]))


def grid_rows(geom, rows):
    """Per-output-row values (the last axis of `rows`: tap_y, quad_y) laid
    over the rows of the tile grid: a band's row0 leading rows, which no
    output is, take the first output row's values (the same tile row, so no
    span or box grows); None stays None."""
    row0 = band_rows(geom)[0]
    if rows is None or not row0:
        return rows
    rows = np.asarray(rows)
    return np.concatenate([np.repeat(rows[..., :1], row0, -1), rows], -1)


def check_geometry(geom):
    """Raise ValueError unless the floor can run `geom`: 256 threads per
    CTA and tiles 32 outputs wide (FLOOR_TILE_W words per texel word); a
    band (band_rows) of out_h rows from row0 < the tile height, over its
    tile rows, in stage "list" only;
    stage "copy" with no
    four-tap floors, no stage_quads, a staged table of the grid's shape and
    each output's tap its own texel, or "list" with the floors and a staged
    table; every output's tap inside the window of its tile, and where
    stage_quads every RGBA tap (quad row 0, edge-clamped) too."""
    g = geom
    if g["threads"] != THREADS:
        raise ValueError(f"the DMA floor runs {THREADS} threads per CTA, "
                         f"the geometry {g['threads']}")
    words = g.get("texel_words", 1)
    if g["tile"][0] != FLOOR_TILE_W * words:
        raise ValueError(f"the DMA floor takes tiles {FLOOR_TILE_W} outputs "
                         f"({FLOOR_TILE_W * words} words) wide, not "
                         f"{g['tile']}")
    grid = (g["batch"], len(g["tile_y0"]), len(g["tile_x0"]))
    row0, row1 = band_rows(g)
    if row1 - row0 != g["out_h"] or not 0 <= row0 < g["tile"][1] or \
            len(g["tile_y0"]) != -(-row1 // g["tile"][1]):
        raise ValueError(f"the band's rows {(row0, row1)} are not "
                         f"{g['out_h']} rows from the first of "
                         f"{len(g['tile_y0'])} tile rows")
    if row0 and g["stage"] != "list":
        raise ValueError("a band form takes stage 'list' (a strip of B1 or "
                         "B5)")
    if g["stage"] == "list":
        if np.shape(g["staged"]) != grid or g["quad_x"] is None:
            raise ValueError(f"stage 'list' needs a staged table of shape "
                             f"{grid} and the four-tap floors")
    elif g["stage"] == "copy":
        if g["quad_x"] is not None or g["stage_quads"]:
            raise ValueError("stage 'copy' copies one texel per output: no "
                             "four-tap floors")
        if np.shape(g["staged"]) != grid:
            raise ValueError(f"stage 'copy' needs a staged table of shape "
                             f"{grid}")
        if not _identity_taps(g):
            raise ValueError("stage 'copy' copies each output's own texel: "
                             "the taps must be the identity")
    else:
        raise ValueError(f"no floor form for stage {g['stage']!r}")
    for axis, tile, win, origins, taps, quad, n_in, n in (
            ("column", g["tile"][0], g["window"][0], g["tile_x0"],
             g["tap_x"], g["quad_x"], g["in_w"], words),
            ("row", g["tile"][1], g["window"][1], g["tile_y0"],
             grid_rows(g, g["tap_y"]), grid_rows(g, g["quad_y"]), g["in_h"],
             1)):
        first = np.repeat(origins, tile)[:len(taps)]
        rel = taps - first
        if rel.min() < 0 or rel.max() >= win:
            raise ValueError(f"an output {axis}'s tap lies outside the "
                             f"{win}-wide window of its tile")
        if g["stage_quads"]:
            q = quad[0]
            if (clip_words(q, n_in, n) < first).any() or \
                    (clip_words(q, n_in, n, 1) >= first + win).any():
                raise ValueError(f"an output {axis}'s RGBA tap lies outside "
                                 f"the {win}-wide window of its tile")


def _identity_taps(g):
    return (np.array_equal(g["tap_x"], np.arange(g["out_w"]))
            and np.array_equal(g["tap_y"], np.arange(g["out_h"])))


def dma_floor_reference(img, geom):
    """The floor's output in plain torch, on img's device: each output word
    is the input word at its tap (tap_y, tap_x); in a tile of stage "list"
    that does not stage, the first of its four bilinear taps instead,
    edge-clamped. img: (B, H, W) or ring-pitch (B, hp, wp) int32 words (W
    and out_w in words, as the geometry's; a strip's H its rows). Returns
    (B, out_h, out_w) int32: a band form's out_h band rows, the tile of
    each its row in the grid from row0 (band_rows)."""
    g = geom
    H, W, OH, OW = g["in_h"], g["in_w"], g["out_h"], g["out_w"]
    x = img[:, :H, :W]

    def gather(ys, xs):
        ys = torch.as_tensor(ys, dtype=torch.int64, device=img.device)
        xs = torch.as_tensor(xs, dtype=torch.int64, device=img.device)
        return x[:, ys][:, :, xs]

    out = gather(g["tap_y"], g["tap_x"])
    if g["stage"] == "list":
        tw, th = g["tile"]
        row0, row1 = band_rows(g)
        staged = torch.as_tensor(g["staged"], device=img.device)
        staged = staged.repeat_interleave(th, 1).repeat_interleave(tw, 2)
        direct = gather(np.clip(g["quad_y"][1], 0, H - 1),
                        clip_words(g["quad_x"][1], W,
                                   g.get("texel_words", 1)))
        out = torch.where(staged[:, row0:row1, :OW], out, direct)
    return out


@dataclasses.dataclass(frozen=True)
class _FloorTables(_Tables):
    """The floor's device tables: the item list and the boxes' origins and
    box-relative taps."""

    tiles: object
    rel_x: object
    rel_y: object
    x0: object
    y0: object

    _ARRAYS = ("tiles", "rel_x", "rel_y", "x0", "y0")


def build_dma_floor(geom):
    """Build the DMA floor of one compute kernel from its published
    geometry (a kernel build's or Pipeline._build's fn.dma_geometry).

    Returns fn(img): img is the same contiguous frame, or one pre-padded
    to the ring pitch fn.pad_to, that the compute kernel takes (a (B,
    in_h, in_w) int32 plane; at 10 bits a (B, in_h, in_w, 4) uint16 one,
    moved as its two words per texel; a strip's input strip); the result
    is a new frame of the compute kernel's output shape (a strip's band
    rows), each output word the input word at its tap
    (dma_floor_reference). A strip geometry (band_rows from a row0 > 0)
    runs the band form: each tile loads what the strip kernel's tile
    loads, its whole window where it stages, and stores the band's rows
    only. A CUDA tensor launches csrc/dma_floor.cu,
    whose TMA loads take a row pitch of a multiple of fn.pitch_words
    words: any other CUDA frame (the unpadded 1683-word rows of the
    upscalers' 8-bit input and 3366-word rows of their 10-bit one among
    them) raises ValueError, and the ring pitch always runs. A CPU tensor
    runs the plain version.
    Published:
      launches, pad_to, reference   as every kernel build's;
      band_form     whether a CUDA call launches the band form
                    (dma_floor_band_kernel: a band from a row0 > 0) and
                    not the whole form (dma_floor_kernel);
      pitch_words   the row pitch the CUDA path takes a multiple of;
      tiles         the item list (floor_tiles), its first n_spans items
                    the span items;
      boxes         each class's box (floor_boxes);
      read_bytes    the bytes the floor's TMA forms load, overlaps
                    included (floor_loads; the JAX floor's read_bytes,
                    sol.py:101, counts its band windows the same way; the
                    one-box form loads the tapped words among them);
      write_bytes   B * out_h * out_w * 4 (out_w in words), as sol.py:102;
      hbm_bytes     the unique input plane plus the output: the bytes that
                    must cross device memory. Effective GB/s is taken over
                    these, not read_bytes: a word that overlapping boxes
                    load again is served by L2, not by HBM.
    Raises ValueError if the geometry is one the floor cannot run.
    """
    g = geom
    check_geometry(g)
    B, H, W = g["batch"], g["in_h"], g["in_w"]
    OH, OW = g["out_h"], g["out_w"]
    n = g.get("texel_words", 1)
    tiles, boxes = floor_tiles(g), floor_boxes(g)
    n_spans = int((tiles[:, 3] < 0).sum())
    tables = DeviceTables(_FloorTables(tiles, boxes.rel_x, boxes.rel_y,
                                       boxes.x0, boxes.y0))
    tw, th = g["tile"]
    row0 = band_rows(g)[0]
    (bw0, bh0), (bw1, bh1) = boxes.box

    def words(img):
        """The frame as (B, rows, pitch) int32 words (a view)."""
        return img if n == 1 else img.view(torch.int32).reshape(
            img.shape[0], img.shape[1], -1)

    def texels(out):
        """(B, OH, OW) output words as the compute kernel's frame."""
        return out if n == 1 else out.view(torch.uint16).reshape(
            B, OH, OW // n, 4)

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return texels(dma_floor_reference(words(img), g))

    def launch(img):
        x = words(img)
        if x.shape[2] % PITCH_WORDS or x.data_ptr() % (4 * PITCH_WORDS):
            raise ValueError(
                f"the DMA floor's TMA loads take a 16-byte-aligned frame "
                f"with a row pitch of a multiple of {PITCH_WORDS} words, not "
                f"{x.shape[2]}: pre-pad it to the ring pitch {fn.pad_to}")
        dev = img.device
        m = tables.on(dev)
        out = torch.empty((B, OH, OW), dtype=torch.int32, device=dev)
        err = _build.entry_point("dma_floor", "dma_floor_launch")(
            x.data_ptr(), out.data_ptr(), m.tiles.data_ptr(), len(tiles),
            n_spans, m.rel_x.data_ptr(), m.rel_y.data_ptr(), m.x0.data_ptr(),
            m.y0.data_ptr(), B, H, W, x.shape[1], x.shape[2], OH, OW, tw, th,
            bw0, bh0, bw1, bh1, row0,
            torch.cuda.current_stream(dev).cuda_stream)
        return texels(out), err

    fn = kernel_fn("DMA floor", B, (H, W // n), (g["hp"], g["wp"] // n),
                   reference, launch, color_bits=8 if n == 1 else 10)
    fn.band_form = row0 > 0
    fn.pitch_words = PITCH_WORDS
    fn.tiles = tiles
    fn.n_spans = n_spans
    fn.boxes = boxes
    fn.read_bytes = floor_loads(g, boxes) * 4
    fn.write_bytes = B * OH * OW * 4
    fn.hbm_bytes = B * H * W * 4 + fn.write_bytes
    return fn


# ---- the rate probes (B8) ---------------------------------------------------

F32 = np.float32
STEP_SCALE = float(F32(2.0 ** -20))   # the per-step perturbation (sol.py:166)
_C1, _C2 = float(F32(1.0009765625)), float(F32(-0.4990234375))
_MXU_SCALE = float(F32(1e-3))
SMEM_MAX = 232448           # shared memory one block may use (H100)
SM_SMEM = 233472            # shared memory of one SM, 1 KB per block reserved
SMS = 132                   # an H100 SXM's SMs
VMEM_THREADS = 544          # csrc/vmem_rate.cu kMaxThreads: groups x th_e
STEP_CHUNK = 512            # steps per vectorised block of the plain versions
# mxu_rate against its plain version: max |kernel - plain| over max |plain|.
# Both multiply the same bf16 operands exactly and accumulate in f32, in
# different orders; a last-bit difference that crosses a bf16 rounding
# boundary moves that element by one bf16 ulp (2^-8) in the next round.
MXU_TOLERANCE = 1e-2


def vpu_cycle(streams, x):
    """One op-mix cycle of the FP32 rate probe on 8 streams: the JAX
    package's sol.py::vpu_cycle (:106-130) in torch, op for op. The audit
    counts its ops with the same meter as every kernel's cores (30 per
    element)."""
    out = []
    for j, s in enumerate(streams):
        if j % 4 == 0:
            s = s * _C1 + x
            s = s * _C2 + x
        elif j % 4 == 1:
            s = torch.minimum(s * _C1, x) + s
        elif j % 4 == 2:
            s = torch.maximum(torch.abs(s - x) * _C2, x)
        else:
            s = (s - x) * _C1 + (x * _C2)
        out.append(s)
    return out


def _fold8(acc):
    """The JAX probes' 8-row fold over dim -2 (sol.py:156-162): the rows in
    blocks of 8 in order, then, when the row count is not a multiple of 8,
    the last 8 rows once more."""
    n = acc.shape[-2]
    red = acc[..., 0:8, :]
    for r in range(8, n - 7, 8):
        red = red + acc[..., r:r + 8, :]
    if n % 8:
        red = red + acc[..., n - 8:n, :]
    return red


def _sum_in_order(parts):
    """((p0 + p1) + p2) + ... over dim 0: the probes' second pass
    (csrc/rates.cuh)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _step_blocks(first, last):
    """[first, last) in blocks of STEP_CHUNK steps."""
    return [(a, min(a + STEP_CHUNK, last))
            for a in range(first, last, STEP_CHUNK)]


def _step_values(a, b, device):
    """f32(i) * 2^-20 for steps i in [a, b), as (b - a, 1, 1): exact."""
    return (torch.arange(a, b, device=device, dtype=torch.float32)
            * STEP_SCALE)[:, None, None]


def vpu_rate_reference(x, k, steps):
    """build_vpu_rate's function in plain torch, on x's device, in the
    kernel's order: per step, k vpu_cycle passes on the 8 streams of x +
    step * 2^-20, the streams summed in order, the 8-row fold; then the
    steps summed in order. x: (th_e, chunk) f32. Returns (8, chunk) f32."""
    reds = []
    for a, b in _step_blocks(0, steps):
        xi = x[None] + _step_values(a, b, x.device)
        streams = [xi * (0.125 * (j + 1)) for j in range(8)]
        for _ in range(k):
            streams = vpu_cycle(streams, xi)
        acc = _sum_in_order(streams)
        reds.extend(_fold8(acc).unbind(0))
    return _sum_in_order(reds)


def vmem_rate_groups(th_e):
    """csrc/vmem_rate.cu::groups_of: the step groups (shares) one CTA of the
    shared-memory probe runs over its staged column."""
    return VMEM_THREADS // th_e


def vmem_rate_shares(k, th_e=130, chunk=128, steps=256):
    """How many contiguous ranges the shared-memory probe splits its steps
    into: the groups of as many CTAs of one column as fit on the card's SMS
    SMs at once (by shared memory and threads), at least 1 and at most
    `steps`."""
    groups = vmem_rate_groups(th_e)
    smem = _vmem_smem_bytes(k, th_e)
    warps = -(-groups * th_e // 32)
    per_sm = min(SM_SMEM // (smem + 1024), 2048 // (32 * warps), 32)
    return max(1, min(steps, SMS * per_sm // chunk * groups))


def _vmem_smem_bytes(k, th_e):
    """csrc/vmem_rate.cu::vmem_rate_smem_bytes."""
    return (-(-k // 4) * 4 * th_e + 2 * vmem_rate_groups(th_e) * th_e) * 4


def vmem_rate_reference(x, steps, shares=1):
    """build_vmem_rate's function in plain torch, on x's device, in the
    kernel's order: for each of `shares` contiguous ranges of the steps,
    each step's Horner fold of the k planes (accs[j % 8] = accs[j % 8] * s +
    x[j], accs from 1..8, s = 1 - step * 2^-20), the sum of its 8
    accumulators and the 8-row fold, the folds added in step order; then the
    shares added in order. With one share that is the JAX probe's order
    (sol.py:236-255). x: (k, th_e, chunk) f32. Returns (8, chunk) f32."""
    k = x.shape[0]
    parts = []
    for share in range(shares):
        reds = []
        for a, b in _step_blocks(share * steps // shares,
                                 (share + 1) * steps // shares):
            s = 1.0 - _step_values(a, b, x.device)
            accs = [torch.full((b - a,) + x.shape[1:], float(u + 1),
                               dtype=torch.float32, device=x.device)
                    for u in range(8)]
            for j in range(k):
                accs[j % 8] = accs[j % 8] * s + x[j]
            reds.extend(_fold8(_sum_in_order(accs)).unbind(0))
        parts.append(_sum_in_order(reds))
    return _sum_in_order(parts)


def wt_swizzle_offset(n, k, tile=128):
    """csrc/mxu_rate.cu::wt_offset: the byte offset of W^T element (n, k)
    (W[k][n] in bf16) in the tensor-core probe's shared tile, the K-major
    layout with the 128-byte swizzle that wgmma reads B from: two atoms of
    tile x 64 bf16 along K, each rows of 128 bytes in blocks of 8 rows (1
    KB), the 16-byte chunk k / 8 of row n stored at chunk (k / 8) ^ (n %
    8). Elementwise over numpy integer arrays."""
    n, k = np.asarray(n), np.asarray(k)
    return ((k // 64) * (tile * 128) + (n // 8) * 1024 + (n % 8) * 128
            + (((k % 64) // 8) ^ (n % 8)) * 16 + (k % 8) * 2)


def mxu_rate_reference(x, w, k, steps):
    """build_mxu_rate's function in plain torch, on x's device: per step,
    each stream (x + step * 2^-20) * 0.125 * (j + 1) through k rounds of
    s <- (bf16(s) @ bf16(w)) * 1e-3 as a float32 product of the rounded
    operands (TF32 off), the streams summed in order; the two 8-row halves
    of each 16-row slice added, then the slices in order; then the steps in
    order. x, w: (128, 128) f32. Returns (8, 128) f32; equal to the kernel
    within MXU_TOLERANCE (the mma's summation order is its own)."""
    tile = x.shape[0]
    wb = w.to(torch.bfloat16).to(torch.float32)
    reds = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for a, b in _step_blocks(0, steps):
            xi = x[None] + _step_values(a, b, x.device)
            streams = []
            for j in range(8):
                s = xi * (0.125 * (j + 1))
                for _ in range(k):
                    s = torch.matmul(s.to(torch.bfloat16).to(torch.float32),
                                     wb) * _MXU_SCALE
                streams.append(s)
            acc = _sum_in_order(streams).view(b - a, tile // 16, 2, 8, tile)
            halves = acc[:, :, 0] + acc[:, :, 1]
            reds.extend(_sum_in_order(halves.transpose(0, 1)).unbind(0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return _sum_in_order(reds)


def _probe_fn(name, shapes, reference, launch):
    """The function a probe build returns: fn(*tensors) takes contiguous f32
    tensors of `shapes` on one device. CPU tensors run reference(*tensors);
    CUDA tensors run launch(*tensors), which returns (out, cudaError), and
    raise if the error is not 0. fn.launches counts CUDA launches."""
    def fn(*xs):
        if len(xs) != len(shapes):
            raise TypeError(f"{name} takes {len(shapes)} tensors")
        for t, shape in zip(xs, shapes):
            if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                    or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"{name} takes contiguous float32 tensors "
                                 f"of shapes {shapes}")
        dev = xs[0].device
        if any(t.device != dev for t in xs):
            raise ValueError(f"{name}: tensors on different devices")
        if dev.type == "cpu":
            return reference(*xs)
        if dev.type != "cuda":
            raise ValueError(f"{name} has no path for device {dev}")
        with torch.cuda.device(dev):
            out, err = launch(*xs)
        if err != 0:
            raise RuntimeError(f"{name}_launch failed: cudaError {err}")
        fn.launches += 1
        return out

    fn.launches = 0
    fn.reference = reference
    return fn


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def build_vpu_rate(k, th_e=130, chunk=128, steps=256):
    """The FP32 rate probe (B8a): fn(x) with x a (th_e, chunk) f32 tensor
    returns the (8, chunk) f32 result of `steps` steps of k vpu_cycle
    passes (vpu_rate_reference). A CUDA tensor launches csrc/vpu_rate.cu, a
    CPU tensor runs the plain version. Published as the JAX builder's
    (sol.py:196-198): elems (th_e * chunk), steps, k; plus launches and
    reference."""
    k, th_e, chunk, steps = int(k), int(th_e), int(chunk), int(steps)
    if th_e < 8 or chunk % 32 or k < 0 or not 1 <= steps <= 65535:
        raise ValueError("the FP32 probe takes th_e >= 8, chunk a multiple "
                         "of 32, k >= 0 and 1..65535 steps")

    def reference(x):
        return vpu_rate_reference(x, k, steps)

    def launch(x):
        parts = torch.empty((steps, 8, chunk), dtype=torch.float32,
                            device=x.device)
        out = torch.empty((8, chunk), dtype=torch.float32, device=x.device)
        err = _build.entry_point("vpu_rate", "vpu_rate_launch")(
            x.data_ptr(), parts.data_ptr(), out.data_ptr(), th_e, chunk, k,
            steps, _stream(x.device))
        return out, err

    fn = _probe_fn("vpu_rate", [(th_e, chunk)], reference, launch)
    fn.elems = th_e * chunk
    fn.steps = steps
    fn.k = k
    return fn


def build_vmem_rate(k, th_e=130, chunk=128, steps=256, dtype=torch.float32,
                    shares=None):
    """The shared-memory rate probe (B8b): fn(x) with x a (k, th_e, chunk)
    f32 tensor returns the (8, chunk) f32 result of `steps` Horner folds of
    its k planes (vmem_rate_reference). A CUDA tensor launches
    csrc/vmem_rate.cu, a CPU tensor runs the plain version. `shares` splits
    the steps into contiguous ranges run by CTAs of their own (default
    vmem_rate_shares(k, ...); 1 keeps the JAX probe's summation order).
    Published as the JAX builder's (sol.py:270-272): bytes_per_step (the
    plane bytes one step reads), steps, k; plus shares, smem_bytes (per
    CTA), launches and reference. Only float32 planes are ported, and at
    most VMEM_THREADS rows."""
    k, th_e, chunk, steps = int(k), int(th_e), int(chunk), int(steps)
    if dtype != torch.float32:
        raise NotImplementedError("the shared-memory probe is ported for "
                                  "float32 planes only")
    shares = int(shares or vmem_rate_shares(k, th_e, chunk, steps))
    if not (8 <= th_e <= VMEM_THREADS and 1 <= chunk <= 65535 and k >= 1
            and 1 <= shares <= min(steps, 65535)):
        raise ValueError(f"the shared-memory probe takes 8 <= th_e <= "
                         f"{VMEM_THREADS}, k >= 1 and 1 <= shares <= steps")
    smem = _vmem_smem_bytes(k, th_e)
    if smem > SMEM_MAX:
        raise ValueError(f"k={k} planes of {th_e} rows need {smem} bytes of "
                         f"shared memory per column, above {SMEM_MAX}")

    def reference(x):
        return vmem_rate_reference(x, steps, shares)

    def launch(x):
        parts = torch.empty((shares, 8, chunk), dtype=torch.float32,
                            device=x.device)
        out = torch.empty((8, chunk), dtype=torch.float32, device=x.device)
        err = _build.entry_point("vmem_rate", "vmem_rate_launch")(
            x.data_ptr(), parts.data_ptr(), out.data_ptr(), th_e, chunk, k,
            steps, shares, _stream(x.device))
        return out, err

    fn = _probe_fn("vmem_rate", [(k, th_e, chunk)], reference, launch)
    fn.bytes_per_step = k * th_e * chunk * 4
    fn.steps = steps
    fn.k = k
    fn.shares = shares
    fn.smem_bytes = smem
    return fn


def build_mxu_rate(k, tile=128, steps=64):
    """The tensor-core rate probe (B8c): fn(x, w) with x, w (tile, tile) f32
    tensors returns the (8, tile) f32 result of `steps` steps of k chained
    bf16 rounds over 8 streams (mxu_rate_reference). A CUDA tensor launches
    csrc/mxu_rate.cu (wgmma m64n128k16), a CPU tensor runs the plain
    version. Published as the JAX builder's (sol.py:335-337): steps, k,
    tile; plus macs (steps * k * 8 * tile^3), launches and reference. Only
    tile 128 is ported."""
    k, tile, steps = int(k), int(tile), int(steps)
    if tile != 128 or k < 1 or steps < 1:
        raise ValueError("the tensor-core probe takes tile 128, k >= 1 and "
                         "steps >= 1")

    def reference(x, w):
        return mxu_rate_reference(x, w, k, steps)

    def launch(x, w):
        parts = torch.empty((steps, 8, tile), dtype=torch.float32,
                            device=x.device)
        out = torch.empty((8, tile), dtype=torch.float32, device=x.device)
        err = _build.entry_point("mxu_rate", "mxu_rate_launch")(
            x.data_ptr(), w.data_ptr(), parts.data_ptr(), out.data_ptr(),
            tile, k, steps, _stream(x.device))
        return out, err

    fn = _probe_fn("mxu_rate", [(tile, tile), (tile, tile)], reference, launch)
    fn.steps = steps
    fn.k = k
    fn.tile = tile
    fn.macs = steps * k * 8 * tile ** 3
    return fn
