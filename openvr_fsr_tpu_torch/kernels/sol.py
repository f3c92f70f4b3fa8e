"""The memory speed-of-light yardstick (B7): the DMA floor of one compute
kernel, as a CUDA kernel (csrc/dma_floor.cu), and its plain version.

The port of the JAX package's kernels/sol.py::build_dma_floor.
`build_dma_floor` consumes the DMA geometry a kernel build publishes
(`fn.dma_geometry`, kernels/_maps.py::dma_geometry) and builds a kernel
with that kernel's grid, threads per CTA and launch bounds, which stages
the same windows into shared memory by the same CTAs, makes the same
direct loads where a CTA does not stage, stores every output word once,
and computes nothing. Its time is the time this card needs to move that
kernel's exact device-memory traffic, so vs_sol = floor / kernel <= 1 when
both are timed in one process over the same frames (bench.py,
tools/bench_paths.py).

What it describes is the CUDA kernel's own traffic, not the TPU kernel's:
the TPU floor DMAs one row band per grid step (its read_bytes count band
windows); this one loads tile windows, overlaps included.

The TPU's rate probes (B8: build_vpu_rate, build_vmem_rate,
build_mxu_rate) are not ported yet; they raise NotImplementedError naming
ROADMAP.md Queue B item B8.
"""

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build
from ._common import DeviceTables, kernel_fn
from ._maps import THREADS, _Tables

__all__ = ["build_dma_floor", "dma_floor_reference", "check_geometry",
           "build_vpu_rate", "build_vmem_rate", "build_mxu_rate"]


def staged_ctas(geom):
    """(B, tiles_y, tiles_x) bool: the CTAs that stage their window (every
    CTA, or those whose tile passes the foveation circle test,
    csrc/rgba8.cuh::inside_circle)."""
    g = geom
    (tw, th), B = g["tile"], g["batch"]
    gx = np.arange(-(-g["out_w"] // tw)) * tw + tw // 2
    gy = np.arange(-(-g["out_h"] // th)) * th + th // 2
    if g["stage"] == "all":
        return np.ones((B, len(gy), len(gx)), bool)
    c = g["centres"][:, :, None, None]
    d1 = (c[:, 0] - gx) ** 2 + (c[:, 1] - gy[:, None]) ** 2
    d2 = (c[:, 2] - gx) ** 2 + (c[:, 3] - gy[:, None]) ** 2
    return (d1 <= c[:, 4]) | (d2 <= c[:, 4])


def floor_loads(geom):
    """Words one launch loads from the frame, overlaps included: each
    staging CTA's window (its in-image words where out-of-image words are
    staged as 0 without a load), plus one word per output of a CTA that
    does not stage, or four per output where the kernel loads four
    bilinear taps."""
    g = geom
    (tw, th), (ww, wh) = g["tile"], g["window"]
    H, W, OH, OW = g["in_h"], g["in_w"], g["out_h"], g["out_w"]
    outs = (np.minimum(th, OH - np.arange(-(-OH // th)) * th)[:, None]
            * np.minimum(tw, OW - np.arange(-(-OW // tw)) * tw)[None, :])
    if g["oob"] == "clamp":
        win = np.full(outs.shape, ww * wh)
    else:
        x0, y0 = g["tile_x0"].astype(np.int64), g["tile_y0"].astype(np.int64)
        nx = np.clip(x0 + ww, 0, W) - np.clip(x0, 0, W)
        ny = np.clip(y0 + wh, 0, H) - np.clip(y0, 0, H)
        win = ny[:, None] * nx[None, :]
    quad = g["quad_x"] is not None
    staged = staged_ctas(g)
    return int(np.where(staged, win + (4 * outs if quad else 0),
                        (4 if quad else 1) * outs).sum())


def check_geometry(geom):
    """Raise ValueError unless the floor can run `geom`: 256 threads per
    CTA, and every output's tap inside the window of its tile."""
    g = geom
    if g["threads"] != THREADS:
        raise ValueError(f"the DMA floor runs {THREADS} threads per CTA, "
                         f"the geometry {g['threads']}")
    for axis, tile, win, origins, taps in (
            ("column", g["tile"][0], g["window"][0], g["tile_x0"],
             g["tap_x"]),
            ("row", g["tile"][1], g["window"][1], g["tile_y0"],
             g["tap_y"])):
        rel = taps - np.repeat(origins, tile)[:len(taps)]
        if rel.min() < 0 or rel.max() >= win:
            raise ValueError(f"an output {axis}'s tap lies outside the "
                             f"{win}-wide window of its tile")


def dma_floor_reference(img, geom):
    """The floor's output in plain torch, on img's device: each output word
    is the input word at its tap (tap_y, tap_x); where a CTA does not
    stage and the kernel loads four bilinear taps instead, the first of
    those, edge-clamped. img: (B, H, W) or ring-pitch (B, hp, wp) int32.
    Returns (B, out_h, out_w) int32."""
    g = geom
    H, W, OH, OW = g["in_h"], g["in_w"], g["out_h"], g["out_w"]
    x = img[:, :H, :W]

    def gather(ys, xs):
        ys = torch.as_tensor(ys, dtype=torch.int64, device=img.device)
        xs = torch.as_tensor(xs, dtype=torch.int64, device=img.device)
        return x[:, ys][:, :, xs]

    out = gather(g["tap_y"], g["tap_x"])
    if g["quad_x"] is not None:
        tw, th = g["tile"]
        staged = torch.as_tensor(staged_ctas(g), device=img.device)
        staged = staged.repeat_interleave(th, 1).repeat_interleave(tw, 2)
        direct = gather(np.clip(g["quad_y"][1], 0, H - 1),
                        np.clip(g["quad_x"][1], 0, W - 1))
        out = torch.where(staged[:, :OH, :OW], out, direct)
    return out


@dataclasses.dataclass(frozen=True)
class _FloorTables(_Tables):
    """The floor's device tables; an empty array stands for a null
    pointer (identity taps, no four-tap loads)."""

    tile_x0: object
    tile_y0: object
    tap_x: object
    tap_y: object
    quad_x: object
    quad_y: object
    centres: object

    _ARRAYS = ("tile_x0", "tile_y0", "tap_x", "tap_y", "quad_x", "quad_y",
               "centres")


@functools.cache
def _launch_fn():
    """The ctypes entry point, bound (and built) at the first launch."""
    f = _build.load_library("dma_floor").dma_floor_launch
    f.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 14
                  + [ctypes.c_uint, ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def _ptr(t):
    return t.data_ptr() if t.numel() else None


def build_dma_floor(geom):
    """Build the DMA floor of one compute kernel from its published
    geometry (a kernel build's or Pipeline._build's fn.dma_geometry).

    Returns fn(img): img is the same contiguous (B, in_h, in_w) int32
    plane, or one pre-padded to the ring pitch fn.pad_to, that the compute
    kernel takes; the result is a new (B, out_h, out_w) int32 tensor, the
    input word at each output's tap (dma_floor_reference). A CUDA tensor
    launches csrc/dma_floor.cu, a CPU tensor runs the plain version.
    Published:
      launches, pad_to, reference   as every kernel build's;
      read_bytes    the bytes the floor loads, overlaps included
                    (floor_loads; the JAX floor's read_bytes, sol.py:101,
                    counts its band windows the same way);
      write_bytes   B * out_h * out_w * 4, as sol.py:102;
      hbm_bytes     the unique input plane plus the output: the bytes that
                    must cross device memory. Effective GB/s is taken over
                    these, not read_bytes: a word that overlapping windows
                    load again is served by L2, not by HBM.
    Raises ValueError if the geometry is one the floor cannot run.
    """
    g = geom
    check_geometry(g)
    B, H, W = g["batch"], g["in_h"], g["in_w"]
    OH, OW = g["out_h"], g["out_w"]
    none = np.zeros(0, np.int32)
    identity = (np.array_equal(g["tap_x"], np.arange(OW))
                and np.array_equal(g["tap_y"], np.arange(OH)))
    taps = (none, none) if identity else (g["tap_x"], g["tap_y"])
    quads = (none, none) if g["quad_x"] is None else (g["quad_x"],
                                                      g["quad_y"])
    tables = DeviceTables(_FloorTables(
        g["tile_x0"], g["tile_y0"], *taps, *quads, g["centres"]))
    (tw, th), (ww, wh) = g["tile"], g["window"]

    def reference(img):
        """The plain torch version on img's device (any device)."""
        return dma_floor_reference(img, g)

    def launch(img):
        dev = img.device
        m = tables.on(dev)
        out = torch.empty((B, OH, OW), dtype=torch.int32, device=dev)
        err = _launch_fn()(
            img.data_ptr(), out.data_ptr(), m.tile_x0.data_ptr(),
            m.tile_y0.data_ptr(), _ptr(m.tap_x), _ptr(m.tap_y),
            _ptr(m.quad_x), _ptr(m.quad_y), m.centres.data_ptr(), B, H, W,
            img.shape[1], img.shape[2], OH, OW, tw, th, ww, wh,
            g["threads"], int(g["stage"] == "all"), int(g["oob"] == "clamp"),
            0, torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    fn = kernel_fn("DMA floor", B, (H, W), (g["hp"], g["wp"]), reference,
                   launch)
    fn.read_bytes = floor_loads(g) * 4
    fn.write_bytes = B * OH * OW * 4
    fn.hbm_bytes = B * H * W * 4 + fn.write_bytes
    return fn


def _unported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (a TPU rate probe of openvr_fsr_tpu/kernels/sol.py) is "
            "not ported yet: ROADMAP.md Queue B item B8")
    fn.__name__ = name
    return fn


build_vpu_rate = _unported("build_vpu_rate")
build_vmem_rate = _unported("build_vmem_rate")
build_mxu_rate = _unported("build_mxu_rate")
