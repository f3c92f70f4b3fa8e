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

The rate probes (B8) follow: the FP32 rate (build_vpu_rate,
csrc/vpu_rate.cu), the shared-memory rate (build_vmem_rate,
csrc/vmem_rate.cu) and the tensor-core rate (build_mxu_rate,
csrc/mxu_rate.cu), the ports of the JAX package's sol.py:106-338, each with
its plain version. tools/vpu_audit.py times two k of each and takes the
slope. The TPU probes accumulate into one output block over a sequential
grid; here CTAs write partials that a second pass adds in a fixed order,
which the plain versions repeat.
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
           "vpu_cycle", "build_vpu_rate", "vpu_rate_reference",
           "build_vmem_rate", "vmem_rate_reference", "build_mxu_rate",
           "mxu_rate_reference", "MXU_TOLERANCE"]


def floor_loads(geom):
    """Words one launch loads from the frame, overlaps included: each
    staging CTA's window (its in-image words where out-of-image words are
    staged as 0 without a load), plus, per output of a CTA that does not
    stage, one word (stage "copy") or four bilinear taps ("list"), and four
    per output of a staging CTA where stage_quads."""
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
    listed = g["stage"] == "list"
    return int(np.where(g["staged"],
                        win + (4 * outs if g["stage_quads"] else 0),
                        (4 if listed else 1) * outs).sum())


def check_geometry(geom):
    """Raise ValueError unless the floor can run `geom`: 256 threads per
    CTA; stage "copy" with no four-tap floors, no stage_quads, a staged
    table of the grid's shape and each output's tap its own texel, or
    "list" with the floors and a staged table; every output's tap inside
    the window of its tile."""
    g = geom
    if g["threads"] != THREADS:
        raise ValueError(f"the DMA floor runs {THREADS} threads per CTA, "
                         f"the geometry {g['threads']}")
    grid = (g["batch"], len(g["tile_y0"]), len(g["tile_x0"]))
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
    for axis, tile, win, origins, taps in (
            ("column", g["tile"][0], g["window"][0], g["tile_x0"],
             g["tap_x"]),
            ("row", g["tile"][1], g["window"][1], g["tile_y0"],
             g["tap_y"])):
        rel = taps - np.repeat(origins, tile)[:len(taps)]
        if rel.min() < 0 or rel.max() >= win:
            raise ValueError(f"an output {axis}'s tap lies outside the "
                             f"{win}-wide window of its tile")


def _identity_taps(g):
    return (np.array_equal(g["tap_x"], np.arange(g["out_w"]))
            and np.array_equal(g["tap_y"], np.arange(g["out_h"])))


def dma_floor_reference(img, geom):
    """The floor's output in plain torch, on img's device: each output word
    is the input word at its tap (tap_y, tap_x); in a CTA of stage "list"
    that does not stage, the first of the four bilinear taps it loads
    instead, edge-clamped. img: (B, H, W) or ring-pitch (B, hp, wp) int32.
    Returns (B, out_h, out_w) int32."""
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
        staged = torch.as_tensor(g["staged"], device=img.device)
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
    staged: object

    _ARRAYS = ("tile_x0", "tile_y0", "tap_x", "tap_y", "quad_x", "quad_y",
               "staged")


@functools.cache
def _launch_fn():
    """The ctypes entry point, bound (and built) at the first launch."""
    f = _build.load_library("dma_floor").dma_floor_launch
    f.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 15
                  + [ctypes.c_uint, ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def _ptr(t):
    return t.data_ptr() if t.numel() else None


# csrc/dma_floor.cu Stage: what the CTAs that do not stage load
_STAGES = {"list": 0, "copy": 1}


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
    taps = (none, none) if _identity_taps(g) else (g["tap_x"], g["tap_y"])
    quads = (none, none) if g["quad_x"] is None else (g["quad_x"],
                                                      g["quad_y"])
    tables = DeviceTables(_FloorTables(
        g["tile_x0"], g["tile_y0"], *taps, *quads,
        np.ascontiguousarray(g["staged"], np.uint8)))
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
            _ptr(m.quad_x), _ptr(m.quad_y), m.staged.data_ptr(), B, H, W,
            img.shape[1], img.shape[2], OH, OW, tw, th, ww, wh, g["threads"],
            _STAGES[g["stage"]],
            int(g["stage_quads"]), int(g["oob"] == "clamp"), 0,
            torch.cuda.current_stream(dev).cuda_stream)
        return out, err

    fn = kernel_fn("DMA floor", B, (H, W), (g["hp"], g["wp"]), reference,
                   launch)
    fn.read_bytes = floor_loads(g) * 4
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


@functools.cache
def _probe_launch(name, n_ptr, n_int):
    f = getattr(_build.load_library(name), f"{name}_launch")
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


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
        err = _probe_launch("vpu_rate", 3, 4)(
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
        err = _probe_launch("vmem_rate", 3, 5)(
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
    csrc/mxu_rate.cu (mma.sync m16n8k16), a CPU tensor runs the plain
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
        err = _probe_launch("mxu_rate", 4, 3)(
            x.data_ptr(), w.data_ptr(), parts.data_ptr(), out.data_ptr(),
            tile, k, steps, _stream(x.device))
        return out, err

    fn = _probe_fn("mxu_rate", [(tile, tile), (tile, tile)], reference, launch)
    fn.steps = steps
    fn.k = k
    fn.tile = tile
    fn.macs = steps * k * 8 * tile ** 3
    return fn
