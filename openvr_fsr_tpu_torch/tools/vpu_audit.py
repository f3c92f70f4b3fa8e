"""Compute and shared-memory floors of the port's kernels on one NVIDIA GPU:
the port of the repository's tools/vpu_audit.py.

    python3 -m openvr_fsr_tpu_torch.tools.vpu_audit [--nis] [--quick]
        [--out FILE]

bench.py bounds each kernel's device-memory traffic (the DMA floor); this
bounds its math. It
  (a) counts the f32 ops per output pixel of each kernel's two paths
      (inside the foveation circle and the fallback outside it) by running
      the port's plain cores (ops/) at working shapes under an op meter
      (count_ops), and the ops of the FP32 probe's vpu_cycle with the same
      meter, so the meter's bias cancels;
  (b) measures the card's FP32, shared-memory and tensor-core rates with
      the rate probes (kernels/sol.py: csrc/vpu_rate.cu, vmem_rate.cu,
      mxu_rate.cu) as the median of interleaved lo/hi paired slopes over
      two k, timed with CUDA events. A NaN or non-positive pair, or a
      spread (largest / smallest pair slope) above 1.5, fails the run;
  (c) times each of the six kernels at radius 2.0 and 0.5 (and 0.0) over
      the bench's three rotating ring frames and gives each its floors:
        compute  the ops its inside and fallback pixels need / FP32 rate;
        smem     the shared-memory bytes its math reads per output (from
                 the kernel's source, SMEM_WORDS) / shared-memory rate;
        tensor   0: no kernel of the port issues an mma;
        memory   its unique bytes (input plane + output) / 3.35 TB/s;
      bound_ms is the largest of the four, never their sum, and share =
      bound / ms.
The ops counted are the algorithm's per output pixel: a kernel's
recomputed halo (B1 computes stage 1 on 34x34 pixels per 32x32 tile) is
its loss, not its bound, and the texel decode and pack are not counted, so
every floor is a lower bound.

--nis also prints NVScaler's op counts stage by stage (the port has no
ablation knobs: the measured side is the whole kernel) and audits only it.
--quick uses shorter probes. --out writes the result as JSON. Every number
is finite or null (json.dumps(allow_nan=False)). With no CUDA GPU the line
has value null and an error, and the exit code is 1.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["count_ops", "count_macs", "issue_slots", "paired_slope", "rate_from_slopes",
           "path_ops", "kernel_floors", "roofline_bound", "probe_bounds",
           "fp32_instructions_per_s", "smem_bytes_per_s", "tensor_macs_per_s",
           "main", "ELEMWISE_SKIP", "SMEM_WORDS", "MAX_SPREAD"]

# layout, index, creation and conversion ops: the meter skips them, as the
# JAX tool's ELEMWISE_SKIP skips broadcasts, converts and layout ops
ELEMWISE_SKIP = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "squeeze", "unsqueeze", "permute", "transpose", "t",
    "slice", "select", "unbind", "split", "split_with_sizes", "narrow",
    "as_strided", "alias", "detach", "clone", "contiguous", "copy", "copy_",
    "_to_copy", "to", "cat", "stack", "index_select", "index", "gather",
    "constant_pad_nd", "pad", "zeros_like", "ones_like", "full_like",
    "empty_like", "full", "zeros", "ones", "empty", "empty_strided",
    "new_empty", "new_full", "new_zeros", "arange", "fill", "fill_", "zero",
    "zero_", "lift_fresh", "lift_fresh_copy", "scalar_tensor",
    "_local_scalar_dense", "repeat", "repeat_interleave", "flatten",
    "movedim", "unfold", "_unsafe_index"})
_MATMUL = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv"})
MAX_SPREAD = 1.5            # largest / smallest pair slope a rate may show
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA's data sheet)
# FP32 work is priced at the card's issue bound (fp32_instructions_per_s):
# the data sheet's 67 TFLOP/s counts an FFMA as two operations, while the
# port builds with --fmad=false (one rounded FMUL or FADD per issue slot and
# lane), so it is twice what the kernels can issue
LANES_PER_SM = 128          # FP32 lanes, and shared-memory bytes per clock
# dense bf16 MACs per SM and clock: the data sheet's 989.4 TFLOP/s is 132
# SMs x 4,096 FLOP x 1,830 MHz, below the max SM clock the card runs at, so
# the tensor bound, like the FP32 and shared-memory ones, takes the sampled
# max SM clock (tensor_macs_per_s)
TENSOR_MACS_PER_SM_CLOCK = 2048

# The shared-memory words each kernel's math reads per output pixel, from
# its source (staging stores and recomputed halos not counted), inside the
# circle and on the fallback:
SMEM_WORDS = {
    # fsr_fused.cu:181 the group class, :183 + :192 4 map words and :187
    # 12 decoded taps of 16 bytes (48 words) for EASU, :259 + :264-267 15
    # f32 for RCAS; fallback: the outside pass (bilinear_pass.cuh) reads no
    # shared memory
    "fsr_fused": (68, 0),
    # rcas_sharpen.cu's RGBA8 kernel on the levels, per output of a run of
    # 4 in one column: :333-334 + :343-345 the 5 cross taps, one packed
    # word each, at the first (5), at each later one only the new left,
    # right and bottom taps (:343-345, 3; the top and centre slide down
    # from the last row): 3.5; and :234-235 per channel one float2 of each
    # level table (12): 15.5; fallback: the copy pass reads device memory
    # only (so does a run of an outside group in an inside tile, :319: not
    # counted, so the floor stays a lower bound). 17 if every output
    # reloaded (`--ablate noslide`)
    "rcas_sharpen": (15.5, 0),
    # nis_scaler.cu, per output of a run of 6 in one column: :321 + :331
    # the two diagonal phases' COEF_SCALE / COEF_USM rows (24 words); per
    # run :244-245 the fx rows (12); on a reload :274 36 lumas (:158) and
    # :278 two rows of 2 float4 edge weights (16), on a step of one row
    # :266 6 lumas and :270 one edge row (8); the fy rows come from constant
    # memory (:289). Averaged over the main path's runs (416 reloads, 1,661
    # one-row steps per 2,492 rows): 44.0 (78 if every output reloaded, the
    # ablation `tools/ab.py --ablate noslide`). Fallback: DirectCopy reads
    # device memory only
    "nis_scaler": (44, 0),
    # nis_sharpen.cu, per output of a run of 4 in one column: :118 the 5x5
    # lumas at the first, one new row of 5 (:116) at each later one (10),
    # and :145 the staged centre texel (1); fallback: the copy pass
    # (copy_pass.cuh) reads device memory only. 25 + 1 if every output
    # reloaded (`tools/ab.py --ablate noslide`)
    "nis_sharpen": (11, 0),
    # cas_upscale.cu:129 the 12 taps of the 4x4 window x 3 f32 planes;
    # fallback: the outside pass reads device memory only (an output of an
    # outside group in an inside tile reads 12, :148; not counted, so the
    # floor stays a lower bound)
    "cas_upscale": (36, 0),
    # cas_sharpen.cu, per output of a run of 4 in one column: :125 the 3x3
    # taps x 3 f32 planes at the first (27), one new row (:121) of 9 at
    # each later one: 13.5; fallback: the copy pass reads device memory
    # only (so does a run of an outside group in an inside tile: not
    # counted, so the floor stays a lower bound). 27 if every output
    # reloaded (`--ablate noslide`)
    "cas_sharpen": (13.5, 0),
}
# the six kernels' bench paths (tools/bench_paths.py::PATHS)
KERNEL_PATHS = {"fsr_fused": "fsr_fused", "rcas_sharpen": "rcas_only",
                "nis_scaler": "nvscaler", "nis_sharpen": "nvsharpen",
                "cas_upscale": "cas_upscale", "cas_sharpen": "cas_sharpen"}
NIS_SHARPNESS = 0.7         # the JAX tool's NVScaler config (:481-487)
RADII = (2.0, 0.5, 0.0)
# (k lo, k hi, steps) of each probe; --quick in the second entry. A hi
# call takes about 1-10 ms on an H100 at the full settings.
PROBES = {"vpu": ((16, 144, 1024), (8, 48, 256)),
          "vmem": ((16, 112, 4096), (8, 48, 1024)),
          "mxu": ((8, 64, 264), (4, 24, 132))}


class _Meter(TorchDispatchMode):
    """Credits each elementwise op with its output's element count, and each
    matrix product with its multiply-adds."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.half_ops = 0     # of them, the ops on bf16 values
        self.macs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _MATMUL:
            a, b = args[1:3] if name in ("addmm", "baddbmm") else args[:2]
            if b.ndim == 1:          # dot, mv
                self.macs += a.numel()
            else:
                batch = int(np.prod(a.shape[:-2])) if a.ndim > 2 else 1
                self.macs += batch * a.shape[-2] * a.shape[-1] * b.shape[-1]
        elif name not in ELEMWISE_SKIP:
            outs = out if isinstance(out, (tuple, list)) else [out]
            n = max((o.numel() for o in outs if isinstance(o, torch.Tensor)),
                    default=0)
            self.ops += n
            first = next((a for a in args if isinstance(a, torch.Tensor)),
                         None)
            if first is not None and first.dtype == torch.bfloat16:
                self.half_ops += n
        return out


def count_ops(fn, *args):
    """Elementwise ops of fn(*args), each op credited with the element
    count of its output (layout, index, creation and conversion ops
    skipped: ELEMWISE_SKIP)."""
    with _Meter() as m:
        fn(*args)
    return m.ops


def issue_slots(fn, *args):
    """count_ops of fn(*args) in FP32 issue slots: an op on bf16 values
    (the half cores') counts one half, since a packed bf16x2 instruction
    (HADD2, HMUL2, HFMA2, HMNMX2 .BF16) does two per lane and clock; the
    NVIDIA H100 white paper gives the card's non-tensor bf16 rate as twice
    its f32 one. A lower bound of what the half kernels, which round each
    bf16 op from an f32 one, can issue."""
    with _Meter() as m:
        fn(*args)
    return m.ops - m.half_ops / 2


def count_macs(fn, *args):
    """Multiply-adds of the matrix products in fn(*args): B*M*K*N each."""
    with _Meter() as m:
        fn(*args)
    return m.macs


def rate_from_slopes(slopes, max_spread=MAX_SPREAD):
    """The median of per-pair slopes. Raises ValueError if any slope is
    NaN, infinite or not positive (none is dropped), or if the largest over
    the smallest exceeds max_spread."""
    bad = [s for s in slopes if not (math.isfinite(s) and s > 0)]
    if bad or not slopes:
        raise ValueError(f"pair slopes {slopes}: {len(bad)} not finite and "
                         "positive")
    spread = max(slopes) / min(slopes)
    if spread > max_spread:
        raise ValueError(f"pair slopes {slopes}: spread {spread:.3f} above "
                         f"{max_spread}")
    return statistics.median(slopes)


def paired_slope(t_lo, t_hi, d_work, pairs=4, max_spread=MAX_SPREAD):
    """Median slope rate from interleaved lo/hi timing pairs (the JAX
    tool's paired_slope, :148-164, with the round-5 faults closed).

    t_lo / t_hi: callables returning one timing in ms. Returns (rate per
    second, [per-pair rates]). A pair whose hi is not slower than its lo,
    a non-finite slope or a spread above max_spread raises ValueError."""
    slopes = []
    for _ in range(pairs):
        a = t_lo()
        b = t_hi()
        dt = (b - a) * 1e-3
        if not (math.isfinite(dt) and dt > 0):
            raise ValueError(f"pair {len(slopes)}: lo {a} ms, hi {b} ms: the "
                             "hi call was not slower")
        slopes.append(d_work / dt)
    return rate_from_slopes(slopes, max_spread), slopes


# ---- (a) op counts per output pixel ------------------------------------------

def _planes(h, w):
    def z(*lead):
        return torch.zeros(*lead, h, w)
    return z


def _nis_config(h, w, oh, ow, sharpness, upscale):
    from ..core import constants as C
    if upscale:
        return C.nvscaler_update_config(sharpness, w, h, w, h, ow, oh, ow, oh)
    return C.nvsharpen_update_config(sharpness, w, h, w, h)


def _nis_input_pixel(z, cfg):
    """NVScaler's work per input pixel: the luma and the edge map."""
    from ..ops import nis as N
    y = N.get_y(z(3), cfg.hdr_mode)
    p = {(i, j): y for i in range(3) for j in range(3)}
    return N._edge_weights(*N._edge_grads(p), cfg)


def _nis_scaler_stages(z, cfg, dt=torch.float32):
    """NVScaler's per-output-pixel math (NIS_Scaler.h:589-770, ops/nis.py::
    nvscaler, csrc/nis_scaler.cu:237-367) on planes, stage by stage:
    {stage: closure}. dt: the working type of the filters (FilterNormal,
    the interpolation trees, EvalPoly6); the fractions, the diagonal
    phases, the edge weights and the combine stay f32."""
    from ..ops import nis as N
    from ..ops.bilinear import bilerp
    from ..ops.common import hlsl_lerp
    p = [[z().to(dt) for _ in range(6)] for _ in range(6)]
    fx, fy = z(), z()
    coef = [z().to(dt) for _ in range(6)]

    def normal():
        pixel_n = None
        for j in range(6):
            v = p[0][j] * coef[0]
            for i in range(1, 6):
                v = v + p[i][j] * coef[i]
            term = v * coef[j]
            pixel_n = term if pixel_n is None else pixel_n + term
        return pixel_n

    def f0f90():
        for axis, f in ((0, fx), (1, fy)):
            lo = f <= 0.5
            f = f.to(dt)
            taps = [hlsl_lerp(p[i][2], p[i][3], f) if axis == 0
                    else hlsl_lerp(p[2][i], p[3][i], f) for i in range(6)]
            N.eval_poly6_core(taps, coef, coef, lo, cfg, dt)

    def diag():
        for b, pairs, tails, frac in (
                (0.5 + 0.5 * (fx - fy),
                 (((2, 1), (1, 2)), ((3, 2), (2, 3)), ((4, 3), (3, 4))),
                 (((1, 1), (0, 2), (2, 0)), ((2, 2), (1, 3), (3, 1)),
                  ((3, 3), (2, 4), (4, 2)), ((4, 4), (3, 5), (5, 3))),
                 fx + fy),
                (0.5 * (fx + fy),
                 (((3, 1), (4, 2)), ((2, 2), (3, 3)), ((1, 3), (2, 4))),
                 (((4, 1), (5, 2), (3, 0)), ((3, 2), (4, 3), (2, 1)),
                  ((2, 3), (3, 4), (1, 2)), ((1, 4), (2, 5), (0, 3))),
                 1.0 + (fx - fy))):
            hi = b >= 0.5
            t = N._diag_taps(p, pairs, tails, b.to(dt),
                             torch.where(hi, b - 0.5, 0.5 - b).to(dt), hi)
            wrap = frac >= 1.0
            frac = torch.where(wrap, frac - 1.0, frac)
            lo = frac * 64.0 <= 32.0
            N.eval_poly6_core([torch.where(wrap, t[i + 1], t[i])
                               for i in range(6)], coef, coef, lo, cfg, dt)

    def edge():
        ws = []
        for _ in range(4):
            h0 = hlsl_lerp(z(), z(), fx)
            h1 = hlsl_lerp(z(), z(), fx)
            ws.append(hlsl_lerp(h0, h1, fy) * 255.0)
        return ws

    def resolve():
        f = [z() for _ in range(5)]
        ws = [z() for _ in range(4)]
        op_y = (f[0] * ws[0] + f[1] * ws[1] + f[2] * ws[2] + f[3] * ws[3]
                + f[4] * (255.0 - ws[0] - ws[1] - ws[2] - ws[3])) / 255.0
        op = bilerp(z(4), z(4), z(4), z(4), fx, fy)
        corr = op_y / 255.0 - N.get_y(op, cfg.hdr_mode)
        return op[:3] + corr

    return {"normal": normal, "f0f90": f0f90, "diag": diag, "edge": edge,
            "resolve": resolve}


def path_ops(kernel, h=16, w=16, in_per_out=1.0, sharpness=0.9,
             precision="full"):
    """(inside, fallback): the f32 ops per output pixel of `kernel`'s path
    inside the foveation circle and of its fallback, counted over (h, w)
    planes of the plain cores. in_per_out is the input pixels per output
    pixel (NVScaler computes its luma and edge map per input pixel).
    precision "half" counts the half cores of B1-B6 in FP32 issue slots
    (issue_slots: a bf16 op one half; the f32 parts, NIS's edge maps and
    combine among them, at full rate)."""
    from ..core import constants as C
    from ..ops import cas as CS
    from ..ops import nis as N
    from ..ops.bilinear import bilerp
    from ..ops.common import unorm_quantize
    from ..ops.easu import TAP_ORDER, easu_core
    from ..ops.rcas import rcas_core

    from ..kernels._common import working_type
    dt = working_type(precision)
    count = count_ops if dt == torch.float32 else issue_slots
    z = _planes(h, w)
    n = h * w
    sharp = float(C.fsr_rcas_con(C.rcas_stops_from_slider(sharpness)))

    def tint():          # G and B times the debug tint
        return z(2) * 0.7

    def bilinear_fallback():
        bilerp(z(3), z(3), z(3), z(3), z(), z())
        tint()

    if kernel == "fsr_fused":
        def inside():
            q = unorm_quantize(easu_core({t: z(3) for t in TAP_ORDER},
                                         z(), z(), dt))
            rcas_core(q, q, q, q, q, sharp, dt)

        def fallback():
            unorm_quantize(bilerp(z(3), z(3), z(3), z(3), z(), z()))
            tint()
    elif kernel == "rcas_sharpen":
        def inside():
            rcas_core(z(3), z(3), z(3), z(3), z(3), sharp, dt)
        fallback = tint
    elif kernel == "nis_scaler":
        cfg = _nis_config(h, w, h, w, sharpness, True)

        def inside():
            for stage in _nis_scaler_stages(z, cfg, dt).values():
                stage()
        fallback = bilinear_fallback
        per_in = count_ops(_nis_input_pixel, z, cfg) / n
        return (count(inside) / n + per_in * in_per_out,
                count_ops(fallback) / n)
    elif kernel == "nis_sharpen":
        cfg = _nis_config(h, w, h, w, sharpness, False)

        def inside():
            N.nvsharpen(z(4), cfg, dt)
        fallback = tint
    elif kernel == "cas_upscale":
        def inside():
            CS.cas_upscale_core({t: z(3) for t in CS.CAS_USED_TAPS}, z(), z(),
                                CS.cas_setup(sharpness), dt)
        fallback = bilinear_fallback
    elif kernel == "cas_sharpen":
        def inside():
            CS.cas_core({(dy, dx): z(3) for dy in (-1, 0, 1)
                         for dx in (-1, 0, 1)}, CS.cas_setup(sharpness), 1.0,
                        dt)
        fallback = tint
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return count(inside) / n, count(fallback) / n


def nis_stage_ops(h=16, w=16, sharpness=NIS_SHARPNESS):
    """NVScaler's ops per output pixel by stage, plus its luma and edge map
    per input pixel."""
    z = _planes(h, w)
    cfg = _nis_config(h, w, h, w, sharpness, True)
    out = {name: count_ops(f) / (h * w)
           for name, f in _nis_scaler_stages(z, cfg).items()}
    out["luma_and_edge_map_per_input_pixel"] = \
        count_ops(_nis_input_pixel, z, cfg) / (h * w)
    return out


def vpu_cycle_ops(h=16, w=16):
    """The meter's ops per element of one vpu_cycle (30)."""
    from ..kernels import sol
    z = _planes(h, w)
    return count_ops(sol.vpu_cycle, [z() for _ in range(8)], z()) / (h * w)


# ---- (c) floors of one kernel --------------------------------------------------

def kernel_floors(inside_px, fallback_px, ops, smem_words, unique_bytes,
                  rates, ms):
    """The floors of one kernel launch (ms) and their max.

    ops / smem_words: (inside, fallback) per output pixel; rates: dict with
    fp32 (ops/s), smem (bytes/s). Returns a dict of compute_floor_ms,
    smem_floor_ms, tensor_floor_ms (0: no mma), memory_floor_ms, bound_ms
    (the largest), bound_by, share (bound / ms)."""
    floors = {
        "compute": (inside_px * ops[0] + fallback_px * ops[1])
        / rates["fp32"] * 1e3,
        "smem": (inside_px * smem_words[0] + fallback_px * smem_words[1])
        * 4 / rates["smem"] * 1e3,
        "tensor": 0.0,
        "memory": unique_bytes / HBM_BYTES_PER_S * 1e3,
    }
    bound_by = max(floors, key=floors.get)
    return {**{f"{k}_floor_ms": v for k, v in floors.items()},
            "bound_ms": floors[bound_by], "bound_by": bound_by,
            "share": floors[bound_by] / ms}


def roofline_bound(nbytes, ops, peak, smem_bytes=0, smem_rate=None):
    """(ms, bound_by): the least time the card could take for one call, the
    largest of its unique device-memory bytes over HBM_BYTES_PER_S
    ("bytes"), its operations over `peak`, the rate of their type
    ("operations") and, for work that is shared-memory reads by definition
    (the shared-memory probe), those bytes over smem_rate ("smem")."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": ops / peak * 1e3}
    if smem_bytes:
        terms["smem"] = smem_bytes / smem_rate * 1e3
    by = max(terms, key=terms.get)
    return terms[by], by


def fp32_instructions_per_s(sms, clock_hz):
    """The FP32 issue bound: SMs x 128 lanes x the SM clock, one rounded
    FADD, FMUL or FMNMX per lane and clock."""
    return sms * LANES_PER_SM * clock_hz


def smem_bytes_per_s(sms, clock_hz):
    """The shared-memory bound: SMs x 128 B per clock x the SM clock."""
    return sms * LANES_PER_SM * clock_hz


def tensor_macs_per_s(sms, clock_hz):
    """The dense bf16 tensor bound: SMs x 2,048 MACs per clock x the SM
    clock."""
    return sms * TENSOR_MACS_PER_SM_CLOCK * clock_hz


def probe_bounds(vpu, vmem, mxu, sms, clock_hz, fp32_per_cycle=None):
    """{probe name: (bound ms, bound_by)} of the three rate-probe builds
    (kernels/sol.py), each a roofline_bound: the FP32 probe its FP32
    instructions (fp32_per_cycle per element and vpu_cycle, as
    sass.probe_loops counts them in its SASS; the meter's ops where that is
    None) over fp32_instructions_per_s(sms, clock_hz), the bound
    measure_rates states for the FP32 rate; the shared-memory probe the
    plane bytes its step loop reads (bytes_per_step x steps) over
    smem_bytes_per_s(sms, clock_hz), beside its Horner ops (an FMUL and an
    FADD per word) at the same issue bound; the tensor-core probe its MACs
    over tensor_macs_per_s(sms, clock_hz), the bound measure_rates states
    for the tensor rate. Each also has its input and output bytes over
    HBM_BYTES_PER_S."""
    out = (8 * 128) * 4      # every probe's (8, 128) f32 result
    plane_bytes = vmem.bytes_per_step * vmem.steps
    issue = fp32_instructions_per_s(sms, clock_hz)
    per_cycle = fp32_per_cycle or vpu_cycle_ops()
    return {
        "vpu_rate": roofline_bound(
            vpu.elems * 4 + out,
            vpu.k * per_cycle * vpu.elems * vpu.steps, issue),
        "vmem_rate": roofline_bound(
            vmem.bytes_per_step + out, 2 * plane_bytes // 4, issue,
            smem_bytes=plane_bytes,
            smem_rate=smem_bytes_per_s(sms, clock_hz)),
        "mxu_rate": roofline_bound(3 * mxu.tile ** 2 * 4, mxu.macs,
                                   tensor_macs_per_s(sms, clock_hz)),
    }


# ---- (b) the rates on the card ----------------------------------------------

def _event_ms(fn, args, iters, rounds=3):
    """CUDA-event ms per call of iters back-to-back calls fn(*args), the
    best of `rounds`: a host stall between launches lengthens a round's
    events and never shortens them, and would otherwise set one pair's
    slope apart from the others'."""
    from ..utils.timing import rotation_ms
    return min(rotation_ms(lambda _: fn(*args), args[:1], iters)
               for _ in range(rounds))


def _measure_rate(builds, args_of, work, side_ops=None, fp32_rate=None,
                  iters=5):
    """Time a probe's lo and hi builds in interleaved pairs. args_of(fn)
    gives a build's inputs, work(fn) its metered work, side_ops(fn) its
    per-k side ops (priced at fp32_rate and taken off each pair's time for
    the net rate). Returns the record."""
    lo, hi = builds
    for f in builds:
        f(*args_of(f))
    torch.cuda.synchronize()
    d_work = work(hi) - work(lo)
    rate, slopes = paired_slope(lambda: _event_ms(lo, args_of(lo), iters),
                                lambda: _event_ms(hi, args_of(hi), iters),
                                d_work)
    rec = {"k": [lo.k, hi.k], "steps": hi.steps, "d_work": d_work,
           "hi_ms": _event_ms(hi, args_of(hi), iters), "rate": rate,
           "pair_slopes": slopes, "spread": max(slopes) / min(slopes)}
    if side_ops is not None:
        rec["side_ops"] = side_ops(hi) - side_ops(lo)
        side_s = rec["side_ops"] / fp32_rate
        dts = [d_work / sl - side_s for sl in slopes]
        rec["side_ms"] = side_s * 1e3
        rec["net_rate"] = (statistics.median(d_work / dt for dt in dts)
                           if min(dts) > 0 else None)
    return rec


def _smi(query):
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def measure_rates(dev, quick=False):
    """The three rates on the card, each with its bound. Returns (rates
    dict, the six probe builds)."""
    from ..kernels import sol
    from . import sass

    sel = 1 if quick else 0
    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(_smi("clocks.max.sm") or "nan") * 1e6
    loops = sass.probe_loops()
    cycle_ops = vpu_cycle_ops()
    fp32_per_cycle = loops["vpu_rate"]["fp32_per_cycle"] if loops else None

    k_lo, k_hi, steps = PROBES["vpu"][sel]
    vpu = [sol.build_vpu_rate(k, steps=steps) for k in (k_lo, k_hi)]
    seed = torch.from_numpy(rng.random((130, 128), np.float32)).to(dev)
    fp32 = _measure_rate(vpu, lambda f: (seed,),
                         lambda f: f.k * cycle_ops * f.elems * f.steps)
    fp32.update(unit="meter ops/s", ops_per_cycle=cycle_ops,
                fp32_instructions_per_cycle=fp32_per_cycle,
                bound=fp32_instructions_per_s(sms, clock_hz),
                bound_unit="FP32 instructions/s (SMs x 128 lanes x max SM "
                           "clock)")
    fp32["instruction_rate"] = fp32["rate"] * (
        (fp32_per_cycle or cycle_ops) / cycle_ops)

    k_lo, k_hi, steps = PROBES["vmem"][sel]
    shares = sol.vmem_rate_shares(k_hi, steps=steps)   # the same for both
    vmem = [sol.build_vmem_rate(k, steps=steps, shares=shares)
            for k in (k_lo, k_hi)]
    planes = torch.from_numpy(rng.random((k_hi, 130, 128),
                                         np.float32)).to(dev)
    vmem_args = {k_lo: (planes[:k_lo].contiguous(),), k_hi: (planes,)}
    z = _planes(130, 128)
    horner = count_ops(lambda a, s, x: a * s + x, z(), z(), z()) / (130 * 128)
    smem = _measure_rate(vmem, lambda f: vmem_args[f.k],
                         lambda f: f.bytes_per_step * f.steps,
                         lambda f: f.bytes_per_step // 4 * horner * f.steps,
                         fp32["rate"])
    smem.update(unit="bytes/s", side_ops_per_word=horner, shares=shares,
                plane_words_per_lds=loops["vmem_rate"]["words_per_lds"]
                if loops else None,
                bound=smem_bytes_per_s(sms, clock_hz),
                bound_unit="bytes/s (SMs x 128 B per clock x max SM clock)")

    k_lo, k_hi, steps = PROBES["mxu"][sel]
    mxu = [sol.build_mxu_rate(k, steps=steps) for k in (k_lo, k_hi)]
    x = torch.from_numpy(rng.random((128, 128), np.float32)).to(dev)
    w = torch.from_numpy(rng.random((128, 128), np.float32) * 0.1).to(dev)
    scale = count_ops(lambda c: (c * 1e-3).to(torch.bfloat16),
                      torch.zeros(128, 128)) / 128 ** 2
    tensor = _measure_rate(mxu, lambda f: (x, w), lambda f: f.macs,
                           lambda f: f.k * 8 * 128 ** 2 * scale * f.steps,
                           fp32["rate"])
    tensor.update(unit="MAC/s", side_ops_per_element_round=scale,
                  hgmma_per_round=loops["mxu_rate"]["hgmma_per_round"]
                  if loops else None,
                  bound=tensor_macs_per_s(sms, clock_hz),
                  bound_unit="MAC/s (SMs x 2,048 dense bf16 MACs per clock "
                             "x max SM clock)")
    rates = {"fp32": fp32, "smem": smem, "tensor": tensor,
             "sms": sms, "max_sm_clock_hz": clock_hz}
    return rates, [*vpu, *vmem, *mxu]


# ---- (c) the kernels on the card ----------------------------------------------

def _kernel_build(kernel, radius, dev):
    """(kernel function, input h, w) of one kernel's bench path at a
    radius (NVScaler at the JAX tool's sharpness)."""
    from ..api.pipeline import Pipeline
    from .bench_paths import path_config

    cfg, h, w = path_config(KERNEL_PATHS[kernel])
    cfg = cfg.with_(radius=radius)
    if kernel == "nis_scaler":
        cfg = cfg.with_(sharpness=NIS_SHARPNESS)
    return Pipeline(cfg, device=dev)._build(2, h, w, (0, 1), True), h, w


def inside_pixels(geom):
    """Output pixels inside the foveation circle by the kernel's own test
    (the reference's, per foveation group, as the host's per-group classes
    give it to every kernel: kernels/_maps.py::group_classes), and the
    fallback pixels; a 10-bit build's geometry counts its words in pairs."""
    from ..kernels._common import circle_mask
    mask = circle_mask(torch.as_tensor(geom["centres"]), geom["out_h"],
                       geom["out_w"] // geom.get("texel_words", 1),
                       tuple(geom["group"]))
    inside = int(mask.sum())
    return inside, mask.numel() - inside


def kernel_ms(fn, inputs, iters=30, rounds=3, warmup=5):
    """bench.py's method: warm-up, then `iters` calls over the rotating ring
    frames captured in one CUDA graph, the best of `rounds` replays."""
    from ..utils.timing import replay_ms, rotation_graph, rotation_ms
    rotation_ms(fn, inputs, warmup)
    graph = rotation_graph(fn, inputs, iters)
    return min(replay_ms(graph, iters) for _ in range(rounds))


def audit_kernels(kernels, rates, dev):
    """One row per kernel and radius (RADII), and the inside-math delta
    (ms at 2.0 - ms at 0.0 against the ops it adds / FP32 rate, shown as
    information: the fallback may hide under memory time)."""
    from ..bench import ring_frames

    price = {"fp32": rates["fp32"]["rate"], "smem": rates["smem"]["rate"]}
    rows, deltas = [], []
    for kernel in kernels:
        by_radius = {}
        for radius in RADII:
            fn, h, w = _kernel_build(kernel, radius, dev)
            g = fn.dma_geometry
            inputs = ring_frames(h, w, fn.pad_to, dev)
            fn(inputs[0])
            ms = kernel_ms(fn, inputs)
            inside, fallback = inside_pixels(g)
            ops = path_ops(kernel, in_per_out=h * w / (g["out_h"] * g["out_w"]),
                           sharpness=(NIS_SHARPNESS if kernel == "nis_scaler"
                                      else 0.9))
            unique = (2 * h * w + 2 * g["out_h"] * g["out_w"]) * 4
            row = {"kernel": kernel, "radius": radius, "ms": ms,
                   "inside_px": inside, "fallback_px": fallback,
                   "ops_per_px": list(ops),
                   "smem_words_per_px": list(SMEM_WORDS[kernel]),
                   "unique_bytes": unique,
                   **kernel_floors(inside, fallback, ops, SMEM_WORDS[kernel],
                                   unique, price, ms),
                   "launches": fn.kernel.launches}
            by_radius[radius] = row
            if radius != 0.0:
                rows.append(row)
            print(f"[audit] {kernel} radius {radius}: {ms:.5f} ms, inside "
                  f"{inside} / fallback {fallback} px, floors compute "
                  f"{row['compute_floor_ms']:.5f} smem "
                  f"{row['smem_floor_ms']:.5f} memory "
                  f"{row['memory_floor_ms']:.5f} ms -> bound "
                  f"{row['bound_ms']:.5f} ({row['bound_by']}), share "
                  f"{row['share']:.3f}", file=sys.stderr, flush=True)
        full, none = by_radius[2.0], by_radius[0.0]
        d_ops = ((full["inside_px"] - none["inside_px"])
                 * (full["ops_per_px"][0] - full["ops_per_px"][1]))
        deltas.append({"kernel": kernel,
                       "ms_2_minus_0": full["ms"] - none["ms"],
                       "d_ops": d_ops,
                       "d_ops_floor_ms": d_ops / price["fp32"] * 1e3})
    return rows, deltas


def main(argv=None):
    """Run the audit, print its JSON line, and return (the result dict, the
    probe builds, each counting its launches)."""
    from .. import bench

    ap = argparse.ArgumentParser(
        prog="python3 -m openvr_fsr_tpu_torch.tools.vpu_audit",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--nis", action="store_true",
                    help="audit NVScaler only, with its op counts by stage")
    ap.add_argument("--quick", action="store_true",
                    help="shorter rate probes")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    bench.require_gpu(["vpu_audit"])
    dev = torch.device("cuda", torch.cuda.current_device())
    card = bench.card()
    counts = {k: list(path_ops(k)) for k in SMEM_WORDS}
    counts["vpu_cycle"] = vpu_cycle_ops()
    print(f"[audit] {card}; ops per output pixel (inside, fallback): "
          f"{counts}", file=sys.stderr, flush=True)
    rates, probes = measure_rates(dev, quick=args.quick)
    for name, unit in (("fp32", 1e12), ("smem", 1e12), ("tensor", 1e12)):
        r = rates[name]
        print(f"[audit] {name} rate {r['rate'] / unit:.3f} T{r['unit']} "
              f"(net of side work: "
              f"{(r.get('net_rate') or float('nan')) / unit:.3f}), pairs "
              f"{[round(s / unit, 3) for s in r['pair_slopes']]}, spread "
              f"{r['spread']:.3f}, hi call {r['hi_ms']:.3f} ms, bound "
              f"{r['bound'] / unit:.3f} T", file=sys.stderr, flush=True)
    kernels = ["nis_scaler"] if args.nis else list(SMEM_WORDS)
    rows, deltas = audit_kernels(kernels, rates, dev)
    res = {"metric": "vpu_audit", "device": card, "rates": rates,
           "ops_per_px": counts, "kernels": rows, "inside_math": deltas,
           "settings": {"probes": {k: v[1 if args.quick else 0]
                                   for k, v in PROBES.items()},
                        "radii": RADII, "nis_sharpness": NIS_SHARPNESS}}
    if args.nis:
        res["nis_stage_ops_per_px"] = nis_stage_ops()
    line = json.dumps(res, allow_nan=False)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res, probes


if __name__ == "__main__":
    main()
