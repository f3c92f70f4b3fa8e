"""Canonical benchmark of the port on one NVIDIA GPU: the stereo eye pair
through the fused FSR kernel at the reference headline config, 1683x1869
per eye upscaled to 2244x2492 at renderScale 0.75, sharpness 0.9,
foveated radius 0.5. The port of the repository's root bench.py.

    python3 -m openvr_fsr_tpu_torch.bench

Prints ONE JSON line on stdout:
  {"metric": "fsr_stereo_eyepair_2244x2492_rs075_ms", "value": <ms per
   stereo pair, back to back, host included>, "unit": "ms",
   "device_ms": <ms per stereo pair, device time alone>,
   "vs_baseline": <1 ms north star / value>, "sol_probe": "cuda_dma_floor",
   "probe_effective_gbps": ..., "hbm_sol_ms": <the kernel's DMA floor, ms,
   device time>, "vs_sol": <floor / device_ms>,
   "device": "<nvidia-smi name, power limit>"}
Diagnostics go to stderr.

Methodology. The inputs are the root bench.py's (:63-81): the zero-copy
packed serving input, three rotating stereo frames resident on the card
and pre-padded to the kernel's ring pitch (fn.pad_to); three frame pairs
(75 MB) exceed the H100's 50 MB L2, so no call reads the last call's input
from L2. Two numbers per path, each the best of 3 rounds after a warm-up
of 5 calls, the rounds in turns:
  - value, the root's quantity (bench.py:89-98): 40 back-to-back calls
    fn(inputs[i % 3]) timed with perf_counter and ending in a host sync
    (utils/timing.py::wall_ms). What a caller that calls once per frame
    pays, the host's cost of each call included.
  - device_ms: the same 40 calls captured once in a CUDA graph and
    replayed, timed with one CUDA event pair (rotation_graph, replay_ms):
    the card's time alone. value - device_ms is the host's cost a caller
    sees on top of it: the part of each call's host work, and of the gaps
    between launches, that the card's work does not hide.
The yardstick is the kernel's own DMA floor (kernels/sol.py,
csrc/dma_floor.cu: its loads and stores with perfect overlap, no compute),
replayed from its own graph of the same 40 calls over the same frames, in
turns with the kernel, so vs_sol = floor / device_ms <= 1: device time
against device time (the floor's device time is near the host's cost of a
call, so a back-to-back floor would time the host).
probe_effective_gbps is the floor's unique input plane plus its output
over its time.

With no CUDA GPU, or when the watchdog fires, the line has value null and
an error, and the exit code is not 0: a CPU number is never a bench result.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

METRIC = "fsr_stereo_eyepair_2244x2492_rs075_ms"
H_IN, W_IN = 1869, 1683
CONFIG = dict(render_scale=0.75, sharpness=0.9, radius=0.5)
SOL_PROBE = "cuda_dma_floor"
WARMUP, ITERS, ROUNDS = 5, 40, 3
# a hung bench is worse than a failed one: fail loudly instead
WATCHDOG_S = 1500

__all__ = ["main", "measure", "ring_frames", "card", "error_record",
           "require_gpu", "PathRun", "METRIC"]


def error_record(metric, error, unit="ms"):
    """The line printed instead of a result."""
    return {"metric": metric, "value": None, "unit": unit,
            "vs_baseline": None, "error": error}


def require_gpu(metrics, unit="ms"):
    """Print an error line for each metric and exit 1 unless torch finds a
    CUDA GPU."""
    import torch
    if not torch.cuda.is_available():
        for metric in metrics:
            print(json.dumps(error_record(
                metric, "torch finds no CUDA GPU: the bench measures the "
                "card only", unit)), flush=True)
        sys.exit(1)


def card():
    """The card as `nvidia-smi --query-gpu=name,power.limit` names it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi exited {r.returncode}: "
                           f"{r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def ring_frames(h, w, pad_to, device):
    """The root bench.py's three stereo frames (:75-81): zone plate + noise,
    uniform random, gradient + checkerboard, packed to the native u32 plane,
    padded to the ring pitch `pad_to`, and moved to `device` as int32 views
    of the u32 words (the port's packed dtype; no converted copy)."""
    import torch

    from .utils import frames as FR
    rng = np.random.default_rng(0)
    hp, wp = pad_to
    sets = [
        np.stack([FR.zone_plate_frame(h, w), FR.noise_frame(h, w, seed=1)]),
        rng.integers(0, 256, (2, h, w, 4)).astype(np.uint8),
        np.stack([FR.gradient_frame(h, w), FR.checkerboard_frame(h, w)])]
    out = []
    for u8 in sets:
        packed = np.ascontiguousarray(u8).view(np.uint32)[..., 0]
        ring = np.pad(packed, ((0, 0), (0, hp - h), (0, wp - w)))
        out.append(torch.from_numpy(ring.view(np.int32)).to(device))
    return out


@dataclasses.dataclass
class PathRun:
    """One path measured: its kernel and DMA floor (each counting its
    launches), ms per stereo pair (`ms` back to back with the host's cost
    of a call, `device_ms` and the floor's `sol_ms` from CUDA graphs), and
    the build seconds."""

    kernel: object
    floor: object
    ms: float
    device_ms: float
    sol_ms: float
    compile_s: float
    out_w: int
    out_h: int

    @property
    def vs_sol(self):
        return self.sol_ms / self.device_ms

    @property
    def probe_effective_gbps(self):
        return self.floor.hbm_bytes / 1e9 / (self.sol_ms / 1000.0)


def measure(config, h, w, *, iters=ITERS, rounds=ROUNDS, warmup=WARMUP,
            device="cuda"):
    """Time one plan's kernel and its DMA floor on the card over the three
    ring frames of (h, w) stereo pairs, in turns each round: the kernel's
    and the floor's CUDA graphs of `iters` calls, and `iters` back-to-back
    kernel calls ending in a host sync; the best of `rounds` each.
    compile_s is the build (host tables, and nvcc where the library is not
    built yet) plus the first launch."""
    import torch

    from .api.pipeline import Pipeline
    from .kernels.sol import build_dma_floor
    from .utils.timing import replay_ms, rotation_graph, rotation_ms, wall_ms

    pipe = Pipeline(config, device=device)
    out_w, out_h = pipe.output_size(w, h)
    t0 = time.perf_counter()
    fn = pipe._build(2, h, w, (0, 1), True)
    build_s = time.perf_counter() - t0
    inputs = ring_frames(h, w, fn.pad_to, device)
    t0 = time.perf_counter()
    fn(inputs[0])
    torch.cuda.synchronize()
    compile_s = build_s + time.perf_counter() - t0
    floor = build_dma_floor(fn.dma_geometry)
    floor(inputs[0])
    for f in (fn, floor):
        rotation_ms(f, inputs, warmup)
    graphs = [rotation_graph(f, inputs, iters) for f in (fn, floor)]
    ms, device_ms, sol_ms = [], [], []
    for _ in range(rounds):
        device_ms.append(replay_ms(graphs[0], iters))
        sol_ms.append(replay_ms(graphs[1], iters))
        ms.append(wall_ms(fn, inputs, iters))
    return PathRun(fn.kernel, floor, min(ms), min(device_ms), min(sol_ms),
                   compile_s, out_w, out_h)


def _watchdog(signum, frame):
    print(json.dumps(error_record(
        METRIC, f"watchdog: no result in {WATCHDOG_S} s")), flush=True)
    os._exit(2)


def main():
    """Measure the headline config, print its JSON line and return
    (the line as a dict, the PathRun)."""
    if hasattr(signal, "SIGALRM"):
        signal.signal(signal.SIGALRM, _watchdog)
        signal.alarm(WATCHDOG_S)
    try:
        require_gpu([METRIC])
        from .core.config import Config
        run = measure(Config(enabled=True, **CONFIG), H_IN, W_IN)
        device = card()
    finally:
        if hasattr(signal, "SIGALRM"):
            signal.alarm(0)
    out_mpix = 2 * run.out_w * run.out_h / 1e6
    print(f"[bench] {device}: {run.ms} ms/stereo-pair back to back "
          f"({out_mpix / (run.ms / 1000.0):.0f} Mpix/s), {run.device_ms} ms "
          f"device time; DMA floor {run.sol_ms} ms for "
          f"{run.floor.hbm_bytes / 1e6:.1f} MB "
          f"({run.probe_effective_gbps:.0f} GB/s effective), kernel at "
          f"{run.vs_sol * 100:.0f}% of it", file=sys.stderr, flush=True)
    record = {
        "metric": METRIC,
        "value": run.ms,
        "unit": "ms",
        "device_ms": run.device_ms,
        "vs_baseline": 1.0 / run.ms,
        "sol_probe": SOL_PROBE,
        "probe_effective_gbps": run.probe_effective_gbps,
        "hbm_sol_ms": run.sol_ms,
        "vs_sol": run.vs_sol,
        "device": device,
    }
    print(json.dumps(record), flush=True)
    return record, run


if __name__ == "__main__":
    main()
