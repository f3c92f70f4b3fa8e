"""Timing: the debug-mode frame timer and the bench helpers.

GpuTimer is the analog of the reference's GPU timestamp-query ring
(PostProcessor.h:72-83, PostProcessor.cpp:547-628): time each dispatch,
keep a rolling average over 500 frames, and log "Average GPU processing
time for upscale: X ms" at each rollover. bench_fn (with its
profile_dir trace, torch.profiler's Chrome trace in place of
jax.profiler's), rotation_ms and hbm_calibration are the counterparts of
the JAX package's utils/timing.py:56-110. CUDA work is timed with pairs of
`torch.cuda.Event`s on the current stream (the timestamp queries'
counterpart); CPU work with `time.perf_counter`. rotation_graph and
replay_ms time a kernel's device work alone: its calls captured once in a
CUDA graph and replayed, so no host launch sits between them. wall_ms
times what a caller pays: back-to-back calls on the host's clock, ending
in a host sync.
"""

import json
import os
import time
from pathlib import Path

import torch

from .log import get_logger

__all__ = ["GpuTimer", "bench_fn", "kernel_events", "rotation_ms", "wall_ms",
           "rotation_graph", "replay_ms", "hbm_calibration"]


class GpuTimer:
    """Rolling-average frame timer (500-sample window like the reference).

    Logs per-STEREO-PAIR milliseconds. The reference times one single-eye
    dispatch and doubles it (PostProcessor.cpp:621-622); here one measured
    call covers a whole batch, so the per-pair figure is t / pairs with
    pairs supplied by the caller (B/2 for single-eye batches — a B=1
    single-eye call has pairs=0.5, reproducing the reference's x2)."""

    def __init__(self, window=500, scale_for_stereo=False):
        self.window = window
        self.scale_for_stereo = scale_for_stereo
        self.summed = 0.0
        self.count = 0
        self.last_avg_ms = None

    def measure(self, fn, *args, pairs=None):
        """Run fn(*args) and add its time (seconds) to the window. Any CUDA
        tensor argument selects event timing on the current stream; the call
        then waits for its end event."""
        cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1000.0
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            seconds = time.perf_counter() - t0
        if pairs is None:
            pairs = 0.5 if self.scale_for_stereo else 1.0
        self.summed += seconds / pairs
        self.count += 1
        if self.count >= self.window:
            avg_ms = 1000.0 / self.count * self.summed
            self.last_avg_ms = avg_ms
            get_logger().info(
                "Average GPU processing time for upscale: %.4f ms", avg_ms)
            self.count = 0
            self.summed = 0.0
        return out


def _is_cuda(args):
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def bench_fn(fn, *args, warmup=3, iters=50, profile_dir=None):
    """Time fn(*args) call by call: returns (best_ms, avg_ms) over `iters`
    calls after `warmup`. Any CUDA tensor argument selects a CUDA event
    pair around each call on the current stream (read after the last call
    ends); otherwise each call is timed with perf_counter.

    profile_dir: also trace the timed calls with torch.profiler (CPU
    activity, and CUDA activity when an argument is a CUDA tensor) and
    write one Chrome trace, profile_dir/bench_fn_<pid>_<ns>.json
    (`kernel_events` reads its CUDA kernels). The times of a traced run
    carry the profiler's cost. On CUDA a trace holding no kernel event
    (CUPTI refused or unavailable) is not written, and RuntimeError names
    CUPTI."""
    for _ in range(warmup):
        fn(*args)
    cuda = _is_cuda(args)
    if profile_dir is None:
        return _timed_calls(fn, args, iters, cuda)
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        times = _timed_calls(fn, args, iters, cuda)
        if cuda:
            torch.cuda.synchronize()
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"bench_fn_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    if cuda and not kernel_events(path):
        path.unlink()
        raise RuntimeError(
            "torch.profiler recorded no CUDA kernel in the traced calls: "
            "CUPTI (the CUDA profiling interface that traces the card) is "
            "refused or unavailable here, so no device trace exists")
    return times


def _timed_calls(fn, args, iters, cuda):
    if cuda:
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            start.record()
            fn(*args)
            end.record()
        events[-1][1].synchronize()
        times = [start.elapsed_time(end) for start, end in events]
    else:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1000.0)
    return min(times), sum(times) / len(times)


def kernel_events(trace_path):
    """The CUDA kernels of a Chrome trace from torch.profiler: a list of
    (name, device microseconds), one per launch (events of category
    "kernel")."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e.get("dur", 0.0))) for e in events
            if e.get("cat") == "kernel"]


def rotation_ms(fn, inputs, iters):
    """ms per call of `iters` back-to-back calls fn(inputs[i % len]),
    rotating through the inputs: one CUDA event pair around the whole run
    when the inputs are CUDA tensors (the device time of a steady stream of
    launches), else perf_counter."""
    if inputs[0].is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    return (time.perf_counter() - t0) * 1000.0 / iters


def wall_ms(fn, inputs, iters):
    """Host ms per call of `iters` back-to-back calls fn(inputs[i % len]),
    on perf_counter, ending in a host sync of the inputs' CUDA device (the
    root bench.py's run(), :89-95): the device time and the host's cost of
    each call, whichever is longer, plus one sync."""
    t0 = time.perf_counter()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    if inputs[0].is_cuda:
        torch.cuda.synchronize(inputs[0].device)
    return (time.perf_counter() - t0) * 1000.0 / iters


def rotation_graph(fn, inputs, iters):
    """`iters` calls fn(inputs[i % len]) captured in one CUDA graph and
    replayed once (each input called once on a side stream first, as
    capture requires) on the current CUDA device, captured on that side
    stream (torch.cuda.graph's default capture stream belongs to the device
    current when it was first used). A wrapper that counts its launches
    counts each captured call once; a replay runs them again uncounted.
    Raises ValueError on CPU inputs: there is no graph to capture."""
    if not inputs[0].is_cuda:
        raise ValueError("rotation_graph captures CUDA work: the inputs "
                         "are on the CPU")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in inputs:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(inputs[i % len(inputs)])
    graph.replay()
    return graph


def replay_ms(graph, iters):
    """Device ms per call of one replay of a rotation_graph of `iters`
    calls, timed with one CUDA event pair: the host launches the graph
    once, so its cost per call is out of the time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def hbm_calibration(device, read_shape=(2, 1872, 1792),
                    write_shape=(2, 2492, 2244), n=20, rounds=3):
    """Device memory rates at the headline shapes: returns (read_bw,
    write_bw) in bytes/s, from a pure-read reduce of (2, 1872, 1792) int32
    planes (the ring-pitch input pair) and a pure-write fill of (2, 2492,
    2244) planes (the output pair), each the best of `rounds` runs of `n`
    calls (rotation_ms) over three planes, which at these shapes exceed the
    H100's 50 MB L2. The reduce sums rows in int32 (wrapping): torch's
    default int64 accumulation of an int32 sum reads at about a fifth of
    the rate on an H100 (469 against 1,928 GB/s) and would time the upcast,
    not the reads. On a CPU device the rates are the host's."""
    reads = [torch.zeros(read_shape, dtype=torch.int32, device=device)
             for _ in range(3)]
    writes = [torch.empty(write_shape, dtype=torch.int32, device=device)
              for _ in range(3)]

    def best_ms(fn, bufs):
        fn(bufs[0])
        return min(rotation_ms(fn, bufs, n) for _ in range(rounds))

    read_ms = best_ms(lambda a: a.sum(dim=-1, dtype=torch.int32), reads)
    write_ms = best_ms(lambda a: a.fill_(7), writes)
    return (reads[0].numel() * 4 / (read_ms / 1000.0),
            writes[0].numel() * 4 / (write_ms / 1000.0))
