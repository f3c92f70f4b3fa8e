"""The traced run: torch.profiler over the window, reduced to what the
per-layer readers and the breakdown need.

The harness brackets the calls into each layer with `Tracer.span(name)`
(torch.profiler.record_function, "bench.<name>", on whichever thread makes
the call) and the whole window with "bench.window". The profiler's Chrome
trace is written under TMPDIR, read back and deleted. From it:
  * kernels: every CUDA kernel that starts inside the window (name, start,
    duration), the source of kernel_ms and the roofline;
  * busy_s: the union of the CUDA kernels, copies and memsets inside the
    window, and window_s the window's length, so the idle share is
    1 - busy_s / window_s;
  * breakdown: the ten kernels by summed time, and the device's idle time
    inside the window summed by what the host was doing meanwhile (the
    innermost bench.* span of each thread at the gap's midpoint).
Without tracing, `span` is a shared no-op context.
"""

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["Tracer", "TraceSummary", "summarize", "union_length"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NULL = contextlib.nullcontext()


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)     # (name, ts_us, dur_us)
    device_ops: list = field(default_factory=list)  # [name, seconds]
    idle_gaps: list = field(default_factory=list)   # [host activity, seconds]


class Tracer:
    """torch.profiler around the window when enabled, else nothing."""

    def __init__(self, enabled, cuda=True):
        self.enabled = bool(enabled)
        self.cuda = cuda
        self._prof = None
        self.summary = None

    def span(self, name):
        if not self.enabled:
            return _NULL
        import torch
        return torch.profiler.record_function(f"bench.{name}")

    def start(self):
        """Start the profiler (its own start-up stays outside the window)."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self):
        """Stop, export, reduce; returns the TraceSummary (None untraced)."""
        if self._prof is None:
            return None
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = summarize(events)
        return self.summary


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events):
    """TraceSummary of a Chrome trace's events (times in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bench.")]
    windows = [e for e in spans if e["name"] == "bench.window"]
    if not windows:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = min(float(e["ts"]) for e in windows)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in windows)
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    clipped = [(max(float(e["ts"]), w0),
                min(float(e["ts"]) + float(e.get("dur", 0.0)), w1))
               for e in dev]
    clipped = [(s, t) for s, t in clipped if t > s]
    busy_us = union_length(clipped)
    kernels = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
               for e in dev if e["cat"] == "kernel"
               and w0 <= float(e["ts"]) < w1]
    by_name = defaultdict(float)
    for name, _, dur in kernels:
        by_name[name[:160]] += dur * 1e-6
    device_ops = sorted(([n, s] for n, s in by_name.items()),
                        key=lambda x: -x[1])[:10]
    # idle gaps inside the window, named by what each thread was doing
    host = defaultdict(list)
    for e in spans:
        if e["name"] != "bench.window":
            host[e.get("tid")].append((float(e["ts"]),
                                       float(e["ts"]) + float(e["dur"]),
                                       e["name"][len("bench."):]))
    idle = defaultdict(float)
    count = defaultdict(int)
    edge = w0
    for s, t in _merged(clipped) + [[w1, w1]]:
        if s > edge:
            mid = 0.5 * (edge + s)
            doing = []
            for tid in sorted(host, key=str):
                inner = [x for x in host[tid] if x[0] <= mid < x[1]]
                if inner:
                    doing.append(min(inner, key=lambda x: x[1] - x[0])[2])
            label = "+".join(sorted(set(doing))) or "other"
            idle[label] += (s - edge) * 1e-6
            count[label] += 1
        edge = max(edge, t)
    idle_gaps = sorted(([f"{k} ({count[k]} gaps)", v]
                        for k, v in idle.items()), key=lambda x: -x[1])[:10]
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                        kernels=kernels, device_ops=device_ops,
                        idle_gaps=idle_gaps)
