"""Spans and counters at the port's boundaries, on torch.profiler's clock.

The program marks four boundaries with `span(name)`: the API call
(`process`, all of Pipeline.process), the kernel launch (`launch`, the CUDA
branch of kernels/_common.py::kernel_fn: the output's allocation, the
tables and the C entry point with its kernel launches), the build (`build`,
Pipeline._build on a build-cache miss: stage plan, host maps, DMA
geometry) and the kernel library's load (`library`, kernels/_build.py::
load_library, its info's `built` saying whether nvcc ran).

The switch is torch's own: a hot span (`process`, `launch`) records only
while a torch profiler runs, read once per span. Off, `span` returns None
and the caller runs its body bare: no record_function, which costs
microseconds even with no profiler running, and no `with`, which costs a
third of a microsecond even around a no-op context. On, a span opens
torch.profiler.record_function("ovrfsr.<name>"), so it lands in the
profiler's trace on the kernels' clock, and appends a Record to a bounded
buffer. A cold span (`build`, `library`, and each built function's first
`launch`, which binds the entry point, moves the tables to the card and
loads the module) records whatever the switch: it happens once per build
and costs nothing per pair.

A Record holds the span's name, start_ns and end_ns (time.perf_counter_ns;
end_ns None while the span is open), the index in records() of its parent
(None at the top), the call id shared by every span under one top-level
span (one `process` call while a profiler runs), whether it was cold, and
info (a dict). A thread-local stack supplies the parent. Once the buffer
holds CAPACITY records, further spans are dropped and counted in `dropped`.

A launch that returned 0 puts in its record's info what the built
function published at its build (kernels/_common.py::kernel_fn): its name
(`fn`), the CUDA kernels its C entry point enqueued (`kernels`) and the
outputs the call computed inside the foveation circle and outside it
(`inside`, `outside`; the outside ones by the bilinear or copy pass).

Each counter counts at its boundary where its span records: `calls`
(Pipeline.process calls) and `launches` (C entry-point calls that returned
0) while a profiler runs, and `launches` on a first launch too; `builds`
(build-cache misses) always. `kernels`, `inside_outputs` and
`outside_outputs` add up the launch records' `kernels`, `inside` and
`outside` where `launches` counts. A counter that disagrees with the count
of its spans, or with the sum of their info, says records were dropped,
cleared or left open, or a launch failed.

To read them: run the program under torch.profiler, then read records()
and counters(); clear() empties both.
"""

import itertools
import threading
import time
from dataclasses import dataclass

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "bump", "count_launch", "records", "counters", "clear",
           "Record", "CAPACITY", "PREFIX"]

CAPACITY = 1 << 17     # records kept; past it spans are dropped and counted
PREFIX = "ovrfsr."     # the record_function names' prefix

_COUNTERS = ("calls", "builds", "launches", "kernels", "inside_outputs",
             "outside_outputs", "dropped")
_buf = []
_counts = dict.fromkeys(_COUNTERS, 0)
_lock = threading.Lock()
_local = threading.local()
_call_ids = itertools.count()


@dataclass(slots=True)
class Record:
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    call: int
    cold: bool
    info: dict


class _Span:
    __slots__ = ("record", "_rf")

    def __init__(self, name, cold):
        self.record = Record(name, 0, None, None, 0, cold, {})
        self._rf = None

    @property
    def info(self):
        return self.record.info

    def __enter__(self):
        rec = self.record
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(PREFIX + rec.name)
            self._rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            rec.parent, rec.call = stack[-1]
        else:
            rec.call = next(_call_ids)
        with _lock:
            if len(_buf) < CAPACITY:
                index = len(_buf)
                _buf.append(rec)
            else:
                index = None
                _counts["dropped"] += 1
        stack.append((index, rec.call))
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.record.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name, cold=False):
    """A context that records span `name` while a torch profiler runs, or
    always if `cold`; otherwise None."""
    if cold or _autograd_profiler._is_profiler_enabled:
        return _Span(name, cold)
    return None


def bump(counter):
    """Add one to `counter` (calls or builds; a launch: count_launch)."""
    with _lock:
        _counts[counter] += 1


def count_launch(info):
    """Count one launch that returned 0 (`launches`), with the CUDA kernels
    and the outputs by class that its `info` names (0 where it names
    none)."""
    with _lock:
        _counts["launches"] += 1
        _counts["kernels"] += info.get("kernels", 0)
        _counts["inside_outputs"] += info.get("inside", 0)
        _counts["outside_outputs"] += info.get("outside", 0)


def records():
    """The records in the order their spans opened (a copy of the list)."""
    with _lock:
        return list(_buf)


def counters():
    """{calls, builds, launches, kernels, inside_outputs, outside_outputs,
    dropped}: a copy."""
    with _lock:
        return dict(_counts)


def clear():
    """Empty the records and zero the counters."""
    with _lock:
        _buf.clear()
        _counts.update(dict.fromkeys(_COUNTERS, 0))
