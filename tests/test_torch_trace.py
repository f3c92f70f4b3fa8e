"""The port's spans and counters (openvr_fsr_tpu_torch/utils/trace.py), on
the CPU: off (no profiler running) Pipeline.process records no hot span and
never calls record_function, while builds, library loads and each built
function's first launch record as cold spans; under torch.profiler every
span records with its parent and call id, the counters agree with the
spans, and the profiler's Chrome trace holds the ovrfsr.* annotations.
The launch span's CUDA branch runs here on a tensor that reports a CUDA
device and a stand-in for the C entry point."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openvr_fsr_tpu_torch import Config, Pipeline
from openvr_fsr_tpu_torch.kernels import _build
from openvr_fsr_tpu_torch.kernels._common import kernel_fn
from openvr_fsr_tpu_torch.utils import trace

PLANS = {"fsr": dict(render_scale=0.75), "fsr_rs1": dict(render_scale=1.0),
         "nis": dict(render_scale=0.75, use_nis=True),
         "cas": dict(render_scale=1.0, use_cas=True)}


@pytest.fixture(autouse=True)
def _clear():
    trace.clear()
    yield
    trace.clear()


def _pipe(plan="fsr"):
    return Pipeline(Config(enabled=True, **PLANS[plan]), device="cpu")


def _frames(h=24, w=20, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31, (2, h, w),
                                         dtype=np.int64).astype(np.int32))


def _names(recs):
    return [r.name for r in recs]


def _no_record_function(*a, **k):
    raise AssertionError("record_function called with no profiler running")


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_off_process_records_no_hot_span(plan, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function",
                        _no_record_function)
    pipe, x = _pipe(plan), _frames()
    for _ in range(3):
        pipe.process(x)
    assert _names(trace.records()) == ["build"]
    assert trace.counters() == {"calls": 0, "builds": 1, "launches": 0,
                                "kernels": 0, "inside_outputs": 0,
                                "outside_outputs": 0, "dropped": 0}
    assert trace.span("process") is None and trace.span("launch") is None


def test_cold_build_spans_once_per_key_and_after_reset():
    pipe = _pipe()
    x, y = _frames(), _frames(16, 20)
    pipe.process(x)
    pipe.process(x)                 # a cache hit: no span
    assert _names(trace.records()) == ["build"]
    pipe.process(y)                 # another key
    pipe.process(x)
    assert _names(trace.records()) == ["build", "build"]
    pipe.reset()
    pipe.process(x)
    recs = trace.records()
    assert _names(recs) == ["build"] * 3
    assert all(r.cold and r.parent is None and r.end_ns > r.start_ns
               for r in recs)
    assert len({r.call for r in recs}) == 3
    assert trace.counters()["builds"] == 3


@pytest.mark.parametrize("plan", ["fsr", "nis"])
def test_profiled_process_spans_carry_call_ids_and_parents(plan, tmp_path):
    pipe, x = _pipe(plan), _frames()
    pipe.process(x)                 # built before the profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the switch, torch's flag, agrees with the profiler's own state
        assert torch.autograd.profiler._is_profiler_enabled
        assert torch._C._autograd._profiler_enabled()
        pipe.process(x)
        pipe.process(x)
        pipe.reset()
        pipe.process(x)             # a build inside the call
    assert not torch.autograd.profiler._is_profiler_enabled
    pipe.process(x)                 # off again: nothing more
    recs = trace.records()
    assert _names(recs) == ["build", "process", "process", "process",
                            "build"]
    first, p1, p2, p3, inner = recs
    assert first.parent is None and first.cold
    assert [p.parent for p in (p1, p2, p3)] == [None] * 3
    assert not any(p.cold for p in (p1, p2, p3))
    assert len({first.call, p1.call, p2.call, p3.call}) == 4
    assert inner.parent == 3 and inner.call == p3.call and inner.cold
    assert p3.start_ns < inner.start_ns < inner.end_ns < p3.end_ns
    assert p1.end_ns <= p2.start_ns
    counts = trace.counters()
    assert counts == {"calls": 3, "builds": 2, "launches": 0, "kernels": 0,
                      "inside_outputs": 0, "outside_outputs": 0,
                      "dropped": 0}
    assert counts["calls"] == _names(recs).count("process")
    assert counts["builds"] == _names(recs).count("build")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(trace.PREFIX)]
    assert sorted(e["name"] for e in spans) == (["ovrfsr.build"]
                                                + ["ovrfsr.process"] * 3)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: kernel_fn takes its launch
    branch, whose C entry point the test stands in for."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _launching_fn(monkeypatch, errors=()):
    """kernel_fn over a stand-in launch returning (out, cudaError), the
    error of call i being errors[i] (0 past the end)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    calls = []

    def launch(img):
        calls.append(1)
        err = errors[len(calls) - 1] if len(calls) <= len(errors) else 0
        return torch.neg(img.as_subclass(torch.Tensor)), err

    fn = kernel_fn("stand-in", 2, (4, 4), (4, 8), lambda img: img, launch)
    img = torch.Tensor._make_subclass(
        _FakeCuda, torch.ones((2, 4, 4), dtype=torch.int32))
    return fn, img


def test_first_launch_is_cold_and_later_ones_are_hot(monkeypatch):
    fn, img = _launching_fn(monkeypatch)
    monkeypatch.setattr(torch.profiler, "record_function",
                        _no_record_function)
    for _ in range(3):
        assert int(fn(img)[0, 0, 0]) == -1
    assert fn.launches == 3
    recs = trace.records()
    assert _names(recs) == ["launch"] and recs[0].cold
    assert trace.counters()["launches"] == 1
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("process"):       # a stand-in for the API call
            fn(img)
            fn(img)
    recs = trace.records()
    assert _names(recs) == ["launch", "process", "launch", "launch"]
    assert [r.parent for r in recs[2:]] == [1, 1]
    assert not any(r.cold for r in recs[1:])
    assert {r.call for r in recs[1:]} == {recs[1].call}
    assert trace.counters()["launches"] == 3 == fn.launches - 2


def test_a_failed_launch_records_its_span_but_no_launch(monkeypatch):
    fn, img = _launching_fn(monkeypatch, errors=(0, 700))
    fn(img)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="cudaError 700"):
            fn(img)
    assert _names(trace.records()) == ["launch", "launch"]
    assert trace.counters()["launches"] == 1 == fn.launches


@pytest.mark.parametrize("built", [["fsr_fused"], []])
def test_library_span_says_whether_nvcc_ran(built, monkeypatch, tmp_path):
    so = tmp_path / "libx.so"
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "library_path", lambda name: so)
    monkeypatch.setattr(_build, "build", lambda names: list(built))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    assert _build.load_library("fsr_fused") == ("lib", str(so))
    assert _build.load_library("fsr_fused") == ("lib", str(so))   # cached
    recs = trace.records()
    assert _names(recs) == ["library"] and recs[0].cold
    assert recs[0].info == {"built": bool(built)}


def test_bounded_buffer_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    with trace.span("build", cold=True):
        for _ in range(4):
            with trace.span("library", cold=True):
                pass
    recs = trace.records()
    assert _names(recs) == ["build", "library", "library"]
    assert [r.parent for r in recs] == [None, 0, 0]
    assert trace.counters()["dropped"] == 2
    trace.clear()
    assert trace.records() == []
    assert trace.counters() == dict.fromkeys(
        ("calls", "builds", "launches", "kernels", "inside_outputs",
         "outside_outputs", "dropped"), 0)
    with trace.span("build", cold=True):
        pass
    assert _names(trace.records()) == ["build"]
    assert trace.records()[0].parent is None


def test_threads_keep_their_own_parents():
    ready, done = threading.Event(), threading.Event()

    def other():
        ready.wait()
        with trace.span("library", cold=True):
            pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with trace.span("build", cold=True):
        ready.set()
        done.wait()
    t.join()
    build, library = trace.records()
    assert library.parent is None and library.call != build.call


def test_threads_lose_no_record_or_count():
    """16 threads nesting spans and bumping counters with the interpreter
    switching threads every microsecond: every record is kept once, every
    parent lies in its own thread's call, and no count is lost."""
    n_threads, n_calls = 16, 200
    errors = []

    def work():
        try:
            for _ in range(n_calls):
                with trace.span("build", cold=True):
                    trace.bump("builds")
                    with trace.span("library", cold=True):
                        pass
        except Exception as e:          # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    recs = trace.records()
    assert len(recs) == 2 * n_threads * n_calls
    assert trace.counters()["builds"] == n_threads * n_calls
    assert len({r.call for r in recs}) == n_threads * n_calls
    for r in recs:
        if r.name == "library":
            parent = recs[r.parent]
            assert parent.name == "build" and parent.call == r.call
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        else:
            assert r.parent is None
