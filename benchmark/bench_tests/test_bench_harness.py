"""The yardstick's arithmetic: the roofline's work, the percentiles and
failures, the windows under a stall, and cells found by name."""

import json
import math
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import BENCH_DIR

from fsrbench import load, work
from fsrbench.harness import _percentile_nearest
from fsrbench.spec import Spec
from fsrbench.trace import Tracer, summarize, union_length


def _config(family):
    return json.loads((BENCH_DIR / "configs" /
                       f"{family}_rs075_2244x2492.json").read_text())


@pytest.mark.parametrize("family,tile", [("fsr", (16, 16)), ("nis", (32, 24))])
def test_pair_work_at_the_cells_geometry(family, tile):
    config = _config(family)
    w = work.pair_work(config)
    assert w["bytes"] == 2 * 1683 * 1869 * 4 + 2 * 2244 * 2492 * 4 == 69900600
    assert w["inside"] + w["outside"] == 2 * 2244 * 2492
    # the circle test, tile by tile, in plain Python
    inside = 0
    centres = work.eye_centers(config)
    for cx, cy in centres:
        c = (int(np.float32(2244) * np.float32(cx)),
             int(np.float32(2492) * np.float32(cy)))
        r = np.float32(0.5) * np.float32(0.5) * np.float32(2492)
        r2 = int(r * r)
        for ty in range(math.ceil(2492 / tile[1])):
            for tx in range(math.ceil(2244 / tile[0])):
                gx, gy = tx * tile[0] + tile[0] // 2, ty * tile[1] + tile[1] // 2
                if (c[0] - gx) ** 2 + (c[1] - gy) ** 2 <= r2:
                    inside += (min(tile[0], 2244 - tx * tile[0])
                               * min(tile[1], 2492 - ty * tile[1]))
    assert w["inside"] == inside
    assert centres[0] != centres[1]
    ops = config["ops_per_output"]
    per_in = ops["inside"] + ops["per_input_inside"] * 1683 * 1869 / (2244 * 2492)
    assert w["ops"] == pytest.approx(inside * per_in
                                     + w["outside"] * ops["outside"])
    least, bound = work.least_ms(w)
    assert bound == "operations"
    assert least == pytest.approx(w["ops"] / 67e12 * 1e3)
    assert least > w["bytes"] / 3.35e12 * 1e3


def test_percentile_counts_every_pair_and_failures():
    lat = [1.0] * 94 + [2.0] * 5 + [3.0]
    assert _percentile_nearest(lat, 95) == 2.0
    assert _percentile_nearest(lat, 50) == 1.0
    # six dropped pairs: beyond every latency, so p95 lands on one
    dropped = lat[:94] + [math.inf] * 6
    assert _percentile_nearest(dropped, 95) == math.inf
    ctx = SimpleNamespace(window=load.Window(seconds=15.0, attempted=100,
                                             completed=94, failed=6,
                                             latencies_ms=dropped),
                          percentile=_percentile_nearest)
    spec = Spec()
    assert spec.reader("latency_p95_ms.paced")(ctx) == 15000.0
    four = lat[:96] + [math.inf] * 4
    ctx.window.latencies_ms = four
    assert spec.reader("latency_p95_ms.paced")(ctx) == 2.0


class _Stall:
    """A model that takes `each` seconds a call and stalls once, on call
    `at`."""

    def __init__(self, at, seconds, each=0.0):
        self.at, self.seconds, self.each, self.n = at, seconds, each, 0

    def __call__(self, x):
        self.n += 1
        time.sleep(self.seconds if self.n == self.at else self.each)
        return x


def _window(traffic, model, seconds=0.6):
    pairs = [torch.zeros((2, 4, 4), dtype=torch.int32) for _ in range(3)]
    return load.run_window(model, traffic, pairs, seconds,
                           np.random.default_rng(0), Tracer(False),
                           torch.device("cpu"))


def test_a_stall_moves_the_closed_rate():
    traffic = {"source": "device", "arrivals": "closed"}
    spec = Spec()
    rate = spec.reader("pairs_per_s")
    quick = _window(traffic, _Stall(0, 0, each=0.001))
    slow = _window(traffic, _Stall(5, 0.3, each=0.001))
    ctx = lambda w: SimpleNamespace(window=w, traffic=traffic)  # noqa: E731
    assert rate(ctx(slow)) < 0.6 * rate(ctx(quick))
    assert quick.completed == quick.attempted and quick.failed == 0


def test_a_stall_moves_the_paced_tail():
    traffic = {"source": "device", "arrivals": "paced", "rate_hz": 90}
    p95 = Spec().reader("latency_p95_ms.paced")
    ctx = lambda w: SimpleNamespace(window=w, percentile=_percentile_nearest)  # noqa: E731
    quick = _window(traffic, _Stall(0, 0), seconds=1.0)
    slow = _window(traffic, _Stall(3, 0.25), seconds=1.0)
    assert quick.attempted == slow.attempted == 90
    # every pair due while the stall lasts waits for it: more than 5%
    assert p95(ctx(slow)) > 100.0 > 20.0 > p95(ctx(quick))


def test_a_stall_moves_the_stream_and_drops_count():
    """A consumer stalled for 0.3 s at 90 pairs/s fills both 6-slot rings:
    the producer drops pairs, each a failure beyond every latency."""
    traffic = {"source": "host_rings", "arrivals": "paced", "rate_hz": 90,
               "ring_slots": 6}
    p95 = Spec().reader("latency_p95_ms.paced")
    srcs = [np.zeros((2, 8, 8), np.int32) for _ in range(3)]
    rig = load.StreamRig(srcs, 6, torch.device("cpu"))
    try:
        quick = load.run_window(_Stall(0, 0), traffic, rig, 1.0,
                                np.random.default_rng(0), Tracer(False),
                                torch.device("cpu"))
        slow = load.run_window(_Stall(10, 0.3), traffic, rig, 1.0,
                               np.random.default_rng(0), Tracer(False),
                               torch.device("cpu"))
    finally:
        rig.close()
    ctx = lambda w: SimpleNamespace(window=w, percentile=_percentile_nearest)  # noqa: E731
    assert quick.failed == 0 and quick.tag_errors == 0
    assert slow.failed > 0 and slow.tag_errors == 0
    assert slow.failed == sum(x == math.inf for x in slow.latencies_ms)
    assert p95(ctx(slow)) > 100.0 > p95(ctx(quick))


def test_trace_summary_idle_and_busy():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0.0, "dur": 1000.0, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "bench.sync",
           "ts": 500.0, "dur": 500.0, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 100.0, "dur": 200.0},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 250.0, "dur": 100.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 900.0,
           "dur": 300.0}]
    s = summarize(ev)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(350e-6)
    assert [k[0] for k in s.kernels] == ["k", "k"]
    assert s.device_ops == [["k", pytest.approx(300e-6)]]
    gaps = dict(s.idle_gaps)
    assert gaps["sync (1 gaps)"] == pytest.approx(550e-6)
    assert gaps["other (1 gaps)"] == pytest.approx(100e-6)
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4


def test_new_files_alone_are_found_by_name(tmp_path):
    """A configuration, a mix, a metric and a cell added as new files and a
    new BENCHMARK.json entry: found by name, no code changed."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR / "configs", bench / "configs")
    shutil.copytree(BENCH_DIR / "traffic", bench / "traffic")
    shutil.copytree(BENCH_DIR / "metrics", bench / "metrics")
    doc = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    cfg = dict(_config("fsr"), name="fsr_rs050_x", render_scale=0.5)
    (bench / "configs" / "fsr_rs050_x.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "paced_device_144.json").write_text(json.dumps(
        {"source": "device", "arrivals": "paced", "rate_hz": 144,
         "inputs": 3}))
    (bench / "metrics" / "late_share.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    doc["configs"].append({"name": "fsr_rs050_x", "source": "x",
                           "file": "benchmark/configs/fsr_rs050_x.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "fsr_rs050_paced144",
                             "config": "fsr_rs050_x",
                             "traffic": "paced_device_144", "chips": 1,
                             "why": "x"})
    next(m for m in doc["end_to_end"] if m["name"] == "upscale_gpu_ms")[
        "workloads"].append("fsr_rs050_paced144")
    doc["per_layer"].append({"name": "late_share", "unit": "%",
                             "better": "lower", "source": "host_clock",
                             "layer": "API", "moves": "upscale_gpu_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = Spec(tmp_path, bench)
    cell = spec.cell("fsr_rs050_paced144")
    assert cell.config["render_scale"] == 0.5
    assert cell.traffic["rate_hz"] == 144
    assert [m["name"] for m in cell.end_to_end] == ["upscale_gpu_ms",
                                                     "setup_s"]
    assert "late_share" in [m["name"] for m in cell.per_layer]
    # a metric without `workloads` is read in every cell reporting its moves
    assert "late_share" in [m["name"] for m in
                            spec.cell("fsr_rs075_paced90").per_layer]
    assert "late_share" not in [m["name"] for m in
                                spec.cell("fsr_rs075_device").per_layer]
    assert spec.reader("late_share")(None) == 42.0


def test_gpu_ms_is_the_busy_time_per_pair():
    """upscale_gpu_ms: the trace's busy time over the pairs completed;
    nothing without a trace or where nothing ran on the device."""
    read = Spec().reader("upscale_gpu_ms")
    win = load.Window(seconds=30.0, attempted=2700, completed=2700, failed=0)
    busy = SimpleNamespace(busy_s=0.41499, kernels=[])
    assert read(SimpleNamespace(window=win, trace=busy)) == \
        pytest.approx(0.41499e3 / 2700)
    assert read(SimpleNamespace(window=win, trace=None)) is None
    idle = SimpleNamespace(busy_s=0.0, kernels=[])
    assert read(SimpleNamespace(window=win, trace=idle)) is None


@pytest.mark.parametrize("name,traced", [("fsr_rs075_paced90", True),
                                         ("fsr_rs075_device", False)])
def test_untraced_run_traces_for_a_device_metric(small_cell, spec,
                                                 monkeypatch, name, traced):
    """A cell whose end-to-end metrics read the device trace runs its
    window under the profiler with --trace 0 as well; its line keeps the
    untraced form (no busy_s, no breakdown)."""
    from fsrbench import harness

    made = []

    class Recording(Tracer):
        def __init__(self, enabled, cuda=True):
            super().__init__(enabled, cuda)
            made.append(self.enabled)

    monkeypatch.setattr(harness, "Tracer", Recording)
    r = harness.run_cell(small_cell(name), 2**31 + 5, 0.3, False, spec=spec,
                         device=torch.device("cpu"),
                         t_process=time.perf_counter())
    assert made[-1] is traced
    assert r["correct"], r["checks"]
    assert "busy_s" not in r["device"] and "breakdown" not in r
    assert "setup_s" in r["metrics"]
