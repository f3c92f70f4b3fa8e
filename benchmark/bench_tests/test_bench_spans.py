"""The readers of the program's spans (metrics/api_self_ms.py,
api_self_ms.paced.py, launch_ms.paced.py, build_s.py) on synthetic records,
and traced runs of each cell on the CPU at its small size."""

import sys
import time

import pytest
import torch

from fsrbench.harness import run_cell

from openvr_fsr_tpu_torch.utils import trace
from openvr_fsr_tpu_torch.utils.trace import Record

READERS = ["api_self_ms", "api_self_ms.paced", "launch_ms.paced", "build_s"]
MS = 1_000_000          # ns
SEED = 2**31 + 91


def _rec(name, t0, t1, parent=None, call=0, cold=False):
    return Record(name, t0, t1, parent, call, cold, {})


def _window():
    """Set-up: a build, then a first launch holding its library's load;
    then two calls, the first with a launch and a build inside it, the
    second with a launch."""
    return [
        _rec("build", 0, 400 * MS, cold=True, call=0),
        _rec("launch", 500 * MS, 900 * MS, cold=True, call=1),
        _rec("library", 550 * MS, 850 * MS, parent=1, cold=True, call=1),
        _rec("process", 1000 * MS, 1010 * MS, call=2),
        _rec("launch", 1002 * MS, 1006 * MS, parent=3, call=2),
        _rec("build", 1006 * MS, 1007 * MS, parent=3, cold=True, call=2),
        _rec("process", 1100 * MS, 1103 * MS, call=3),
        _rec("launch", 1100 * MS, 1102 * MS, parent=6, call=3),
    ]


def _counts(recs, **over):
    n = {"calls": sum(r.name == "process" for r in recs),
         "builds": sum(r.name == "build" for r in recs),
         "launches": sum(r.name == "launch" for r in recs), "dropped": 0}
    n.update(over)
    return n


@pytest.fixture
def records(monkeypatch):
    """Serve `recs` and `counts` to the readers."""
    def serve(recs, counts=None):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "counters",
                            lambda: dict(counts or _counts(recs)))
    return serve


def test_self_time_subtracts_only_nested_launches(spec, records):
    records(_window())
    # 10 ms less its 4-ms launch (the build inside stays), 3 ms less 2
    for name in ("api_self_ms", "api_self_ms.paced"):
        assert spec.reader(name)(None) == pytest.approx((6 + 1) / 2)
    assert spec.reader("launch_ms.paced")(None) == pytest.approx((4 + 2) / 2)


def test_build_seconds_count_nested_time_once(spec, records):
    records(_window())
    # 0.4 s of build, 0.4 s of first launch (its library inside), 1 ms of
    # build inside a call
    assert spec.reader("build_s")(None) == pytest.approx(0.801)


def test_no_launch_no_launch_metric(spec, records):
    """The CPU's plain path launches nothing: launch_ms.paced is absent,
    and the self time is the whole call."""
    records([_rec("process", 0, 2 * MS, call=0),
             _rec("build", MS // 2, MS, parent=0, cold=True, call=0)])
    assert spec.reader("launch_ms.paced")(None) is None
    assert spec.reader("api_self_ms")(None) == pytest.approx(2.0)
    assert spec.reader("build_s")(None) == pytest.approx(0.0005)


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("fault", ["empty", "dropped", "calls", "builds",
                                   "launches", "open"])
def test_none_on_unsound_records(spec, records, reader, fault):
    recs = _window()
    counts = _counts(recs)
    if fault == "empty":
        recs = []
        counts = _counts(recs)
    elif fault == "dropped":
        counts["dropped"] = 1
    elif fault == "open":
        recs[6].end_ns = None
    else:
        counts[fault] += 1
    records(recs, counts)
    assert spec.reader(reader)(None) is None


@pytest.mark.parametrize("reader", READERS)
def test_none_without_the_program_spans(spec, monkeypatch, reader):
    """A program without utils/trace.py (an earlier version of the port):
    the import fails, the reader returns None and does not raise."""
    monkeypatch.setitem(sys.modules, "openvr_fsr_tpu_torch.utils.trace", None)
    monkeypatch.delattr(sys.modules["openvr_fsr_tpu_torch.utils"], "trace")
    assert spec.reader(reader)(None) is None


CELL_METRICS = {"fsr_rs075_device": "api_self_ms",
                "nis_rs075_device": "api_self_ms",
                "fsr_rs075_paced90": "api_self_ms.paced"}


@pytest.mark.parametrize("name", sorted(CELL_METRICS))
def test_traced_cpu_run_reports_the_spans(small_cell, spec, name):
    trace.clear()
    t_process = time.perf_counter()
    r = run_cell(small_cell(name), SEED, 0.4, True, spec=spec,
                 device=torch.device("cpu"), t_process=t_process)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"], r["checks"]
    assert CELL_METRICS[name] in m and "build_s" in m
    assert "launch_ms.paced" not in m          # the CPU launches nothing
    # the run's cold spans lie inside its set-up
    assert 0 < m["build_s"] < time.perf_counter() - t_process
    assert m[CELL_METRICS[name]] > 0
    if name == "fsr_rs075_paced90":
        assert m["api_self_ms.paced"] <= m["api_enqueue_ms"]
    n = trace.counters()
    assert n["builds"] == 1 and n["dropped"] == 0
    assert n["calls"] == sum(x.name == "process" for x in trace.records())
    trace.clear()
