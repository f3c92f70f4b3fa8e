"""bench_fn's trace option (openvr_fsr_tpu_torch/utils/timing.py), the
counterpart of the JAX bench_fn's profile_dir (openvr_fsr_tpu/utils/
timing.py:56-68): on a CPU tensor one Chrome trace of the timed calls
(CPU activity only) appears in profile_dir, and (best_ms, avg_ms) keeps
its contract."""

import json

import pytest
import torch

from openvr_fsr_tpu_torch.utils.timing import bench_fn, kernel_events


@pytest.mark.parametrize("traced", [False, True])
def test_bench_fn_contract(traced, tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return torch.neg(x)

    profile_dir = tmp_path / "trace" if traced else None
    best, avg = bench_fn(fn, torch.zeros(4096), warmup=2, iters=5,
                         profile_dir=profile_dir)
    assert len(calls) == 7
    assert 0 < best <= avg
    if not traced:
        assert not (tmp_path / "trace").exists()
        return
    traces = list(profile_dir.iterdir())
    assert len(traces) == 1 and traces[0].name.startswith("bench_fn_")
    events = json.loads(traces[0].read_text())["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert sum(e["name"] == "aten::neg" for e in ops) == 5   # the timed calls
    assert kernel_events(traces[0]) == []      # no CUDA activity on the CPU


def test_kernel_events_reads_kernel_category(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "void fsr_inside_kernel<Rgba8>()",
         "dur": 12.5},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 3.0},
        {"cat": "kernel", "name": "void fsr_outside_kernel<Rgba8>()"},
        {"ph": "M", "name": "process_name"}]}))
    assert kernel_events(p) == [("void fsr_inside_kernel<Rgba8>()", 12.5),
                                ("void fsr_outside_kernel<Rgba8>()", 0.0)]
