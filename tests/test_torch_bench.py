"""The port's measurement entries on the CPU: openvr_fsr_tpu_torch.bench,
openvr_fsr_tpu_torch.tools.bench_paths and tools.throughput_bench (their
configs against the root bench.py, tools/bench_paths.py and
tools/throughput_bench.py, their refusal without a GPU, the keys of their
records and what each holds, from a stubbed measurement), the timing
helpers of utils/timing.py, and the DMA geometry Pipeline._build carries.
The entries themselves measure only on the card: `python3 chip_smoke.py`
runs them there.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu_torch import Config, Pipeline, bench  # noqa: E402
from openvr_fsr_tpu_torch.tools import bench_paths  # noqa: E402
from openvr_fsr_tpu_torch.tools import throughput_bench  # noqa: E402
from openvr_fsr_tpu_torch.utils.timing import (bench_fn,  # noqa: E402
                                               hbm_calibration, rotation_graph,
                                               rotation_ms, wall_ms)

REPO = Path(__file__).resolve().parent.parent


def test_paths_equal_the_jax_tool():
    """tools/bench_paths.py imports only numpy at module level."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_paths", REPO / "tools" / "bench_paths.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert bench_paths.PATHS == mod.PATHS


def test_metric_key_equals_the_root_bench():
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = {v.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
            for k, v in zip(node.keys, node.values)
            if isinstance(k, ast.Constant) and k.value == "metric"
            and isinstance(v, ast.Constant)}
    assert keys == {bench.METRIC}


def test_headline_config_equals_the_root_bench():
    src = (REPO / "bench.py").read_text()
    assert f"h_in, w_in = {bench.H_IN}, {bench.W_IN}" in src
    assert ("Config(enabled=True, render_scale=0.75, sharpness=0.9, "
            "radius=0.5)") in src
    assert bench.CONFIG == dict(render_scale=0.75, sharpness=0.9, radius=0.5)
    assert (bench.WARMUP, bench.ITERS, bench.ROUNDS) == (5, 40, 3)
    assert "run(5)" in src and "min(run(40) for _ in range(3))" in src


def test_throughput_config_equals_the_root_tool():
    src = (REPO / "tools" / "throughput_bench.py").read_text()
    assert f"h_in, w_in = {throughput_bench.H_IN}, {throughput_bench.W_IN}" \
        in src
    assert ("Config(enabled=True, render_scale=0.75, sharpness=0.9, "
            "radius=0.5)") in src
    assert throughput_bench.CONFIG == bench.CONFIG
    assert (throughput_bench.WARMUP, throughput_bench.ITERS,
            throughput_bench.ROUNDS) == (5, 20, 3)
    assert "run(5)" in src and "min(run(20) for _ in range(3))" in src
    assert '"fsr_batch%d_packed_pairs_per_s" % B' in src
    assert throughput_bench.metric(8) == "fsr_batch8_packed_pairs_per_s"


def test_throughput_stacks():
    """Three seeded stacks of packed texels, int32 views of numpy's uint32
    words, as the root tool's (:34-36)."""
    got = throughput_bench.stacks(4, 9, 13, "cpu")
    rng = np.random.default_rng(0)
    assert len(got) == 3
    for g in got:
        want = rng.integers(0, 2**32, (4, 9, 13), dtype=np.uint32)
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        assert np.array_equal(g.numpy().view(np.uint32), want)


@pytest.mark.parametrize("module,lines", [
    ("openvr_fsr_tpu_torch.bench", 1),
    ("openvr_fsr_tpu_torch.tools.bench_paths", len(bench_paths.PATHS)),
    ("openvr_fsr_tpu_torch.tools.throughput_bench", 1)])
def test_without_a_gpu_the_entry_fails(module, lines):
    """No CUDA GPU: a null value and an error per line, a non-zero exit,
    and jax never imported."""
    code = ("import runpy, sys\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "finally:\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'openvr_fsr_tpu'))\n"
            "    print('imported:', bad, file=sys.stderr)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode != 0, r.stdout + r.stderr
    assert "imported: []" in r.stderr, r.stderr
    out = [json.loads(line) for line in r.stdout.splitlines()]
    assert len(out) == lines
    for record in out:
        assert record["value"] is None and "no CUDA GPU" in record["error"]
    if module.endswith("throughput_bench"):
        assert out[0]["metric"] == throughput_bench.metric(8)
        assert out[0]["unit"] == "pairs/s"
    elif module.endswith("bench"):
        assert out[0]["metric"] == bench.METRIC
    else:
        assert [o["metric"] for o in out] == [
            bench_paths.metric(n) for n in bench_paths.PATHS]


def test_path_metrics():
    assert bench_paths.metric("fsr_fused") == "fsr_fused_stereo_2244x2492_ms"
    assert bench_paths.metric("fsr_supersample") == \
        "fsr_supersample_stereo_2917x3239_ms"
    assert bench_paths.metric("cas_sharpen") == \
        "cas_sharpen_stereo_2244x2492_ms"


def test_bench_paths_refuses_an_unknown_path():
    with pytest.raises(SystemExit):
        bench_paths.main(["--paths", "fsr_fused,nope"])


def test_ring_frames_are_int32_views_of_the_u32_ring():
    frames = bench.ring_frames(9, 13, (16, 128), "cpu")
    assert len(frames) == 3
    for f in frames:
        assert f.dtype == torch.int32 and f.shape == (2, 16, 128)
        assert not f[:, 9:].any() and not f[:, :, 13:].any()
    from openvr_fsr_tpu_torch.utils import frames as FR
    zone = np.stack([FR.zone_plate_frame(9, 13), FR.noise_frame(9, 13, 1)])
    want = zone.view(np.uint32)[..., 0]
    assert np.array_equal(frames[0][:, :9, :13].numpy().view(np.uint32),
                          want)


def test_bench_fn_returns_best_and_avg():
    x = torch.zeros(64)
    best, avg = bench_fn(torch.neg, x, warmup=1, iters=5)
    assert 0 < best <= avg


def test_rotation_ms_on_the_cpu():
    calls = []
    ms = rotation_ms(calls.append, [torch.zeros(1), torch.ones(1)], 4)
    assert ms > 0 and [float(c) for c in calls] == [0.0, 1.0, 0.0, 1.0]


def test_wall_ms_on_the_cpu():
    calls = []
    ms = wall_ms(calls.append, [torch.zeros(1), torch.ones(1)], 5)
    assert ms > 0 and [float(c) for c in calls] == [0.0, 1.0, 0.0, 1.0, 0.0]


def _stub_run(ms=0.25, device_ms=0.2, sol_ms=0.05):
    floor = types.SimpleNamespace(hbm_bytes=70_000_000, launches=3)
    return bench.PathRun(types.SimpleNamespace(launches=5), floor, ms,
                         device_ms, sol_ms, 1.5, 2244, 2492)


def test_path_run():
    run = _stub_run()
    assert run.vs_sol == 0.05 / 0.2           # device time over device time
    assert run.probe_effective_gbps == 70_000_000 / 1e9 / (0.05 / 1000.0)


def _stubbed(monkeypatch):
    """bench.measure, require_gpu and card stubbed: no card, no timing."""
    calls = []

    def measure(config, h, w, **kw):
        calls.append((config, h, w, kw))
        return _stub_run()

    monkeypatch.setattr(bench, "measure", measure)
    monkeypatch.setattr(bench, "require_gpu", lambda metrics: None)
    monkeypatch.setattr(bench, "card", lambda: "NVIDIA H100, 700.00 W")
    return calls


def test_bench_record(monkeypatch, capsys):
    """The headline line: value is the back-to-back time (the root's
    quantity), device_ms the graph time, vs_sol device over device."""
    calls = _stubbed(monkeypatch)
    record, run = bench.main()
    assert json.loads(capsys.readouterr().out) == record
    assert list(record) == ["metric", "value", "unit", "device_ms",
                            "vs_baseline", "sol_probe",
                            "probe_effective_gbps", "hbm_sol_ms", "vs_sol",
                            "device"]
    assert record["metric"] == bench.METRIC and record["unit"] == "ms"
    assert record["value"] == run.ms == 0.25
    assert record["device_ms"] == run.device_ms == 0.2
    assert record["vs_baseline"] == 1.0 / 0.25
    assert record["hbm_sol_ms"] == 0.05 and record["vs_sol"] == 0.05 / 0.2
    assert record["device"] == "NVIDIA H100, 700.00 W"
    (config, h, w, kw), = calls
    assert (h, w, kw) == (bench.H_IN, bench.W_IN, {})


def test_bench_paths_records(monkeypatch, capsys):
    calls = _stubbed(monkeypatch)
    results = bench_paths.main(["--paths", "fsr_fused,cas_sharpen",
                                "--iters", "7"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r for r, _ in results.values()] == lines
    for record in lines:
        assert record["value"] == 0.25 and record["device_ms"] == 0.2
        assert record["vs_sol"] == 0.05 / 0.2
        assert record["mpix_per_s"] == 2 * 2244 * 2492 / 1e6 / (0.25 / 1000)
    assert [kw for *_, kw in calls] == [{"iters": 7}] * 2


def test_rotation_graph_refuses_cpu_inputs():
    """A CUDA graph captures CUDA work only: on CPU inputs it raises before
    it calls anything."""
    calls = []
    with pytest.raises(ValueError, match="on the CPU"):
        rotation_graph(calls.append, [torch.zeros(1)], 4)
    assert calls == []


def test_hbm_calibration_smoke():
    read_bw, write_bw = hbm_calibration("cpu", read_shape=(1, 16, 128),
                                        write_shape=(1, 16, 128), n=2,
                                        rounds=1)
    assert read_bw > 0 and write_bw > 0


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kw", [
    dict(render_scale=0.75), dict(render_scale=1.3), dict(render_scale=1.0),
    dict(render_scale=0.75, use_nis=True),
    dict(render_scale=1.0, use_nis=True),
    dict(render_scale=0.75, use_cas=True),
    dict(render_scale=1.0, use_cas=True)])
def test_pipeline_build_carries_its_kernels_geometry(kw):
    pipe = Pipeline(Config(enabled=True, sharpness=0.9, radius=0.5, **kw),
                    device="cpu")
    for packed in (True, False):
        fn = pipe._build(2, 40, 52, (0, 1), packed)
        assert fn.dma_geometry is fn.kernel.dma_geometry
        assert fn.pad_to == fn.kernel.pad_to == (fn.dma_geometry["hp"],
                                                 fn.dma_geometry["wp"])
        _equal(fn.dma_geometry,
               pipe._build_kernel(2, 40, 52, (0, 1)).dma_geometry)
