"""The port's stream tool (openvr_fsr_tpu_torch/tools/stream_bench.py) on the
CPU at 96x80 per eye: producer, native rings (one per eye, and the JAX
tool's one ring of stereo slots), uploader and consumer with the plain
versions, paced, unpaced and device-resident; every popped pair processed,
tags in push order and both eyes of one pair, outputs equal to
Pipeline.process of the same frame, the JAX tool's row keys, the pass rule,
and no file written without --out."""

import ast
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openvr_fsr_tpu_torch import Config, Pipeline
from openvr_fsr_tpu_torch.tools import stream_bench as SB

REPO = Path(__file__).resolve().parent.parent
W, H = 96, 80
SECONDS = 0.4


def _jax_row_keys():
    """The keys of the row the JAX tool writes (tools/stream_bench.py)."""
    tree = ast.parse((REPO / "tools" / "stream_bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "row" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no row dict in tools/stream_bench.py")


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    """A few calls for the device-only leg (the plain version's rate on
    the CPU is not a number the tests read), and one torch thread: the
    tool's three threads all call torch, and intra-op pools that spin
    against the other test workers slow the plain version tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(SB, "DEVICE_WARMUP", 1)
            mp.setattr(SB, "DEVICE_ITERS", 2)
            mp.setattr(SB, "DEVICE_ROUNDS", 1)
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rows():
    """The tool's rows on the CPU: unpaced with paced beside it, and
    device-resident unpaced."""
    return {"pixels": SB.measure(W, H, seconds=SECONDS, device="cpu",
                                 log=lambda *a: None)[0],
            "resident": SB.measure(W, H, seconds=SECONDS, fps=0,
                                   device_resident=True, device="cpu",
                                   log=lambda *a: None)[0]}


@pytest.mark.parametrize("name,leg", [("pixels", "unpaced"),
                                      ("pixels", "paced"),
                                      ("pixels", "one_ring"),
                                      ("resident", "unpaced")])
def test_every_popped_frame_processed_in_order(rows, name, leg):
    r = rows[name][leg]
    assert r["rings"] == (1 if name == "resident" or leg == "one_ring"
                          else 2)
    assert r["pairs_processed"] > SB.SAMPLE_AT
    assert r["pairs_processed"] + r["pairs_drained"] == r["ring_popped"]
    assert r["ring_popped"] <= r["ring_pushed"]
    assert r["tags_in_order"] and r["sample_equal"]
    assert r["sample_tag"] is not None
    if leg == "unpaced":
        assert r["ring_dropped"] == 0


def test_row_keys_are_a_superset_of_the_jax_rows(rows):
    keys = _jax_row_keys()
    assert "stream_sustained_stereo_pairs_per_s_2244x2492" == SB.METRIC
    for row in rows.values():
        assert keys <= set(row), keys - set(row)
        assert row["metric"] == SB.METRIC and row["device"] == "cpu"
        assert row["value"] == row["unpaced"]["pairs_per_s"]
        assert row["upload_gbs_this_session"] is None     # no device leg
        assert row["session_hbm_read_gbs"] is None
    assert rows["pixels"]["paced"]["fps"] == SB.TARGET_FPS
    assert rows["pixels"]["paced"]["frame_budget_ms"] == 1000.0 / 90.0
    assert rows["resident"]["paced"] is None
    assert rows["resident"]["one_ring"] is None
    assert rows["resident"]["ring_slot_bytes"] == 16
    hp, wp = Pipeline(Config(enabled=True, render_scale=0.75),
                      device="cpu")._build(2, H, W, (0, 1), True).pad_to
    assert rows["pixels"]["ring_slot_bytes"] == hp * wp * 4    # one eye


def _recording_run(pipe, seen):
    run = pipe._build(2, H, W, (0, 1), packed=True)

    def rec(x):
        out = run(x)
        eye0, eye1 = x[:, 0, 0].tolist()
        assert eye0 == eye1             # both eyes of one pair
        seen.append((eye0, out))
        return out

    rec.pad_to, rec.kernel = run.pad_to, run.kernel
    return rec


@pytest.mark.parametrize("fps,rings", [(0.0, 2), (90.0, 2), (0.0, 1)])
def test_outputs_equal_pipeline_process(fps, rings):
    """Each processed frame's output equals Pipeline.process of the frame
    with that tag, unpadded: the tags come in push order (from 0 with no
    gaps when unpaced)."""
    pipe = Pipeline(Config(enabled=True, render_scale=0.75, sharpness=0.9,
                           radius=0.5), device="cpu")
    seen = []
    run = _recording_run(pipe, seen)
    srcs = SB.ring_sources(H, W, run.pad_to)
    dev = [torch.from_numpy(x) for x in srcs]
    leg = SB.stream_run(run, srcs, dev, device=torch.device("cpu"), fps=fps,
                        seconds=SECONDS, rings=rings)
    assert leg["rings"] == rings
    tags = [t for t, _ in seen[:-1]]     # the last call: the sample check
    assert len(tags) == leg["pairs_processed"] + leg["pairs_drained"]
    if not fps:
        assert tags == list(range(len(tags)))
    assert tags == sorted(set(tags))
    for tag, out in seen[:3] + seen[-3:-1]:
        frame = SB.tagged(srcs, tag)[:, :H, :W]
        want = pipe.process(np.ascontiguousarray(frame), eyes=(0, 1))
        assert torch.equal(out, want), tag


def _fake_legs(unpaced, paced):
    def stream_run(run, srcs, dev_srcs, *, fps, rings, **kw):
        rate = paced if fps else unpaced if rings == 2 else 1.0
        return {"pairs_per_s": rate, "seconds": 1.0, "rings": rings,
                "pairs_processed": 1, "pairs_drained": 0, "ring_pushed": 1,
                "ring_popped": 1,
                "ring_dropped": 0, "p50_ms_per_pair": 1.0,
                "p99_ms_per_pair": 1.0, "max_ms_per_pair": 1.0,
                "uploader_busy_share": 0.5, "upload_copy_ms_mean": None,
                "tags_in_order": True, "sample_tag": 3, "sample_equal": True}
    return stream_run


@pytest.mark.parametrize("unpaced,paced,verdict", [
    (90.0, 10.0, "pass"),                  # the target, no tolerance
    (89.99, 95.0, "device_bound"),         # the paced run is not gated
    (88.3, 88.3, "device_bound"),          # STREAM_r05.json's passing value
])
def test_pass_is_the_unpaced_run_without_tolerance(monkeypatch, unpaced,
                                                   paced, verdict):
    monkeypatch.setattr(SB, "stream_run", _fake_legs(unpaced, paced))
    row, _ = SB.measure(W, H, device="cpu", log=lambda *a: None)
    assert row["value"] == unpaced and row["verdict"] == verdict
    assert row["paced"]["pairs_per_s"] == paced


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_writes_only_to_out(tmp_path, monkeypatch, capsys):
    record = REPO / "STREAM_r05.json"
    before = _digest(record)
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--size", f"{W}x{H}", "--seconds", "0.2",
            "--fps", "0"]
    row = SB.main(argv)
    assert list(tmp_path.iterdir()) == []
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed)["verdict"] == row["verdict"]
    out = tmp_path / "stream.json"
    row = SB.main(argv + ["--out", str(out)])
    assert [p.name for p in tmp_path.iterdir()] == ["stream.json"]
    assert json.loads(out.read_text())["metric"] == SB.METRIC
    assert _digest(record) == before
