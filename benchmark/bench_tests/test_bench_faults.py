"""`correct` on whole runs at the CPU's size: sound runs pass, and the
control and each fault a cell can have fail. The harness's look for a card
is skipped (run_cell is driven on the CPU's plain path); the card's own
runs are the `card` case."""

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH_DIR, ROOT

from fsrbench.harness import run_cell

CELLS = ["fsr_rs075_device", "nis_rs075_device", "fsr_rs075_paced90"]
RUNS = CELLS + ["fsr_rs075_stream90"]    # and the stream mix
SEED = 2**31 + 77


def _run(small_cell, spec, name, hook=None, precision=None, seconds=0.4):
    return run_cell(small_cell(name), SEED, seconds, False, spec=spec,
                    device=torch.device("cpu"), t_process=time.perf_counter(),
                    precision=precision, model_hook=hook)


LONGEST_S = 12.8     # the longest window _run_until tries


def _run_until(enough, small_cell, spec, name, hook=None):
    """_run with a window that doubles from 0.4 s until the run has made
    `enough(result)` of calls: a CPU shared with other test workers may
    complete too few in 0.4 s for a fault to reach a sampled output."""
    seconds = 0.4
    while True:
        r = _run(small_cell, spec, name, hook=hook, seconds=seconds)
        ok = enough(r)
        if ok or seconds >= LONGEST_S:
            assert ok, f"too few calls in {seconds} s: {r['info']}"
            return r
        seconds *= 2


def _altered(model):
    """An answer altered where it is produced: one texel of eye 1."""
    def call(x):
        out = model(x).clone()
        out[1, 40, 40] ^= 0x10
        return out
    return call


def _eye_left_out(model):
    """Half of the batch left out: eye 0's output stands for both."""
    def call(x):
        out = model(x)
        return torch.stack([out[0], out[0]])
    return call


def _stale(model):
    """Each call served the previous call's input: a state not advanced."""
    prev = []

    def call(x):
        prev.append(x.clone())
        return model(prev[-2] if len(prev) > 1 else prev[-1])
    return call


@pytest.mark.parametrize("name", RUNS)
def test_sound_run_is_correct(small_cell, spec, name):
    r = _run(small_cell, spec, name)
    assert r["correct"], r["checks"]
    assert r["checks"]["max_lsb"]["value"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", ["fsr_rs075_device", "nis_rs075_device"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_half_precision_is_not_correct(spec, name, seed):
    """The control, the program's bf16 path, fails the limit at 2 x 120x96
    -> 2 x 160x128 (at the cells' size it reads far higher: PERF.md)."""
    cell = spec.cell(name)
    cell.config = dict(cell.config, eye_in_wh=[120, 96], eye_out_wh=[160, 128])
    r = run_cell(cell, seed, 0.2, False, spec=spec, device=torch.device("cpu"),
                 t_process=time.perf_counter(), precision="half")
    assert not r["correct"]
    c = r["checks"]["max_lsb"]
    assert c["value"] > c["limit"]


INPUTS = 3       # every traffic mix's `inputs`


def _stale_reaches_a_sample(r):
    """A stale call serves the previous input from the second call on, and
    a window samples a call on some input and the last call on that input:
    past the first call once it has completed one call more than it has
    inputs."""
    return r["info"]["completed"] > INPUTS


@pytest.mark.parametrize("name", RUNS)
@pytest.mark.parametrize("fault", [_altered, _eye_left_out, _stale])
def test_fault_is_not_correct(small_cell, spec, name, fault):
    if fault is _stale:
        r = _run_until(_stale_reaches_a_sample, small_cell, spec, name,
                       hook=fault)
    else:
        r = _run(small_cell, spec, name, hook=fault)
    assert not r["correct"], r["checks"]


def test_stream_stale_eye_shows_in_tags(small_cell, spec, monkeypatch):
    """The serving loop corrupted: one pop of an eye leaves its pinned
    buffer as it was (the eye of two pairs before). The tags the kernel
    read catch it."""
    import openvr_fsr_tpu_torch.native_rt as nrt

    pops = [0]

    class LossyRing(nrt.FrameRing):
        def pop(self, shape, dtype=None, blocking=True, out=None):
            got = super().pop(shape, dtype, blocking, out=out.copy())
            if got is not None:
                pops[0] += 1
                if pops[0] != 41:
                    out[...] = got
            return None if got is None else out

    def enough(r):
        got, pops[0] = pops[0], 0      # the next window counts afresh
        return got > 41

    monkeypatch.setattr(nrt, "FrameRing", LossyRing)
    r = _run_until(enough, small_cell, spec, "fsr_rs075_stream90")
    assert r["checks"]["tag_errors"]["value"] > 0
    assert not r["correct"]


def test_run_refuses_without_a_card():
    """No CUDA GPU: exit 1 and no result line."""
    p = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"),
                        "--workload", "fsr_rs075_device", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=str(ROOT),
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/: exit != 0."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "fsr_rs075_device", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=str(tmp_path), env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert not p.stdout.strip().startswith("{")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    """One short run of the cell on the card, through run.py: correct, and
    the result line's keys."""
    p = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"),
                        "--workload", name, "--seed", str(SEED), "--seconds",
                        "2", "--trace", "0"], capture_output=True, text=True,
                       cwd=str(ROOT), timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
