"""The port's interactive demo (openvr_fsr_tpu_torch/tools/demo.py) scripted
on the CPU, as tests/test_demo.py drives the JAX one: toggles,
sharpness/radius nudges, the deferred capture and a clean exit; its
captured NPY within tests/test_torch_pipeline.py's bar of the JAX demo's
capture from the same script."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from openvr_fsr_tpu_torch.tools import demo
from test_torch_pipeline import _assert_close

REPO = Path(__file__).resolve().parent.parent
SCRIPT = ["--frames", "8", "--keys", "d+]c", "--size", "96x80"]


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_demo", REPO / "tools" / "demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(directory):
    caps = sorted(directory.glob("capture_*_fsr_s95_r55.*"))
    assert [p.suffix for p in caps] == [".dds", ".npy"], caps
    return np.load(caps[1])


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_demo")
    pipe = demo.main(SCRIPT + ["--out", str(out), "--device", "cpu"])
    return out, pipe


def test_demo_scripted_run(port_run, tmp_path, capsys):
    pipe = demo.main(SCRIPT + ["--out", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sharpness=0.95" in out        # '+' nudge applied
    assert "radius=0.55" in out           # ']' nudge applied
    assert "debug=False" in out           # 'd' toggled the demo's debug off
    assert "captured:" in out             # 'c' captured on the NEXT frame
    assert out.strip().splitlines()[-1].startswith("8 frames in ")
    assert pipe.device.type == "cpu"
    assert _capture(tmp_path).shape == (103, 124, 4)   # (OH, OW, 4)


def test_demo_defaults_to_the_card(monkeypatch, tmp_path):
    """No --device: the current CUDA device, which raises without a GPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        demo.main(SCRIPT + ["--out", str(tmp_path)])


def test_capture_matches_the_jax_demo(port_run, tmp_path, monkeypatch):
    out, _ = port_run
    jax_demo = _jax_demo()
    monkeypatch.setattr(sys, "argv",
                        ["demo.py", *SCRIPT, "--out", str(tmp_path)])
    jax_demo.main()
    _assert_close(_capture(out), _capture(tmp_path))


def test_demo_reads_a_dds_input(port_run, tmp_path, capsys):
    """--input: the port's DDS reader feeds the same frame."""
    out, _ = port_run
    dds = sorted(out.glob("capture_*.dds"))[0]
    demo.main(["--frames", "2", "--input", str(dds), "--render-scale", "1.0",
               "--out", str(tmp_path), "--device", "cpu"])
    assert "input 124x103 -> (124, 103)" in capsys.readouterr().out
