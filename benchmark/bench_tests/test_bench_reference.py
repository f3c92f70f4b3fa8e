"""The frozen reference against the port's oracle and CPU path, and the
imports of the harness and the reference."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "openvr_fsr_tpu"}


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=str(ROOT), check=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT}:{BENCH_DIR}"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax(spec):
    code = ("import run, control\n"
            "from fsrbench import harness, judge, load, trace, work, spec\n"
            "from fsrbench.spec import Spec\n"
            "s = Spec()\n"
            "[s.reader(m['name']) for k in ('end_to_end', 'per_layer') "
            "for m in s.doc[k]]\n"
            "import openvr_fsr_tpu_torch.models.families, "
            "openvr_fsr_tpu_torch.native_rt")
    top = _loaded(code)
    assert "openvr_fsr_tpu_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_reference_imports_numpy_only():
    top = _loaded("from fsrbench.reference import pipeline_oracle\n"
                  "import fsrbench.ref_worker")
    assert not top & (FORBIDDEN | {"torch", "openvr_fsr_tpu_torch"})


def test_forbidden_names_are_whole(monkeypatch):
    sys.path.insert(0, str(BENCH_DIR))
    import run
    monkeypatch.setitem(sys.modules, "openvr_fsr_tpu_torch_x", object())
    assert "openvr_fsr_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "openvr_fsr_tpu.api", object())
    assert run.forbidden_modules() == ["openvr_fsr_tpu"]


@pytest.mark.parametrize("family", ["fsr", "nis"])
@pytest.mark.parametrize("radius", [0.5, 0.2])
def test_reference_equals_port(family, radius):
    """Bit for bit at 2 x 63x54 -> 2 x 84x72, off-centre eyes: the frozen
    oracle, the port's oracle, and the port's CPU path (packed pairs)."""
    from fsrbench import inputs, judge
    from fsrbench.reference import pipeline_oracle as frozen
    from openvr_fsr_tpu_torch import Pipeline, Config
    from openvr_fsr_tpu_torch.oracle.pipeline import pipeline_oracle as port

    config = json.loads((BENCH_DIR / "configs" /
                         f"{family}_rs075_2244x2492.json").read_text())
    config = dict(config, eye_in_wh=[63, 54], eye_out_wh=[84, 72],
                  radius=radius)
    pair = inputs.make_pairs(7, 1, 63, 54, torch.device("cpu"))[0]
    texels = pair.numpy().view(np.uint8).reshape(2, 54, 63, 4)
    pipe = Pipeline(Config(enabled=True, render_scale=0.75, sharpness=0.9,
                           radius=radius, use_nis=family == "nis"),
                    eye_centers=judge.oracle_kwargs(config, 0)["eye_centers"],
                    device="cpu")
    got = pipe.process(pair).numpy().view(np.uint8).reshape(2, 72, 84, 4)
    for eye in (0, 1):
        kw = judge.oracle_kwargs(config, eye)
        a = frozen(texels[eye], **kw)
        np.testing.assert_array_equal(a, port(texels[eye], **kw))
        np.testing.assert_array_equal(a, got[eye])
    ref = judge.reference_pair(pair.numpy(), config)
    np.testing.assert_array_equal(ref, got)

