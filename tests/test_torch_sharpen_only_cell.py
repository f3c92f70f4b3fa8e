"""The benchmark's sharpen-only deployment (benchmark/configs/
fsr_rs100_r20_2244x2492.json: FSR1 at renderScale 1, RCAS alone) on the
CPU at 2 x 84x72 with off-centre eyes: the port's path on the benchmark's
packed input pairs equals, bit for bit, the benchmark's frozen reference
(the judge of the cell fsr_rs100_r20_device) and the port's oracle, at
radius 2.0 (every output inside the circle) and at 0.5 (both classes).
Also: the configuration loads by name and the cell resolves with its
metrics."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from fsrbench import inputs as IN  # noqa: E402
from fsrbench import judge, work  # noqa: E402
from fsrbench.reference import pipeline_oracle as frozen_oracle  # noqa: E402
from fsrbench.spec import Spec  # noqa: E402

from openvr_fsr_tpu_torch import Config, Pipeline  # noqa: E402
from openvr_fsr_tpu_torch.oracle.pipeline import (  # noqa: E402
    pipeline_oracle as port_oracle)

CONFIG = "fsr_rs100_r20_2244x2492"
CELL = "fsr_rs100_r20_device"
W, H = 84, 72
# each eye's projection centre well off the middle: the left eye's up and
# to the left, the right eye's down and to the right
RAW = {"left": [-1.9, 0.7, -0.9, 1.7], "right": [-0.8, 1.6, -1.5, 0.8]}
SEEDS = [2**31 + 17, 3_100_000_555, 7]


def _config(radius):
    """The deployment at the CPU's size, its eyes off-centre."""
    return dict(Spec().config(CONFIG), eye_in_wh=[W, H], eye_out_wh=[W, H],
                eye_projection_raw=RAW, radius=radius)


def _port(config, pair):
    """The port's path, as the cell runs it: Pipeline.process on a packed
    (2, H, W) int32 pair, on the CPU's plain path."""
    cfg = Config(enabled=True, render_scale=config["render_scale"],
                 sharpness=config["sharpness"], radius=config["radius"])
    pipe = Pipeline(cfg, eye_centers=work.eye_centers(config),
                    color_bits=config["color_bits"], device="cpu")
    return pipe.process(pair).numpy()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("radius", [2.0, 0.5])
def test_port_equals_both_references(radius, seed):
    config = _config(radius)
    pair = IN.make_pairs(seed, 1, W, H, torch.device("cpu"))[0]
    out = _port(config, pair)
    masks = work.inside_masks(config)
    inside = sum(int(m.sum()) for m in masks)
    if radius == 2.0:
        assert inside == 2 * W * H
    else:
        assert 0 < inside < 2 * W * H
    frozen = judge.reference_pair(pair.numpy(), config)
    r = judge.compare(out, frozen, masks)
    assert r["max_lsb"] == 0 and r["unequal_texels"] == 0, r
    texels = pair.numpy().view(np.uint8).reshape(2, H, W, 4)
    for eye in (0, 1):
        kw = judge.oracle_kwargs(config, eye)
        ours = port_oracle(texels[eye], **kw)
        np.testing.assert_array_equal(ours, frozen[eye])
        np.testing.assert_array_equal(frozen_oracle(texels[eye], **kw),
                                      frozen[eye])


def test_config_loads_by_name():
    c = Spec().config(CONFIG)
    assert c["name"] == CONFIG and c["family"] == "fsr"
    assert (c["render_scale"], c["radius"], c["sharpness"]) == (1.0, 2.0, 0.9)
    assert c["eye_in_wh"] == c["eye_out_wh"] == [2244, 2492]
    assert (c["color_bits"], c["precision"], c["reduced"]) == (8, "full", [])
    assert c["check_limits"]["max_lsb"] >= 0
    # the whole frame is inside the circle: RCAS computes every output
    w = work.pair_work(c)
    assert (w["inside"], w["outside"]) == (2 * 2244 * 2492, 0)
    assert w["ops"] == w["inside"] * c["ops_per_output"]["inside"]
    assert work.least_ms(w)[1] == "bytes"


def test_cell_resolves_with_its_metrics():
    cell = Spec().cell(CELL)
    assert cell.chips == 1 and cell.config["name"] == CONFIG
    assert cell.traffic["source"] == "device"
    assert [m["name"] for m in cell.end_to_end] == ["pairs_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "kernel_ms", "kernel_roofline", "device_idle_share", "api_self_ms",
        "build_s", "inside_roofline"]
