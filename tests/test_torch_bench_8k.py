"""The port's 8K batch tool (openvr_fsr_tpu_torch/tools/bench_8k.py) on the
CPU at a small shape: the per-frame time, each frame of a batch launch
against a batch-1 launch, the row's fields, and no write of BENCH_8K.json
(the JAX package's record)."""

import hashlib
import json
from pathlib import Path

import pytest
import torch

from openvr_fsr_tpu_torch import Config, Pipeline
from openvr_fsr_tpu_torch.tools import bench_8k as B8

REPO = Path(__file__).resolve().parent.parent
H, W = 48, 64


def test_the_8k_configuration():
    assert (B8.H_IN, B8.W_IN) == (3240, 5760)
    assert B8.CONFIG == dict(render_scale=0.75, sharpness=0.9, radius=2.0)
    assert B8.BATCHES == (4, 8, 16, 32)
    assert Config(**B8.CONFIG).output_size(B8.W_IN, B8.H_IN) == (7680, 4320)
    assert B8.METRIC == "fsr_8k_7680x4320_rs075_ms_per_frame"
    # batch 32's output: 1,061,683,200 words (an int32 index), 4.25 GB (a
    # byte offset past 2^31)
    words = 32 * 4320 * 7680
    assert words < 2 ** 31 < words * 4


@pytest.mark.parametrize("batch", [2, 3])
def test_measure_row(batch):
    row, kernel, floor = B8.measure(batch, H, W, device="cpu", iters=2,
                                    rounds=2, warmup=1, log=lambda *a: None)
    assert row["metric"] == B8.METRIC and row["unit"] == "ms"
    assert row["value"] == row["ms_per_launch"] / batch
    assert row["local_batch"] == batch and row["measured_chips"] == 1
    assert row["frames_equal_to_batch1"] == {"0": True,
                                             str(batch - 1): True}
    ow, oh = Config(**B8.CONFIG).output_size(W, H)
    assert row["shape"] == f"{W}x{H} -> {ow}x{oh}"
    assert row["mpix_per_s_per_chip"] == pytest.approx(
        ow * oh / 1e6 / (row["value"] / 1000.0))
    # the device numbers exist only on the card
    assert row["device"] == "cpu" and floor is None
    for key in ("device_ms", "floor_ms", "vs_sol", "peak_memory_bytes",
                "memory_at_start_bytes"):
        assert row[key] is None
    assert kernel.launches == 0                 # a CPU call runs no kernel
    assert "extrapolated_fps_batch32_8chips_from_1chip" not in row


def test_each_frame_of_a_batch_equals_a_batch1_launch():
    pipe = Pipeline(Config(enabled=True, **B8.CONFIG), device="cpu")
    batch = 4
    eyes = tuple(i % 2 for i in range(batch))
    x = B8.frames(batch, H, W, torch.device("cpu"), 0)
    assert x.shape == (batch, H, W, 4) and x.dtype == torch.uint8
    assert torch.equal(x, B8.frames(batch, H, W, torch.device("cpu"), 0))
    out = pipe._build(batch, H, W, eyes, packed=False)(x)
    for k in range(batch):
        one = pipe._build(1, H, W, (eyes[k],), packed=False)
        assert torch.equal(out[k:k + 1], one(x[k:k + 1])), k


def test_writes_only_to_out(tmp_path, monkeypatch, capsys):
    record = REPO / "BENCH_8K.json"
    before = hashlib.sha256(record.read_bytes()).hexdigest()
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--size", f"{W}x{H}", "--batches", "2"]
    rows = B8.main(argv)
    assert list(tmp_path.iterdir()) == [] and len(rows) == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "local_batch"] == 2
    out = tmp_path / "8k.json"
    B8.main(argv + ["--out", str(out)])
    assert [r["local_batch"] for r in json.loads(out.read_text())] == [2]
    assert hashlib.sha256(record.read_bytes()).hexdigest() == before
