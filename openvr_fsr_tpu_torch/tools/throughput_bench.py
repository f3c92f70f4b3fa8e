"""Batched throughput of the port on one NVIDIA GPU: the serving-side
counterpart of bench.py's per-pair latency, and the port of the
repository's tools/throughput_bench.py (:22-64).

The headline fused FSR config (1683x1869 -> 2244x2492 per eye, renderScale
0.75, sharpness 0.9, radius 0.5) at a batch of B eyes (B/2 stereo pairs)
per Pipeline.process call, with zero-copy packed IO: three rotating stacks
of (B, 1869, 1683) random packed RGBA8 texels (int32 views of uint32 words
made with numpy from seed 0) resident on the card, eyes alternating. After
5 warm-up calls, the best of 3 rounds of 20 back-to-back calls, timed with
perf_counter and ending in a host sync (utils/timing.py::wall_ms): the
host's cost of each call included, as a caller pays it.

    python3 -m openvr_fsr_tpu_torch.tools.throughput_bench [B]

Prints one JSON line: {"metric": "fsr_batch<B>_packed_pairs_per_s",
"value": <pairs/s>, "unit": "pairs/s", "ms_per_pair_amortized", "mpix_per_s",
"device": "<nvidia-smi name, power limit>"}. With no CUDA GPU the value is
null, with an error, and the exit code is 1: a CPU number is never a
result.
"""

import json
import sys

import numpy as np

H_IN, W_IN = 1869, 1683
CONFIG = dict(render_scale=0.75, sharpness=0.9, radius=0.5)
WARMUP, ITERS, ROUNDS = 5, 20, 3


def metric(batch):
    return f"fsr_batch{batch}_packed_pairs_per_s"


def stacks(batch, h, w, device):
    """Three (batch, h, w) int32 stacks of random packed texels (uint32
    words from numpy's seed-0 generator) on `device`."""
    import torch
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(0, 2**32, (batch, h, w),
                                          dtype=np.uint32).view(np.int32))
            .to(device) for _ in range(3)]


def main(argv=None):
    """Measure, print the JSON line and return it as a dict."""
    from .. import bench
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if argv else 8
    bench.require_gpu([metric(batch)], unit="pairs/s")
    from ..api.pipeline import Pipeline
    from ..core.config import Config
    from ..utils.timing import wall_ms

    pipe = Pipeline(Config(enabled=True, **CONFIG))
    inputs = stacks(batch, H_IN, W_IN, pipe.device)
    eyes = tuple(i % 2 for i in range(batch))

    def call(x):
        return pipe.process(x, eyes=eyes)

    out = call(inputs[0])
    print(f"[throughput] batch={batch} eyes out={tuple(out.shape)} "
          f"{out.dtype}", file=sys.stderr, flush=True)
    wall_ms(call, inputs, WARMUP)
    ms = min(wall_ms(call, inputs, ITERS) for _ in range(ROUNDS))
    pairs = batch / 2.0
    out_w, out_h = pipe.output_size(W_IN, H_IN)
    record = {
        "metric": metric(batch),
        "value": pairs / (ms / 1000.0),
        "unit": "pairs/s",
        "ms_per_pair_amortized": ms / pairs,
        "mpix_per_s": out_w * out_h * batch / (ms / 1000.0) / 1e6,
        "device": bench.card(),
    }
    print(f"[throughput] {record['ms_per_pair_amortized']} ms/pair amortized "
          f"({record['value']} pairs/s, {record['mpix_per_s']} Mpix/s)",
          file=sys.stderr, flush=True)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
