"""The host's cost of a Pipeline.process call on one NVIDIA GPU, per bench
path (tools/bench_paths.py's seven, each on a packed stereo pair of zone
plate + noise at its input size): the host's time to enqueue a call (a
round of --calls calls with no sync inside it) and the back-to-back time
of as many calls ending in a sync, taken in turns from one warm state,
--rounds times; each round's pair and the least of each. Where the least
enqueue is well below the least back-to-back time, the card's work hides
the host's; where they meet, the host binds.

    python3 -m openvr_fsr_tpu_torch.tools.api_cost [--paths a,b]
        [--rounds N] [--calls N] [--parts] [--out FILE]

--parts also splits a call on the host: the kernel build's own call
(run.kernel: kernel_fn's checks and the launch) beside the whole process
call, the spread of single enqueues in one round (median and largest), a
round ten times as long, a round enqueued behind about 30 ms of other
device work (none of its kernels runs meanwhile), and three pieces every
launch pays (torch.cuda.device's enter and exit,
torch.empty of the output, the current stream's handle), each the least
per-call mean of --rounds rounds of --calls.
Each line is one JSON object per path, with the card's name and power
limit as nvidia-smi gives them. With no CUDA GPU the exit code is 1.
"""

import argparse
import json
import sys
import time

import numpy as np

from .bench_paths import PATHS, path_config

ROUNDS, CALLS = 5, 40


def enqueue_ms(call, x, calls):
    """Host ms per call of `calls` calls call(x) with no sync among them,
    from a synced start (the card idle)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call(x)
    ms = (time.perf_counter() - t0) * 1000.0 / calls
    torch.cuda.synchronize()
    return ms


def rounds(call, x, n_rounds=ROUNDS, calls=CALLS):
    """[(enqueue ms, back-to-back ms)] per call, n_rounds times in turns
    from one warm state: an enqueue round of `calls` calls, a sync, then a
    back-to-back round of as many ending in a sync (utils/timing.py::
    wall_ms)."""
    from ..utils.timing import wall_ms
    return [(enqueue_ms(call, x, calls), wall_ms(call, [x], calls))
            for _ in range(n_rounds)]


def frame(h, w, device):
    """The packed (2, h, w) int32 stereo pair of zone plate + noise on
    `device` (alpha from a seeded generator)."""
    import torch

    from ..utils import frames as FR
    u8 = np.stack([FR.zone_plate_frame(h, w), FR.noise_frame(h, w, seed=1)])
    u8[..., 3] = np.random.default_rng(0).integers(0, 256, (2, h, w),
                                                   dtype=np.uint8)
    packed = np.ascontiguousarray(u8).view(np.int32)[..., 0]
    return torch.from_numpy(np.ascontiguousarray(packed)).to(device)


def behind_busy_ms(call, x, calls, busy_ms=30.0):
    """Host ms per call of `calls` calls call(x) enqueued behind about
    busy_ms of device work (bf16 products), so that none of their kernels
    runs while the host enqueues them: the host's cost with the card busy
    elsewhere."""
    import torch
    a = torch.ones((8192, 8192), dtype=torch.bfloat16, device=x.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a @ a
    torch.cuda.synchronize()
    one = max((time.perf_counter() - t0) * 1000.0, 0.1)
    for _ in range(int(busy_ms / one) + 1):
        a @ a
    t0 = time.perf_counter()
    for _ in range(calls):
        call(x)
    ms = (time.perf_counter() - t0) * 1000.0 / calls
    torch.cuda.synchronize()
    return ms


def pieces(x, out_shape, n_rounds, calls):
    """Host ms per call of three pieces of every launch, each the least
    mean of n_rounds rounds of `calls`."""
    import torch
    dev = x.device

    def device_guard(_):
        with torch.cuda.device(dev):
            pass

    def stream(_):
        return torch.cuda.current_stream(dev).cuda_stream

    def empty(_):
        return torch.empty(out_shape, dtype=x.dtype, device=dev)

    return {name: min(enqueue_ms(f, x, calls) for _ in range(n_rounds))
            for name, f in (("cuda_device_guard", device_guard),
                            ("torch_empty_out", empty),
                            ("current_stream_handle", stream))}


def measure(name, n_rounds=ROUNDS, calls=CALLS, parts=False, x=None):
    """One path's line (a dict): its rounds, the least enqueue and
    back-to-back ms and their ratio; with parts, the split of a call."""
    import torch

    from ..api.pipeline import Pipeline
    from ..utils.timing import wall_ms
    cfg, h, w = path_config(name)
    pipe = Pipeline(cfg)
    if x is None:
        x = frame(h, w, pipe.device)
    wall_ms(pipe.process, [x], 5)
    pairs = rounds(pipe.process, x, n_rounds, calls)
    enq, b2b = min(p[0] for p in pairs), min(p[1] for p in pairs)
    line = {"path": name, "rounds": pairs, "enqueue_ms": enq,
            "back_to_back_ms": b2b, "ratio": enq / b2b}
    if parts:
        run = next(iter(pipe._cache.values()))
        kern = run.kernel
        line["kernel_call_enqueue_ms"] = min(
            enqueue_ms(kern, x, calls) for _ in range(n_rounds))
        torch.cuda.synchronize()
        single = []
        for _ in range(calls):
            t0 = time.perf_counter()
            pipe.process(x)
            single.append((time.perf_counter() - t0) * 1000.0)
        torch.cuda.synchronize()
        line["single_enqueue_ms"] = {"median": float(np.median(single)),
                                     "max": max(single)}
        line["long_round_enqueue_ms"] = enqueue_ms(pipe.process, x,
                                                   10 * calls)
        line["behind_busy_enqueue_ms"] = min(
            behind_busy_ms(pipe.process, x, calls) for _ in range(n_rounds))
        out = run(x)
        line["pieces_ms"] = pieces(x, tuple(out.shape), n_rounds, calls)
    return line


def main(argv=None):
    """Measure the paths, print one JSON line each, and return the lines."""
    from .. import bench

    ap = argparse.ArgumentParser(
        prog="python3 -m openvr_fsr_tpu_torch.tools.api_cost",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated subset of: " + ", ".join(PATHS))
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--calls", type=int, default=CALLS)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--out", default=None,
                    help="also write the lines as one JSON list here")
    args = ap.parse_args(argv)
    names = args.paths.split(",")
    unknown = [n for n in names if n not in PATHS]
    if unknown:
        ap.error(f"unknown paths {unknown}")
    import torch
    if not torch.cuda.is_available():
        print("api_cost: no CUDA GPU", file=sys.stderr)
        sys.exit(1)
    card = bench.card()
    lines = []
    for name in names:
        line = dict(measure(name, args.rounds, args.calls, args.parts),
                    device=card)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
            f.write("\n")
    return lines


if __name__ == "__main__":
    main()
