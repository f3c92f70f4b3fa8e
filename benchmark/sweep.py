"""The stream's knee: a deployment under a stream mix (traffic/<name>.json,
source host_rings) at several offered rates in one process, unpaced (rate
0: the producer pushes as fast as the rings take) and paced.

    python3 benchmark/sweep.py [--config fsr_rs075_2244x2492]
        [--traffic stream_rings_90] [--rates 0,60,90,120,150,200]
        [--seconds 8] [--seed N] [--out FILE]

One JSON line per rate: pairs due and completed, completed pairs/s, drops,
latency p50 / p95 / max per pair (ms, from the due time; unpaced from the
push's start), the generator's lateness, the H2D copy (CUDA events) and
the host's ms inside FrameRing.push and pop per pair. Exits 1 without a CUDA GPU.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="fsr_rs075_2244x2492")
    ap.add_argument("--traffic", default="stream_rings_90")
    ap.add_argument("--rates", default="0,60,90,120,150,200")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(0, str(ROOT))
    import torch

    from fsrbench import inputs as IN
    from fsrbench.harness import build_model, _percentile_nearest as pct
    from fsrbench.load import StreamRig, run_window
    from fsrbench.spec import Spec
    from fsrbench.trace import Tracer

    if not torch.cuda.is_available():
        print("sweep.py: no CUDA GPU", file=sys.stderr)
        return 1
    spec = Spec(ROOT, BENCH_DIR)
    config, base = spec.config(args.config), spec.traffic(args.traffic)
    device = torch.device("cuda", 0)
    model = build_model(config, device)
    iw, ih = config["eye_in_wh"]
    pairs = IN.make_pairs(args.seed, 3, iw, ih, device,
                          color_bits=config["color_bits"])
    for x in pairs:
        model(x)
    rig = StreamRig([p.cpu().numpy() for p in pairs],
                    int(base.get("ring_slots", 6)), device)
    del pairs
    lines = []
    try:
        run_window(model, dict(base, rate_hz=90), rig, 0.3,
                   IN.seed_rng(args.seed, 99), Tracer(False), device)
        for rate in (float(r) for r in args.rates.split(",")):
            traffic = dict(base, rate_hz=rate,
                           arrivals="paced" if rate else "closed")
            w = run_window(model, traffic, rig, args.seconds,
                           IN.seed_rng(args.seed, 2), Tracer(False), device)
            done = [x for x in w.latencies_ms if x != float("inf")]
            line = {"rate_hz": rate, "due": w.attempted,
                    "completed": w.completed, "dropped": w.failed,
                    "completed_per_s": w.completed / args.seconds,
                    "tag_errors": w.tag_errors,
                    "p50_ms": pct(done, 50), "p95_ms": pct(w.latencies_ms, 95),
                    "max_ms": max(done) if done else None,
                    "generator_late_p95_ms": pct(w.late_ms, 95),
                    "upload_ms_mean": (sum(w.upload_ms) / len(w.upload_ms)
                                       if w.upload_ms else None),
                    "ring_ms_per_pair": ((sum(w.push_s) + sum(w.pop_s)) * 1e3
                                         / max(1, w.completed)),
                    "card": torch.cuda.get_device_name(device),
                    "at": time.time()}
            print(json.dumps(line), flush=True)
            lines.append(line)
    finally:
        rig.close()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
