"""The benchmark of openvr_fsr_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. Loads BENCHMARK.json, builds the cell's
deployment, makes its inputs from the seed on the card, warms up, measures
for --seconds, judges the sampled outputs against the frozen NumPy
reference, and prints one JSON line as the last line of standard output:
correct, attempted, failed, metrics (end to end with --trace 0, per layer
with --trace 1, from torch.profiler), device, and with --trace 1 the
breakdown; the numbers compared, each beside its limit, come last there
(`checks`) and as the last lines of standard error. Exits 1, printing no
result, without a CUDA GPU (or fewer than the cell asks for), when a run
fails, or when jax, jaxlib, flax or the JAX package openvr_fsr_tpu is loaded
once the window has closed.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "openvr_fsr_tpu")


def process_age_s():
    """Seconds since this process started, from /proc (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: openvr_fsr_tpu_torch is not openvr_fsr_tpu."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    t_process = time.perf_counter() - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(0, str(ROOT))
    import torch

    from fsrbench.harness import run_cell
    from fsrbench.spec import Spec

    spec = Spec(ROOT, BENCH_DIR)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA GPU(s); torch "
              f"finds {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      spec=spec, device=device, t_process=t_process,
                      log=lambda s: print(s, file=sys.stderr, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the process loaded {bad} (the JAX side): no result",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
