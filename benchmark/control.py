"""Readings for the limits of `correct`: a cell's runs on many seeds in one
process, at the configuration's precision (the lower reading: the largest
that sound runs give) or at the program's own lower precision, bf16
(`--precision half`, Pipeline(precision="half"): the control, whose least
reading is the upper one).

    python3 benchmark/control.py --workload <name> --seeds 1,2,3
        [--seconds S] [--precision full|half] [--out FILE]

Each seed is a whole run (inputs from the seed, the cell's traffic for
--seconds, the sampled outputs against the frozen reference). One JSON
line per seed, then one with every reading; --out also writes them.
Exits 1 without a CUDA GPU.
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--precision", choices=("full", "half"), default="half")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(0, str(ROOT))
    import torch

    from fsrbench.harness import run_cell
    from fsrbench.spec import Spec

    if not torch.cuda.is_available():
        print("control.py: no CUDA GPU", file=sys.stderr)
        return 1
    spec = Spec(ROOT, BENCH_DIR)
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(cell, seed, args.seconds, False, spec=spec,
                     device=device, t_process=time.perf_counter(),
                     precision=args.precision)
        line = {"workload": args.workload, "precision": args.precision,
                "seed": seed, "checks": r["checks"], "info": r["info"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {"workload": args.workload, "precision": args.precision,
               "readings": {name: [ln["checks"][name]["value"]
                                   for ln in lines]
                            for name in lines[0]["checks"]},
               "device": torch.cuda.get_device_name(device)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"lines": lines, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
