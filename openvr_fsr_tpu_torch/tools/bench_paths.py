"""All-paths benchmark of the port: one JSON line per pipeline path on one
NVIDIA GPU. The port of the repository's tools/bench_paths.py, with its
seven paths, each at the headline geometry with sharpness 0.9 and foveated
radius 0.5:

  fsr_fused        EASU + RCAS,  1683x1869 -> 2244x2492 (rs 0.75)
  fsr_supersample  EASU + RCAS,  2244x2492 -> 2917x3239 (rs 1.3)
  rcas_only        rs 1 sharpen-only at 2244x2492
  nvscaler         NIS upscale, the geometry of fsr_fused
  nvsharpen        NIS rs 1 sharpen-only at 2244x2492
  cas_upscale      CAS sharpen-and-upscale, the geometry of fsr_fused
  cas_sharpen      CAS rs 1 sharpen-only at 2244x2492

    python3 -m openvr_fsr_tpu_torch.tools.bench_paths [--paths a,b]
        [--iters N] [--out FILE]

Methodology as bench.py's (the three rotating ring frames, a warm-up, then
the best of 3 rounds of --iters calls each way: back to back ending in a
host sync, the host's cost of a call included, and replayed from one CUDA
graph, device time alone), each path stamped with its own DMA floor
replayed in turns with it, so vs_sol = floor / device_ms <= 1.
Each line: metric, value (ms per stereo pair, back to back), unit,
device_ms (ms per stereo pair, device time), mpix_per_s (over value),
compile_s (the build, with nvcc where the library is not built yet, plus
the first launch), sol_probe, probe_effective_gbps, hbm_sol_ms, vs_sol,
device.
--out also writes the lines as one JSON object to FILE. With no CUDA GPU
each path's line has value null and an error, and the exit code is 1.
"""

import argparse
import json
import sys

PATHS = {
    # name: (config kwargs, input (w, h))
    "fsr_fused": (dict(render_scale=0.75), (1683, 1869)),
    "fsr_supersample": (dict(render_scale=1.3), (2244, 2492)),
    "rcas_only": (dict(render_scale=1.0), (2244, 2492)),
    "nvscaler": (dict(render_scale=0.75, use_nis=True), (1683, 1869)),
    "nvsharpen": (dict(render_scale=1.0, use_nis=True), (2244, 2492)),
    "cas_upscale": (dict(render_scale=0.75, use_cas=True), (1683, 1869)),
    "cas_sharpen": (dict(render_scale=1.0, use_cas=True), (2244, 2492)),
}
SHARPNESS, RADIUS = 0.9, 0.5


def path_config(name):
    """(Config, in_h, in_w) of one path."""
    from ..core.config import Config
    kw, (w, h) = PATHS[name]
    return Config(enabled=True, sharpness=SHARPNESS, radius=RADIUS, **kw), \
        h, w


def metric(name):
    cfg, h, w = path_config(name)
    ow, oh = cfg.output_size(w, h)
    return f"{name}_stereo_{ow}x{oh}_ms"


def main(argv=None):
    """Measure the paths, print one JSON line each, and return {name:
    (the line as a dict, the PathRun)}."""
    from .. import bench

    ap = argparse.ArgumentParser(
        prog="python3 -m openvr_fsr_tpu_torch.tools.bench_paths",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated subset of: " + ", ".join(PATHS))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help="also write the lines as one JSON object here")
    args = ap.parse_args(argv)
    names = args.paths.split(",")
    unknown = [n for n in names if n not in PATHS]
    if unknown:
        ap.error(f"unknown paths {unknown}")
    bench.require_gpu([metric(n) for n in names])
    device = bench.card()
    results = {}
    for name in names:
        cfg, h, w = path_config(name)
        run = bench.measure(cfg, h, w, iters=args.iters)
        record = {
            "metric": metric(name),
            "value": run.ms,
            "unit": "ms",
            "device_ms": run.device_ms,
            "mpix_per_s": 2 * run.out_w * run.out_h / 1e6 / (run.ms / 1000.0),
            "compile_s": run.compile_s,
            "sol_probe": bench.SOL_PROBE,
            "probe_effective_gbps": run.probe_effective_gbps,
            "hbm_sol_ms": run.sol_ms,
            "vs_sol": run.vs_sol,
            "device": device,
        }
        print(f"[bench_paths] {name}: {run.ms} ms/pair back to back, "
              f"{run.device_ms} device time, DMA floor {run.sol_ms} ms ({run.vs_sol * 100:.0f}% of the kernel, "
              f"{run.probe_effective_gbps:.0f} GB/s), compile "
              f"{run.compile_s:.1f} s", file=sys.stderr, flush=True)
        print(json.dumps(record), flush=True)
        results[name] = record, run
    if args.out:
        with open(args.out, "w") as f:
            json.dump({n: r for n, (r, _) in results.items()}, f, indent=1)
            f.write("\n")
    return results


if __name__ == "__main__":
    main()
