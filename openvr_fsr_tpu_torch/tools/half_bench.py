"""precision="half" against "full" per path on one NVIDIA GPU: the port of
the repository's tools/half_bench.py, for the seven paths of
tools/bench_paths.py::PATHS (fsr_fused, fsr_supersample, rcas_only,
nvscaler, nvsharpen, cas_upscale, cas_sharpen) at full size, sharpness
0.9, radius 0.5.

    python3 -m openvr_fsr_tpu_torch.tools.half_bench [--paths a,b]
        [--iters N] [--out FILE]

Per path and precision, bench.measure's numbers (the bench's three ring
frames; value: back-to-back calls ending in a host sync, the host's cost
of a call included; device_ms: the same calls replayed from a CUDA graph;
the path's DMA floor timed in turns with it, hbm_sol_ms, and vs_sol =
floor / device_ms). The half build's floor is the full build's: both move
the same texels (the IO of the half kernels is f32's). Then half / full of
value and of device_ms, and half against full on the first ring frame (a
zone plate and a noise frame) over the RGB bytes: max LSB, mean LSB and
PSNR (dB, peak 255; inf where equal). One JSON line per path on stdout;
--out also writes them as one JSON object to FILE. With no CUDA GPU each
line has value null and an error, and the exit code is 1.
"""

import argparse
import json
import math
import sys

from .bench_paths import PATHS, metric, path_config



def quality(half, full):
    """{max_lsb, mean_lsb, psnr_db} of half against full: two packed
    RGBA8 int32 frames, over their R, G and B bytes."""
    import torch
    a = half.contiguous().view(torch.uint8).view(*half.shape, 4)[..., :3]
    b = full.contiguous().view(torch.uint8).view(*full.shape, 4)[..., :3]
    d = (a.to(torch.int32) - b.to(torch.int32)).abs().double()
    mse = float((d * d).mean())
    return {"max_lsb": int(d.max()), "mean_lsb": float(d.mean()),
            "psnr_db": math.inf if mse == 0 else
            10.0 * math.log10(255.0 ** 2 / mse)}


def main(argv=None):
    """Measure the paths, print one JSON line each, and return {name:
    (the line as a dict, {precision: the PathRun})}."""
    from .. import bench

    ap = argparse.ArgumentParser(
        prog="python3 -m openvr_fsr_tpu_torch.tools.half_bench",
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
    bench.require_gpu([f"{metric(n)}_half" for n in names])
    device = bench.card()
    results = {}
    for name in names:
        cfg, h, w = path_config(name)
        runs = {p: bench.measure(cfg, h, w, iters=args.iters, precision=p)
                for p in ("full", "half")}
        frames = {p: bench.ring_frames(h, w, r.kernel.pad_to, "cuda")[0]
                  for p, r in runs.items()}
        q = quality(runs["half"].kernel(frames["half"]),
                    runs["full"].kernel(frames["full"]))
        record = {"metric": f"{metric(name)}_half", "path": name,
                  "device": device}
        for p, r in runs.items():
            record[p] = {"value": r.ms, "device_ms": r.device_ms,
                         "hbm_sol_ms": r.sol_ms, "vs_sol": r.vs_sol,
                         "compile_s": r.compile_s}
        record["half_over_full_value"] = runs["half"].ms / runs["full"].ms
        record["half_over_full_device"] = (runs["half"].device_ms
                                           / runs["full"].device_ms)
        record.update(q)
        print(f"[half] {name}: full {runs['full'].device_ms:.5f} ms, half "
              f"{runs['half'].device_ms:.5f} ms device time "
              f"({record['half_over_full_device']:.3f}x), floor "
              f"{runs['half'].sol_ms:.5f} ms (vs_sol full "
              f"{runs['full'].vs_sol:.3f}, half {runs['half'].vs_sol:.3f}); "
              f"half against full max {q['max_lsb']} LSB, mean "
              f"{q['mean_lsb']:.4f}, PSNR {q['psnr_db']:.2f} dB ({device})",
              file=sys.stderr, flush=True)
        print(json.dumps(record), flush=True)
        results[name] = record, runs
    if args.out:
        with open(args.out, "w") as f:
            json.dump({n: r for n, (r, _) in results.items()}, f, indent=1)
            f.write("\n")
    return results


if __name__ == "__main__":
    main()
