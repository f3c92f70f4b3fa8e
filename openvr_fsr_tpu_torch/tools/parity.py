"""Full-size parity of the port against the NumPy oracle: the port of the
repository's tools/parity.py to the NVIDIA GPU.

The judge is oracle.pipeline.pipeline_oracle, the port's copy of the JAX
package's oracle (the same eight modules; tests/test_torch_oracle.py holds
them equal and their outputs bit-equal): the full reference pipeline in pure
NumPy, IEEE round-to-nearest f32 with no FMA contraction, computed on the
host. Each case runs `Pipeline(...).process(frame[None], eyes=(eye,))` on
the card at full working resolution and counts, over the output's RGBA
bytes, the values that differ (`mismatch_gt0`), those that differ by more
than 1 (`mismatch_gt1`) and the largest difference (`max_lsb`).

The cases are the root tool's eleven (:87-116: the same frames, kwargs and
names), then fourteen the TPU record (PARITY_r05.json) lacks: NVScaler and
NVSharpen at hdr_mode 1 and 2, FSR at radius 0.0 with debug, CAS sharpen
at cas_max_color_delta 0.05, an off-centre right eye, one double-wide
frame, and the 10-bit path (color_bits=10, R10G10B10A2), one case per
stage plan at radius 0.5, on a 10-bit zone plate or a seeded 10-bit noise
whose alpha takes all four values. The bar: every case within 1 LSB, and
0 unequal values wherever PARITY_r05.json shows 0 (ZERO) and in the 10-bit
cases (TEN_BIT). The exit code is 1 when a case misses it.

    python3 -m openvr_fsr_tpu_torch.tools.parity [--skip-nis]
        [--oracle-only] [--out PATH] [--device cpu [--small]]

--oracle-only fills the oracle cache (host work only, no card);
--device cpu runs the plain torch versions instead of the kernels, and
--small (with --device cpu only) runs the same cases on 48x40 inputs, for
the CPU tests. Oracle outputs are cached in parity_torch_oracle_cache.npz
in the temporary directory, under the root tool's keys (:39-59) over the
port's own sources; missing ones are computed in parallel, one process per
case up to the host's cores. One JSON record goes to stdout (and to --out):
the card as nvidia-smi names it with its power limit, and each case's
counts.
"""

import argparse
import glob
import hashlib
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(tempfile.gettempdir(), "parity_torch_oracle_cache.npz")
FULL = (1869, 1683)          # the headline render size (h, w), BASELINE.md
SMALL = (40, 48)             # --small
OFF_CENTRE = ((0.45, 0.5), (0.55, 0.52))
MAX_LSB = 1

# (name, frame, kwargs for both sides). Frames: the render-size zone plate
# and noise, the output-size zone plate, two render-size zone plates side
# by side (a double-wide frame), and the 10-bit frames (frames()).
CASES = [
    ("fsr_fused_zone_r0.5", "zone_plate",
     dict(render_scale=0.75, sharpness=0.9, radius=0.5)),
    ("fsr_fused_zone_r2.0", "zone_plate",
     dict(render_scale=0.75, sharpness=0.9, radius=2.0)),
    ("fsr_fused_noise_r0.5", "noise",
     dict(render_scale=0.75, sharpness=0.9, radius=0.5)),
    ("fsr_fused_noise_r2.0", "noise",
     dict(render_scale=0.75, sharpness=0.9, radius=2.0)),
    ("rcas_only_zone", "big_zone_plate",
     dict(render_scale=1.0, sharpness=0.9, radius=2.0)),
    ("fsr_supersample_zone", "big_zone_plate",
     dict(render_scale=1.3, sharpness=0.9, radius=2.0)),
    ("cas_upscale_noise", "noise",
     dict(render_scale=0.75, sharpness=0.8, radius=2.0, use_cas=True)),
    ("cas_sharpen_zone", "big_zone_plate",
     dict(render_scale=1.0, sharpness=0.8, radius=2.0, use_cas=True)),
    ("nvscaler_noise", "noise",
     dict(render_scale=0.75, sharpness=0.7, radius=2.0, use_nis=True)),
    ("nvscaler_zone_r0.5", "zone_plate",
     dict(render_scale=0.75, sharpness=0.7, radius=0.5, use_nis=True)),
    ("nvsharpen_zone", "big_zone_plate",
     dict(render_scale=1.0, sharpness=0.7, radius=2.0, use_nis=True)),
    # the cases the TPU record lacks
    ("nvscaler_zone_r0.5_hdr1", "zone_plate",
     dict(render_scale=0.75, sharpness=0.7, radius=0.5, use_nis=True,
          hdr_mode=1)),
    ("nvscaler_zone_r0.5_hdr2", "zone_plate",
     dict(render_scale=0.75, sharpness=0.7, radius=0.5, use_nis=True,
          hdr_mode=2)),
    ("nvsharpen_zone_hdr1", "big_zone_plate",
     dict(render_scale=1.0, sharpness=0.7, radius=2.0, use_nis=True,
          hdr_mode=1)),
    ("nvsharpen_zone_hdr2", "big_zone_plate",
     dict(render_scale=1.0, sharpness=0.7, radius=2.0, use_nis=True,
          hdr_mode=2)),
    ("fsr_fused_zone_r0.0_debug", "zone_plate",
     dict(render_scale=0.75, sharpness=0.9, radius=0.0, debug=True)),
    ("cas_sharpen_zone_mcd0.05", "big_zone_plate",
     dict(render_scale=1.0, sharpness=0.8, radius=2.0, use_cas=True,
          cas_max_color_delta=0.05)),
    ("fsr_fused_noise_r0.3_eye1_offcentre", "noise",
     dict(render_scale=0.75, sharpness=0.9, radius=0.3, eye=1,
          eye_centers=OFF_CENTRE)),
    ("fsr_fused_zone_doublewide", "double_wide",
     dict(render_scale=0.75, sharpness=0.9, radius=0.5, single_eye=False)),
    # the 10-bit path, one case per stage plan
    ("fsr_fused_noise10_r0.5", "noise10",
     dict(render_scale=0.75, sharpness=0.9, radius=0.5, color_bits=10)),
    ("rcas_only_zone10_r0.5_debug", "big_zone_plate10",
     dict(render_scale=1.0, sharpness=0.9, radius=0.5, debug=True,
          color_bits=10)),
    ("nvscaler_noise10_r0.5", "noise10",
     dict(render_scale=0.75, sharpness=0.7, radius=0.5, use_nis=True,
          color_bits=10)),
    ("nvsharpen_zone10_r0.5", "big_zone_plate10",
     dict(render_scale=1.0, sharpness=0.7, radius=0.5, use_nis=True,
          color_bits=10)),
    ("cas_upscale_noise10_r0.5", "noise10",
     dict(render_scale=0.75, sharpness=0.8, radius=0.5, use_cas=True,
          color_bits=10)),
    ("cas_sharpen_zone10_r0.5", "big_zone_plate10",
     dict(render_scale=1.0, sharpness=0.8, radius=0.5, use_cas=True,
          color_bits=10)),
]
# the cases PARITY_r05.json shows with 0 unequal values on the TPU
ZERO = ("fsr_fused_zone_r0.5", "fsr_fused_zone_r2.0", "rcas_only_zone",
        "fsr_supersample_zone", "cas_upscale_noise", "cas_sharpen_zone",
        "nvsharpen_zone")
# the 10-bit cases, held to 0 unequal values too
TEN_BIT = tuple(n for n, _, kw in CASES if kw.get("color_bits") == 10)


def _oracle_fingerprint():
    """Digest of every source the oracle's output depends on (the port's
    oracle, its constant tables and quantize_unorm's module), so an edit to
    any of them invalidates cached outputs."""
    h = hashlib.sha1()
    deps = sorted(glob.glob(os.path.join(PKG, "oracle", "*.py"))
                  + [os.path.join(PKG, "core", f)
                     for f in ("constants.py", "nis_tables.py",
                               "foveation.py")]
                  + [os.path.join(PKG, "utils", "frames.py")])
    for p in deps:
        if os.path.exists(p):
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _case_key(name, frame, kw, oracle_fp):
    """Cache key = case name + digest of (config, frame, oracle sources): a
    stale cache can never be judged against silently."""
    h = hashlib.sha1(oracle_fp.encode())
    h.update(repr(sorted(kw.items())).encode())
    h.update(np.ascontiguousarray(frame).tobytes())
    return f"{name}:{h.hexdigest()[:16]}"


def zone_plate10(h, w, k=0.08):
    """utils/frames.py::zone_plate_frame at 10 bits: (h, w, 4) uint16, the
    plate 511.5 + 511.5 cos(...) in RGB, alpha 3 (opaque)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = (yy - h / 2.0) ** 2 + (xx - w / 2.0) ** 2
    v = (511.5 + 511.5 * np.cos(k * r2 * np.pi / max(h, w))).astype(
        np.uint16)
    return np.stack([v, v, v, np.full((h, w), 3, np.uint16)], -1)


def noise10(h, w, seed=1):
    """(h, w, 4) uint16 from `seed`: RGB uniform in [0, 1023], alpha
    uniform in {0, 1, 2, 3}, so every value of the 2-bit alpha is
    carried."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 1024, (h, w, 3)).astype(np.uint16)
    alpha = rng.integers(0, 4, (h, w, 1)).astype(np.uint16)
    return np.concatenate([rgb, alpha], axis=-1)


def frames(small=False):
    """The cases' input frames, uint8 RGBA and, for the 10-bit cases,
    uint16 R10G10B10A2: full size, or --small's."""
    from ..utils import frames as FR
    h, w = SMALL if small else FULL
    oh, ow = int(h / 0.75), int(w / 0.75)     # the headline output size
    zone = FR.zone_plate_frame(h, w)
    return {"zone_plate": zone, "noise": FR.noise_frame(h, w, seed=1),
            "big_zone_plate": FR.zone_plate_frame(oh, ow),
            "double_wide": np.concatenate([zone, zone], axis=1),
            "zone_plate10": zone_plate10(h, w),
            "big_zone_plate10": zone_plate10(oh, ow),
            "noise10": noise10(h, w, seed=1)}


def select(skip_nis=False, names=None):
    """The cases to run: all, less the NIS ones with skip_nis, or those
    named (unknown names raise)."""
    if names is not None:
        unknown = set(names) - {n for n, _, _ in CASES}
        if unknown:
            raise ValueError(f"unknown parity cases {sorted(unknown)}")
        return [c for c in CASES if c[0] in names]
    return [c for c in CASES
            if not (skip_nis and c[2].get("use_nis", False))]


def oracle_case(frame, kw):
    """pipeline_oracle on one case (the kwargs are its own)."""
    from ..oracle.pipeline import pipeline_oracle
    rest = {k: v for k, v in kw.items()
            if k not in ("render_scale", "sharpness")}
    return pipeline_oracle(frame, kw["render_scale"], kw["sharpness"], **rest)


def oracle_outputs(cases, inputs, cache_path=CACHE, jobs=None):
    """{case name: oracle output}, from the cache where its key is there,
    else computed (in `jobs` spawned processes, at most one per case) and
    added to the cache (cache_path None: no cache)."""
    fp = _oracle_fingerprint()
    cache = {}
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as saved:
            cache = dict(saved)
    keys = {name: _case_key(name, inputs[f], kw, fp)
            for name, f, kw in cases}
    missing = [(name, f, kw) for name, f, kw in cases
               if keys[name] not in cache]
    jobs = min(len(missing), jobs or os.cpu_count() or 1)
    t0 = time.perf_counter()
    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
            futures = {name: pool.submit(oracle_case, inputs[f], kw)
                       for name, f, kw in missing}
            for name, future in futures.items():
                cache[keys[name]] = future.result()
                print(f"[oracle] {name}: {time.perf_counter() - t0:.1f} s "
                      f"({jobs} processes)", file=sys.stderr, flush=True)
    else:
        for name, f, kw in missing:
            cache[keys[name]] = oracle_case(inputs[f], kw)
            print(f"[oracle] {name}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)
    if missing and cache_path:
        np.savez_compressed(cache_path, **cache)
    return {name: cache[keys[name]] for name, _, _ in cases}


def port_output(frame, kw, device):
    """One case through Pipeline.process on `device`: (its output as a
    numpy array, the Pipeline)."""
    from ..api.pipeline import Pipeline
    from ..core.config import Config
    cfg = Config(enabled=True, render_scale=kw["render_scale"],
                 sharpness=kw["sharpness"], radius=kw["radius"],
                 use_nis=kw.get("use_nis", False),
                 use_cas=kw.get("use_cas", False),
                 debug_mode=kw.get("debug", False))
    pipe = Pipeline(cfg, eye_centers=kw.get("eye_centers"),
                    single_eye_per_frame=kw.get("single_eye", True),
                    color_bits=kw.get("color_bits"),
                    hdr_mode=kw.get("hdr_mode", 0),
                    cas_max_color_delta=kw.get("cas_max_color_delta", 1.0),
                    device=device)
    out = pipe.process(frame[None], eyes=(kw.get("eye", 0),))
    return out[0].cpu().numpy(), pipe


def compare(got, want):
    """The root tool's counts (:149-156) over the RGBA values."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"output {got.shape} {got.dtype}, the oracle's "
                         f"{want.shape} {want.dtype}")
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return {"pixels": int(d.size), "mismatch_gt0": int((d > 0).sum()),
            "mismatch_gt1": int((d > 1).sum()), "max_lsb": int(d.max())}


def meets_bar(name, result):
    return result["max_lsb"] <= MAX_LSB and (
        name not in ZERO + TEN_BIT or result["mismatch_gt0"] == 0)


def run(cases, device="cuda", small=False, cache_path=CACHE, jobs=None):
    """Judge `cases` (CASES entries) on `device` against the oracle:
    {name: counts, plus the CUDA launches of the case's kernels}."""
    inputs = frames(small)
    want = oracle_outputs(cases, inputs, cache_path, jobs)
    results = {}
    for name, f, kw in cases:
        t0 = time.perf_counter()
        got, pipe = port_output(inputs[f], kw, device)
        results[name] = dict(compare(got, want[name]), launches=sum(
            k.launches for k in pipe.kernels))
        print(f"[port] {name} on {device}: "
              f"{time.perf_counter() - t0:.1f} s {results[name]}",
              file=sys.stderr, flush=True)
    return results


def main(argv=None):
    """Run the cases, print the record, and return it; exit 1 when a case
    misses the bar or the card is asked for and torch finds none."""
    ap = argparse.ArgumentParser(
        prog="python3 -m openvr_fsr_tpu_torch.tools.parity",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-nis", action="store_true",
                    help="leave out the NVScaler and NVSharpen cases")
    ap.add_argument("--oracle-only", action="store_true",
                    help="fill the oracle cache and stop (no card)")
    ap.add_argument("--out", default=None,
                    help="also write the record here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu (the plain "
                    "torch versions)")
    ap.add_argument("--small", action="store_true",
                    help="48x40 inputs (needs --device cpu)")
    args = ap.parse_args(argv)
    import torch
    device = torch.device(args.device)
    if args.small and device.type != "cpu":
        ap.error("--small runs the plain versions: it needs --device cpu")
    cases = select(args.skip_nis)
    cache_path = None if args.small else CACHE
    if args.oracle_only:
        oracle_outputs(cases, frames(args.small), cache_path)
        print(f"oracle cache primed: {cache_path}", flush=True)
        return None
    if device.type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"error": "torch finds no CUDA GPU: pass --device "
                          "cpu for the plain versions"}), flush=True)
        sys.exit(1)
    if device.type == "cuda":
        from ..bench import card
        hardware = card()
    else:
        hardware = "cpu: the plain torch versions"
    results = run(cases, args.device, args.small, cache_path,
                  1 if args.small else None)
    misses = [n for n, r in results.items() if not meets_bar(n, r)]
    record = {
        "hardware": hardware,
        "comparison": ("openvr_fsr_tpu_torch Pipeline.process "
                       f"({'CUDA kernels' if device.type == 'cuda' else 'plain torch versions'}) "
                       "vs the NumPy scalar full-pipeline oracle "
                       "(oracle/pipeline.py), at "
                       f"{'48x40 inputs' if args.small else 'full working resolution'}"),
        "results": results,
        "all_max_lsb": max(r["max_lsb"] for r in results.values()),
        "misses": misses,
    }
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    if misses:
        print(f"parity: {misses} miss the bar (max {MAX_LSB} LSB, 0 "
              f"unequal in {ZERO + TEN_BIT})", file=sys.stderr, flush=True)
        sys.exit(1)
    return record


if __name__ == "__main__":
    main()
