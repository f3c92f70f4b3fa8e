"""Same-process A/B of the fused FSR kernel (B1, csrc/fsr_fused.cu) against
an earlier source of it, on one NVIDIA GPU.

    python3 -m openvr_fsr_tpu_torch.tools.ab_fused --parent FILE
        [--iters N] [--out FILE]

FILE is an earlier csrc/fsr_fused.cu with the one-CTA-per-16x16-tile entry
point (fsr_fused_launch: 9 pointers, 7 ints, 2 floats, the window edge 24
and the stream), as `git show <commit>:openvr_fsr_tpu_torch/csrc/
fsr_fused.cu` gives it. It is built with the port's nvcc flags into a
temporary directory and driven with the tables it was written for: the same
sample maps and centres, and 24x24 windows per 16x16 tile.

Cases, sharpness 0.9, centred eyes: the main path (2 x 1683x1869 -> 2 x
2244x2492, rs 0.75) at radius 0.0, 0.5 and 2.0, and the supersample (2 x
2244x2492 -> 2 x 2917x3239, rs 1.3) at radius 0.5. In each, both kernels'
outputs must equal the plain version's on the first frame (else it exits
1); then they are timed in turns, parent, current, current, parent, each
round the best of 3 rotations of `iters` back-to-back calls over the
bench's three ring frames (CUDA events). Prints one JSON line: the card,
each build's ptxas registers, spills and shared memory per kernel, the
current kernels' CTAs per SM, and per case both rounds of each and
parent / current.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

__all__ = ["main", "build_parent", "parent_launcher", "CASES"]

# (label, in_h, in_w, render_scale, radius)
CASES = [("rs0.75 radius 0.0", 1869, 1683, 0.75, 0.0),
         ("rs0.75 radius 0.5", 1869, 1683, 0.75, 0.5),
         ("rs0.75 radius 2.0", 1869, 1683, 0.75, 2.0),
         ("rs1.3 radius 0.5", 2492, 2244, 1.3, 0.5)]
SHARPNESS = 0.9
PARENT_TILE, PARENT_WINDOW = 16, 24
PARENT_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def build_parent(source):
    """(the parent's ctypes entry point, its ptxas usage) from its source,
    built into a temporary directory with the port's flags and headers."""
    from ..kernels import _build
    from . import sass

    lib = Path(tempfile.mkdtemp(prefix="fsr_fused_parent_")) / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(lib), str(source)]
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=_build.NVCC_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc exited {r.returncode}:\n{r.stdout}{r.stderr}")
    f = ctypes.CDLL(str(lib)).fsr_fused_launch
    f.argtypes = PARENT_ARGTYPES
    f.restype = ctypes.c_int
    return f, sass.ptxas_usage(r.stdout + r.stderr)


def parent_launcher(entry, maps, batch, sharp, tint, device):
    """fn(img) running the parent kernel with the tables it was written
    for: the maps and centres of `maps` (kernels/_maps.py::fsr_maps) and
    the origins of 24x24 windows per 16x16 tile."""
    from ..kernels._maps import _footprint_origins

    m = maps
    H, W, OH, OW = m.in_h, m.in_w, m.out_h, m.out_w
    (fxi, bx0), (fyi, by0) = m.col_i, m.row_i
    origins = [torch.as_tensor(_footprint_origins(
        np.minimum(np.clip(f - 1, 0, n - 1), np.clip(b, 0, n - 1)),
        np.maximum(np.clip(f + 2, 0, n - 1), np.clip(b + 1, 0, n - 1)),
        PARENT_TILE, 1, PARENT_WINDOW), device=device)
        for f, b, n in ((fxi, bx0, W), (fyi, by0, H))]
    d = m.to(device)

    def run(img):
        out = torch.empty((batch, OH, OW), dtype=torch.int32, device=device)
        err = entry(img.data_ptr(), out.data_ptr(), d.col_i.data_ptr(),
                    d.col_f.data_ptr(), d.row_i.data_ptr(), d.row_f.data_ptr(),
                    origins[0].data_ptr(), origins[1].data_ptr(),
                    d.centres.data_ptr(), batch, H, W, img.shape[1],
                    img.shape[2], OH, OW, float(sharp), float(tint),
                    PARENT_WINDOW, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent fsr_fused_launch: cudaError {err}")
        return out
    return run


def _best_ms(fn, inputs, iters):
    from ..utils.timing import rotation_ms
    rotation_ms(fn, inputs, 5)
    return min(rotation_ms(fn, inputs, iters) for _ in range(3))


def main(argv=None):
    """Run the A/B, print its JSON line and return the record."""
    from .. import bench
    from ..api.pipeline import Pipeline
    from ..core import constants as C
    from ..core.config import Config
    from ..kernels import _build
    from ..kernels._common import debug_tint
    from ..kernels._maps import fsr_maps
    from ..kernels.fsr import build_fsr_fused, occupancy
    from . import sass

    ap = argparse.ArgumentParser(
        prog="python3 -m openvr_fsr_tpu_torch.tools.ab_fused",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the earlier csrc/fsr_fused.cu to compare with")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    bench.require_gpu(["ab_fused"])
    dev = torch.device("cuda", torch.cuda.current_device())
    card = bench.card()
    entry, parent_usage = build_parent(args.parent)
    _build.build(["fsr_fused"])
    usage = sass.ptxas_usage(
        _build.library_path("fsr_fused").with_suffix(".log").read_text())
    rec = {"metric": "ab_fused", "device": card, "iters": args.iters,
           "parent": str(args.parent), "ptxas_parent": parent_usage,
           "ptxas_current": usage, "ctas_per_sm_current": occupancy(),
           "cases": []}
    print(f"[ab] {card}; parent {parent_usage}; current {usage}, CTAs per SM "
          f"{rec['ctas_per_sm_current']}", file=sys.stderr, flush=True)
    sharp = C.fsr_rcas_con(C.rcas_stops_from_slider(SHARPNESS))
    for label, h, w, rs, radius in CASES:
        ow, oh = Config(render_scale=rs).output_size(w, h)
        cen = C.centres_payload(ow, oh, radius, Pipeline(device="cpu")
                                .eye_centers, (0, 1))
        new = build_fsr_fused(2, h, w, ow, oh, sharpness=SHARPNESS,
                              centres=cen)
        old = parent_launcher(entry, fsr_maps(2, h, w, ow, oh, cen), 2,
                              sharp, debug_tint(False), dev)
        inputs = bench.ring_frames(h, w, new.pad_to, dev)
        want = new.reference(inputs[0])
        for name, fn in (("parent", old), ("current", new)):
            ne = int((fn(inputs[0]) != want).sum())
            if ne:
                print(json.dumps({"metric": "ab_fused", "error":
                                  f"{label}: {name} kernel {ne} texels "
                                  "unequal to the plain version"}))
                sys.exit(1)
        rounds = {"parent": [], "current": []}
        for name, fn in (("parent", old), ("current", new),
                         ("current", new), ("parent", old)):
            rounds[name].append(_best_ms(fn, inputs, args.iters))
        case = {"case": label, "parent_ms": rounds["parent"],
                "current_ms": rounds["current"],
                "parent_over_current": float(np.mean(rounds["parent"])
                                             / np.mean(rounds["current"]))}
        rec["cases"].append(case)
        print(f"[ab] {label}: {case}", file=sys.stderr, flush=True)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
