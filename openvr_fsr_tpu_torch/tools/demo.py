"""Interactive demo — the reference's hotkey workflow (README.md:93-111) on a
synthetic or file-based frame stream, through the port on the card: the
port of the repository's tools/demo.py.

Key map (reference default is F1..F7 via Win32 GetAsyncKeyState,
PostProcessor.cpp:659-716; terminals get letters):

  n  toggle FSR <-> NIS          (F1)
  d  toggle debug mode           (F2)
  -/+  sharpness -/+ 0.05        (F3/F4)
  [/]  radius -/+ 0.05           (F5/F6)
  c  capture output to DDS+NPY   (F7)
  q  quit

Every change rebuilds pipeline resources (Reset() semantics). A capture is
deferred: 'c' saves the next frame's output (api/capture.py::save_frame,
which moves it to the host once).

Usage:
  python3 -m openvr_fsr_tpu_torch.tools.demo                # interactive
  python3 -m openvr_fsr_tpu_torch.tools.demo --frames 50 --keys ndc
  python3 -m openvr_fsr_tpu_torch.tools.demo --input capture.dds \\
      --render-scale 0.75

Frames are processed on the current CUDA device unless --device names
another (--device cpu runs the plain versions).
"""

import argparse
import select
import sys
import time
from pathlib import Path

import numpy as np

from ..api.capture import read_dds_rgba8, save_frame
from ..api.pipeline import Pipeline
from ..core.config import Config
from ..utils import frames as FR


def _poll_key(timeout=0.0):
    if not sys.stdin.isatty():
        return None
    r, _, _ = select.select([sys.stdin], [], [], timeout)
    return sys.stdin.read(1) if r else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", help="DDS or NPY frame to stream (synthetic "
                                    "zone plate otherwise)")
    ap.add_argument("--render-scale", type=float, default=0.77)
    ap.add_argument("--sharpness", type=float, default=0.9)
    ap.add_argument("--radius", type=float, default=0.5)
    ap.add_argument("--nis", action="store_true")
    ap.add_argument("--size", default="1280x720",
                    help="synthetic input size WxH")
    ap.add_argument("--frames", type=int, default=0,
                    help="process N frames then exit (0 = interactive)")
    ap.add_argument("--keys", default="",
                    help="scripted key presses, one per frame")
    ap.add_argument("--out", default="captures")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    if args.input:
        p = Path(args.input)
        frame = (np.load(p) if p.suffix == ".npy" else read_dds_rgba8(p))
    else:
        w, h = (int(v) for v in args.size.split("x"))
        frame = FR.zone_plate_frame(h, w)

    cfg = Config(enabled=True, render_scale=args.render_scale,
                 sharpness=args.sharpness, radius=args.radius,
                 use_nis=args.nis, debug_mode=True)
    pipe = Pipeline(cfg, device=args.device)
    print(f"input {frame.shape[1]}x{frame.shape[0]} -> "
          f"{pipe.output_size(frame.shape[1], frame.shape[0])}  "
          f"[{'NIS' if cfg.use_nis else 'FSR'}]  keys: n d - + [ ] c q "
          f"({pipe.device})")

    actions = {
        "n": pipe.toggle_nis,
        "d": pipe.toggle_debug,
        "-": lambda: pipe.adjust_sharpness(-0.05),
        "+": lambda: pipe.adjust_sharpness(+0.05),
        "[": lambda: pipe.adjust_radius(-0.05),
        "]": lambda: pipe.adjust_radius(+0.05),
    }

    scripted = list(args.keys)
    n = 0
    capture_next = False
    t0 = time.time()
    while True:
        out = pipe.process(frame)
        n += 1
        if capture_next:
            paths = save_frame(out, args.out, use_nis=pipe.config.use_nis,
                               sharpness=pipe.config.sharpness,
                               radius=pipe.config.radius)
            print("captured:", ", ".join(str(p) for p in paths))
            capture_next = False
        key = scripted.pop(0) if scripted else _poll_key()
        if key == "q":
            break
        if key == "c":
            capture_next = True  # captured on next frame, like the reference
        elif key in actions:
            actions[key]()
            c = pipe.config
            print(f"[{'NIS' if c.use_nis else 'FSR'}] sharpness={c.sharpness:.2f} "
                  f"radius={c.radius:.2f} debug={c.debug_mode}")
        if args.frames and n >= args.frames:
            break
    if pipe.device.type == "cuda":
        import torch
        torch.cuda.synchronize(pipe.device)
    dt = time.time() - t0
    print(f"{n} frames in {dt:.2f}s ({n / dt:.1f} fps incl. python overhead)")
    return pipe


if __name__ == "__main__":
    main()
