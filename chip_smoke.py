#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (openvr_fsr_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

The first run builds the CUDA kernel from openvr_fsr_tpu_torch/csrc with
nvcc (sm_90a) into openvr_fsr_tpu_torch/_build/. Phases, in order; any
failure exits non-zero before the result lines:

  1. setup: card, power limit, toolchain versions, the kernel build;
  2. the kernel against its plain torch version on the card, at the main
     path's full size (2 x 1683x1869 -> 2 x 2244x2492) for radius 0.5, 2.0
     and 0.0 and debug, on two frame sets, plus the ring-pitch input, a
     supersample (rs 1.3) case, and a small case against the CPU path;
  3. the main path through the public API: a Pipeline processes 20 stereo
     pairs as uint8 NHWC and as packed frames, plus one upscale() call,
     with the kernel's launch counts read around the run;
  4. kernel and plain-version times in ms per stereo pair (CUDA events);
  5. the result lines: the card, the kernels JSON, and {"ok": true, ...}.

Exits non-zero, printing no result, when torch finds no CUDA GPU.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 1869, 1683            # per-eye render size at renderScale 0.75
SHARPNESS = 0.9
PARITY_MIN_EQUAL = 0.99999   # fraction of equal texels, kernel vs plain
PARITY_MAX_LSB = 1


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi(query):
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi exited {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def lsb_diff(a, b):
    """(unequal texels, total texels, max LSB over the RGBA bytes) of two
    packed int32 tensors."""
    ne = int((a != b).sum())
    d = (a.view(torch.uint8).to(torch.int16)
         - b.view(torch.uint8).to(torch.int16)).abs()
    return ne, a.numel(), int(d.max())


def main():
    if not torch.cuda.is_available():
        fail("torch finds no CUDA GPU")
    from openvr_fsr_tpu_torch import Config, Pipeline, upscale
    from openvr_fsr_tpu_torch.core import constants as C
    from openvr_fsr_tpu_torch.kernels import _build
    from openvr_fsr_tpu_torch.kernels.fsr import build_fsr_fused
    from openvr_fsr_tpu_torch.utils import frames as FR

    dev = torch.device("cuda", 0)

    # ---- 1. setup ----------------------------------------------------------
    card = smi("name,power.limit")
    log(f"[setup] nvidia-smi: {card}")
    log(f"[setup] driver {smi('driver_version')}")
    log(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    log(f"[setup] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"[setup] device: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[setup] kernel library {_build.library_path().name} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    build_log = _build.library_path().with_suffix(".log")
    if build_log.exists():
        for line in build_log.read_text().splitlines()[1:]:   # nvcc output
            log(f"[setup]   {line.strip()}")

    cfg = Config(enabled=True, render_scale=0.75, sharpness=SHARPNESS,
                 radius=0.5)
    OW, OH = cfg.output_size(W, H)

    def build(b, h, w, ow, oh, radius, debug):
        cen = C.centres_payload(ow, oh, radius, ((0.5, 0.5), (0.5, 0.5)),
                                tuple(i % 2 for i in range(b)))
        return build_fsr_fused(b, h, w, ow, oh, sharpness=SHARPNESS,
                               centres=cen, debug=debug)

    def packed(frames_u8):
        return torch.from_numpy(np.ascontiguousarray(frames_u8)).to(dev) \
            .view(torch.int32)[..., 0].contiguous()

    # ---- 2. kernel vs plain version -----------------------------------------
    rng = np.random.default_rng(0)
    frame_sets = {
        "zone+noise": packed(np.stack([FR.zone_plate_frame(H, W),
                                       FR.noise_frame(H, W, seed=1)])),
        "uniform": packed(rng.integers(0, 256, (2, H, W, 4), dtype=np.uint8)),
    }
    cases = [(r, False) for r in (0.5, 2.0, 0.0)] + [(0.5, True)]
    max_lsb, kernel_out = 0, {}
    for radius, debug in cases:
        fn = build(2, H, W, OW, OH, radius, debug)
        for name, img in frame_sets.items():
            got = fn(img)
            want = fn.reference(img)
            torch.cuda.synchronize()
            if got.shape != (2, OH, OW) or got.device != img.device:
                fail(f"kernel output {tuple(got.shape)} on {got.device}")
            ne, n, mx = lsb_diff(got, want)
            log(f"[parity] full 2x{W}x{H}->2x{OW}x{OH} radius={radius} "
                f"debug={debug} {name}: unequal {ne} of {n} texels, "
                f"max {mx} LSB")
            if mx > PARITY_MAX_LSB or 1.0 - ne / n < PARITY_MIN_EQUAL:
                fail(f"kernel disagrees with its plain version ({ne}, {mx})")
            max_lsb = max(max_lsb, mx)
            kernel_out[(radius, debug, name)] = got
            del want
    # the ring pitch: the same frames pre-padded, read in place
    fn = build(2, H, W, OW, OH, 0.5, False)
    hp, wp = fn.pad_to
    ring = torch.zeros((2, hp, wp), dtype=torch.int32, device=dev)
    ring[:, :H, :W] = frame_sets["zone+noise"]
    ne, n, mx = lsb_diff(fn(ring), kernel_out[(0.5, False, "zone+noise")])
    log(f"[parity] ring pitch {hp}x{wp} vs unpadded: unequal {ne}, max {mx}")
    if ne:
        fail("the ring-pitch input changed the output")
    # supersample (rs 1.3) at a small size, and the card against the CPU path
    for (h, w, rs, radius) in ((360, 320, 1.3, 0.5), (96, 128, 0.75, 0.5)):
        c = Config(render_scale=rs)
        ow, oh = c.output_size(w, h)
        fn = build(2, h, w, ow, oh, radius, False)
        img = packed(rng.integers(0, 256, (2, h, w, 4), dtype=np.uint8))
        got = fn(img)
        for ref_name, want in (("plain cuda", fn.reference(img)),
                               ("plain cpu", fn(img.cpu()).to(dev))):
            ne, n, mx = lsb_diff(got, want)
            log(f"[parity] 2x{w}x{h}->2x{ow}x{oh} rs={rs} vs {ref_name}: "
                f"unequal {ne} of {n}, max {mx} LSB")
            if mx > PARITY_MAX_LSB or 1.0 - ne / n < PARITY_MIN_EQUAL:
                fail("kernel disagrees with its plain version")
            max_lsb = max(max_lsb, mx)

    # ---- 3. the main path through the public API ----------------------------
    n_pairs = 20
    gen = torch.Generator(device=dev).manual_seed(1)
    pairs_u8 = torch.randint(0, 256, (n_pairs, 2, H, W, 4), dtype=torch.uint8,
                             device=dev, generator=gen)
    pairs_u8[0] = frame_sets["zone+noise"].view(torch.uint8) \
        .view(2, H, W, 4)
    pairs_packed = pairs_u8.view(torch.int32)[..., 0]
    pipe = Pipeline(cfg, device="cuda")
    pipe.process(pairs_u8[0])                       # builds (not counted)
    pipe.process(pairs_packed[0].contiguous())
    for k in pipe.kernels:
        k.launches = 0
    outs_u8, outs_packed = [], []
    for i in range(n_pairs):
        outs_u8.append(pipe.process(pairs_u8[i]))
        outs_packed.append(pipe.process(pairs_packed[i].contiguous()))
    torch.cuda.synchronize()
    launches = sum(k.launches for k in pipe.kernels)
    log(f"[main] Pipeline.process: {2 * n_pairs} calls, kernel launches "
        f"{[k.launches for k in pipe.kernels]} (total {launches})")
    if launches != 2 * n_pairs or any(k.launches != n_pairs
                                      for k in pipe.kernels):
        fail("the main path did not launch the kernel once per call")
    for i, (a, p) in enumerate(zip(outs_u8, outs_packed)):
        if a.shape != (2, OH, OW, 4) or a.dtype != torch.uint8 \
                or not a.is_cuda:
            fail(f"uint8 output {tuple(a.shape)} {a.dtype} {a.device}")
        if p.shape != (2, OH, OW) or p.dtype != torch.int32 or not p.is_cuda:
            fail(f"packed output {tuple(p.shape)} {p.dtype} {p.device}")
        if not torch.equal(a.view(torch.int32)[..., 0], p):
            fail(f"pair {i}: uint8 and packed paths disagree")
        if not bool((a[..., 3] == 255).all()):
            fail(f"pair {i}: alpha is not 255")
    if not torch.equal(outs_packed[0], kernel_out[(0.5, False, "zone+noise")]):
        fail("Pipeline output differs from the kernel's at the same config")
    up = upscale(pairs_u8[0], render_scale=0.75, sharpness=SHARPNESS,
                 radius=0.5, device="cuda")
    torch.cuda.synchronize()
    if not up.is_cuda or not torch.equal(up, outs_u8[0]):
        fail("upscale() differs from Pipeline.process")
    log(f"[main] upscale(): {tuple(up.shape)} {up.dtype} on {up.device}, "
        "equal to Pipeline.process")
    dbg = Pipeline(cfg.with_(debug_mode=True), device="cuda")
    dbg.process(pairs_u8[1])
    if dbg.timer.count != 1 or not dbg.timer.summed > 0:
        fail("debug-mode GpuTimer recorded no CUDA time")
    log(f"[main] debug-mode GpuTimer: {dbg.timer.summed * 1e3:.3f} ms/pair "
        "(first call)")

    # ---- 4. times -----------------------------------------------------------
    fn = build(2, H, W, OW, OH, 0.5, False)
    img = frame_sets["zone+noise"]

    def time_ms(f, n, warmup):
        for _ in range(warmup):
            f(img)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            f(img)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    rounds = {"kernel": [], "plain": []}
    for label, f, n in (("kernel", fn, 200), ("plain", fn.reference, 10),
                        ("kernel", fn, 200), ("plain", fn.reference, 10)):
        rounds[label].append(time_ms(f, n, warmup=3))
    ms = float(np.mean(rounds["kernel"]))
    plain_ms = float(np.mean(rounds["plain"]))
    mbytes = (2 * H * W + 2 * OH * OW) * 4 / 1e6
    log(f"[time] card: {card}")
    log(f"[time] fused kernel: {rounds['kernel']} ms per stereo pair "
        f"({mbytes:.1f} MB moved -> {mbytes / ms:.1f} GB/s)")
    log(f"[time] plain torch : {rounds['plain']} ms per stereo pair")
    # the share of EASU work: radius 2.0 runs EASU + RCAS on every pixel,
    # radius 0.0 only the bilinear fallback
    for radius in (2.0, 0.0):
        t = time_ms(build(2, H, W, OW, OH, radius, False), 200, warmup=3)
        log(f"[time] fused kernel radius={radius}: {t} ms per stereo pair")
    torch.cuda.reset_peak_memory_stats()
    fn.reference(img)
    torch.cuda.synchronize()
    log(f"[time] plain torch peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 5. result lines ----------------------------------------------------
    log(card)
    log(json.dumps({"kernels": [{
        "name": "fsr_fused",
        "route": "cuda",
        "source": "openvr_fsr_tpu_torch/csrc/fsr_fused.cu",
        "replaces": "openvr_fsr_tpu/kernels/fsr.py:191",
        "launches": launches,
        "max_abs_err": max_lsb,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
