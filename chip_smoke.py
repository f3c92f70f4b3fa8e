#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (openvr_fsr_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

The run builds the CUDA kernels from openvr_fsr_tpu_torch/csrc with nvcc
(sm_90a), one nvcc per source, all at once, into openvr_fsr_tpu_torch/
_build/. Phases, in order; any failure exits non-zero before the result
lines:

  1. setup: card, power limit, toolchain versions, the kernel builds;
  2. each kernel against its plain torch version on the card, at full
     size, on a zone-plate + noise set and a uniform-random set, both with
     alpha that is not all 255:
       fsr_fused    2 x 1683x1869 -> 2 x 2244x2492, radius 0.5, 2.0, 0.0
                    and 0.5 with debug; plus a supersample (rs 1.3) case;
       rcas_sharpen 2 x 2244x2492, radius 0.4, 2.0, 0.0 and 0.4 with debug;
       nis_sharpen  the same, hdr_mode 0, plus radius 2.0 at hdr_mode 1, 2;
       nis_scaler   2 x 1683x1869 -> 2 x 2244x2492, radius 0.5, 2.0, 0.0
                    and 0.5 with debug, hdr_mode 0, plus radius 2.0 at
                    hdr_mode 1 and 2;
       cas_upscale  2 x 1683x1869 -> 2 x 2244x2492 (sharpness 0.8), radius
                    0.5, 2.0, 0.0 and 0.5 with debug; plus rs 1.3 and a
                    scale above CAS's 4x area limit (rs 0.4);
       cas_sharpen  2 x 2244x2492 (sharpness 0.8), radius 0.4, 2.0, 0.0 and
                    0.4 with debug; plus max_color_delta 0.05, which must
                    change the output;
     and for each kernel a ring-pitch input and small cases (one with a
     bright border) against the CPU path;
  3. the plans through the public API, each with the launch counts set to
     0 just before and read just after: FSR rs 0.75, FSR rs 1, NIS rs 0.75,
     NIS rs 1, CasModel() (rs 1) and CasModel(render_scale=0.75) process 10
     stereo pairs as uint8 NHWC and as packed frames; toggle_nis() on a
     live Pipeline; upscale(use_nis=True), get_model("cas") and
     upscale(use_cas=True);
  4. kernel and plain-version times in ms per stereo pair (CUDA events),
     and each plain version's peak device memory;
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
OH, OW = 2492, 2244          # the headset's per-eye size (renderScale 1)
SHARPNESS = 0.9
CAS_SHARPNESS = 0.8          # CasModel's default
PARITY_MIN_EQUAL = 0.99999   # fraction of equal texels, kernel vs plain
PARITY_MAX_LSB = 1
N_PAIRS = 10                 # stereo pairs per plan through the public API
CENTRES = ((0.5, 0.5), (0.5, 0.5))


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


def time_ms(f, x, n, warmup=3):
    """CUDA-event ms per call of f(x) over n back-to-back calls."""
    for _ in range(warmup):
        f(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        f(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main():
    if not torch.cuda.is_available():
        fail("torch finds no CUDA GPU")
    from openvr_fsr_tpu_torch import (CasModel, Config, Pipeline, get_model,
                                      upscale)
    from openvr_fsr_tpu_torch.core import constants as C
    from openvr_fsr_tpu_torch.kernels import _build
    from openvr_fsr_tpu_torch.kernels.cas import (build_cas_sharpen,
                                                  build_cas_upscale)
    from openvr_fsr_tpu_torch.kernels.fsr import build_fsr_fused
    from openvr_fsr_tpu_torch.kernels.nis import build_nvscaler, build_nvsharpen
    from openvr_fsr_tpu_torch.kernels.rcas import build_rcas_sharpen
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
    _build.build()
    log(f"[setup] kernels {_build.kernel_names()} built in parallel in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _build.kernel_names():
        build_log = _build.library_path(name).with_suffix(".log")
        if build_log.exists():
            for line in build_log.read_text().splitlines()[1:]:  # nvcc output
                log(f"[setup]   {name}: {line.strip()}")

    def centres(ow, oh, radius, b=2):
        return C.centres_payload(ow, oh, radius, CENTRES,
                                 tuple(i % 2 for i in range(b)))

    def fsr(radius, debug=False, h=H, w=W, rs=0.75):
        ow, oh = Config(render_scale=rs).output_size(w, h)
        return build_fsr_fused(2, h, w, ow, oh, sharpness=SHARPNESS,
                               centres=centres(ow, oh, radius), debug=debug)

    def rcas(radius, debug=False, h=OH, w=OW):
        return build_rcas_sharpen(2, h, w, sharpness=SHARPNESS,
                                  centres=centres(w, h, radius), debug=debug)

    def sharpen(radius, debug=False, hdr=0, h=OH, w=OW):
        cfg = C.nvsharpen_update_config(SHARPNESS, w, h, w, h, hdr_mode=hdr)
        return build_nvsharpen(2, h, w, nis_cfg=cfg,
                               centres=centres(w, h, radius), debug=debug)

    def scaler(radius, debug=False, hdr=0, h=H, w=W, rs=0.75):
        ow, oh = Config(render_scale=rs).output_size(w, h)
        cfg = C.nvscaler_update_config(SHARPNESS, w, h, w, h, ow, oh, ow, oh,
                                       hdr_mode=hdr)
        return build_nvscaler(2, h, w, ow, oh, nis_cfg=cfg,
                              centres=centres(ow, oh, radius), debug=debug)

    def cas_up(radius, debug=False, h=H, w=W, rs=0.75):
        ow, oh = Config(render_scale=rs).output_size(w, h)
        return build_cas_upscale(2, h, w, ow, oh, sharpness=CAS_SHARPNESS,
                                 centres=centres(ow, oh, radius), debug=debug)

    def cas_sh(radius, debug=False, mcd=1.0, h=OH, w=OW):
        return build_cas_sharpen(2, h, w, sharpness=CAS_SHARPNESS,
                                 centres=centres(w, h, radius), debug=debug,
                                 max_color_delta=mcd)

    rng = np.random.default_rng(0)

    def packed(frames_u8):
        return torch.from_numpy(np.ascontiguousarray(frames_u8)).to(dev) \
            .view(torch.int32)[..., 0].contiguous()

    def frame_sets(h, w):
        zone = np.stack([FR.zone_plate_frame(h, w),
                         FR.noise_frame(h, w, seed=1)])
        zone[..., 3] = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
        return {"zone+noise": packed(zone),
                "uniform": packed(rng.integers(0, 256, (2, h, w, 4),
                                               dtype=np.uint8))}

    # ---- 2. each kernel against its plain version ---------------------------
    sets = {"in": frame_sets(H, W), "full": frame_sets(OH, OW)}
    max_lsb = {"fsr_fused": 0, "rcas_sharpen": 0, "nis_sharpen": 0,
               "nis_scaler": 0, "cas_upscale": 0, "cas_sharpen": 0}

    def parity(kernel, label, fn, img):
        got = fn(img)
        want = fn.reference(img)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.device != img.device:
            fail(f"{kernel} output {tuple(got.shape)} on {got.device}")
        ne, n, mx = lsb_diff(got, want)
        log(f"[parity] {kernel} {label}: unequal {ne} of {n} texels, "
            f"max {mx} LSB")
        if mx > PARITY_MAX_LSB or 1.0 - ne / n < PARITY_MIN_EQUAL:
            fail(f"{kernel} disagrees with its plain version ({ne}, {mx})")
        max_lsb[kernel] = max(max_lsb[kernel], mx)
        return got

    cases = [(r, False) for r in (0.5, 2.0, 0.0)] + [(0.5, True)]
    sharpen_cases = [(r, False) for r in (0.4, 2.0, 0.0)] + [(0.4, True)]
    kernel_out = {}
    for radius, debug in cases:
        for name, img in sets["in"].items():
            kernel_out["fsr", radius, debug, name] = parity(
                "fsr_fused", f"2x{W}x{H}->2x{OW}x{OH} radius={radius} "
                f"debug={debug} {name}", fsr(radius, debug), img)
            parity("nis_scaler", f"2x{W}x{H}->2x{OW}x{OH} radius={radius} "
                   f"debug={debug} hdr=0 {name}", scaler(radius, debug), img)
            kernel_out["cas_up", radius, debug, name] = parity(
                "cas_upscale", f"2x{W}x{H}->2x{OW}x{OH} radius={radius} "
                f"debug={debug} {name}", cas_up(radius, debug), img)
    for radius, debug in sharpen_cases:
        for name, img in sets["full"].items():
            parity("rcas_sharpen", f"2x{OW}x{OH} radius={radius} "
                   f"debug={debug} {name}", rcas(radius, debug), img)
            parity("nis_sharpen", f"2x{OW}x{OH} radius={radius} "
                   f"debug={debug} hdr=0 {name}", sharpen(radius, debug), img)
            kernel_out["cas_sh", radius, debug, name] = parity(
                "cas_sharpen", f"2x{OW}x{OH} radius={radius} "
                f"debug={debug} {name}", cas_sh(radius, debug), img)
    for name, img in sets["full"].items():
        got = parity("cas_sharpen", f"2x{OW}x{OH} radius=2.0 "
                     f"max_color_delta=0.05 {name}", cas_sh(2.0, mcd=0.05),
                     img)
        if torch.equal(got, kernel_out["cas_sh", 2.0, False, name]):
            fail("cas_sharpen: max_color_delta 0.05 left the output as it "
                 "was at 1.0")
    for hdr in (1, 2):
        for name in ("zone+noise", "uniform"):
            parity("nis_scaler", f"2x{W}x{H}->2x{OW}x{OH} radius=2.0 "
                   f"hdr={hdr} {name}", scaler(2.0, hdr=hdr), sets["in"][name])
            parity("nis_sharpen", f"2x{OW}x{OH} radius=2.0 hdr={hdr} {name}",
                   sharpen(2.0, hdr=hdr), sets["full"][name])

    # the ring pitch: the same frames pre-padded, read in place
    for kernel, fn, img in (("fsr_fused", fsr(0.5), sets["in"]["zone+noise"]),
                            ("nis_scaler", scaler(0.5), sets["in"]["zone+noise"]),
                            ("rcas_sharpen", rcas(0.4), sets["full"]["zone+noise"]),
                            ("nis_sharpen", sharpen(0.4), sets["full"]["zone+noise"]),
                            ("cas_upscale", cas_up(0.5), sets["in"]["zone+noise"]),
                            ("cas_sharpen", cas_sh(0.4), sets["full"]["zone+noise"])):
        hp, wp = fn.pad_to
        h, w = img.shape[1:]
        ring = torch.zeros((2, hp, wp), dtype=torch.int32, device=dev)
        ring[:, :h, :w] = img
        ne, n, mx = lsb_diff(fn(ring), fn(img))
        log(f"[parity] {kernel} ring pitch {hp}x{wp} vs unpadded: "
            f"unequal {ne}, max {mx}")
        if ne:
            fail(f"{kernel}: the ring-pitch input changed the output")
    # supersample (rs 1.3) and CAS above its 4x area limit (rs 0.4) at
    # small sizes, and the card against the CPU path, on random frames and
    # on a bright border around a dark interior (CAS reads 0 outside)
    small = packed(rng.integers(0, 256, (2, 96, 128, 4), dtype=np.uint8))
    border = np.full((2, 96, 128, 4), 20, np.uint8)
    border[:, :2], border[:, -2:], border[:, :, :2], border[:, :, -2:] = \
        250, 240, 230, 245
    border[..., 3] = rng.integers(0, 256, (2, 96, 128), dtype=np.uint8)
    border = packed(border)
    supersample = packed(rng.integers(0, 256, (2, 360, 320, 4),
                                      dtype=np.uint8))
    checks = [
        ("fsr_fused", "2x320x360 rs=1.3", fsr(0.5, h=360, w=320, rs=1.3),
         supersample),
        ("cas_upscale", "2x320x360 rs=1.3",
         cas_up(0.5, h=360, w=320, rs=1.3), supersample),
        ("cas_upscale", "2x128x96 rs=0.4 (above the 4x area limit)",
         cas_up(2.0, h=96, w=128, rs=0.4), small),
        ("cas_upscale", "2x128x96 rs=0.75", cas_up(0.5, h=96, w=128), small),
        ("cas_upscale", "2x128x96 rs=0.75 bright border",
         cas_up(2.0, h=96, w=128), border),
        ("cas_sharpen", "2x128x96", cas_sh(0.4, h=96, w=128), small),
        ("cas_sharpen", "2x128x96 bright border, max_color_delta=0.05",
         cas_sh(2.0, mcd=0.05, h=96, w=128), border),
        ("fsr_fused", "2x128x96 rs=0.75", fsr(0.5, h=96, w=128), small),
        ("rcas_sharpen", "2x128x96", rcas(0.4, h=96, w=128), small),
        ("nis_sharpen", "2x128x96", sharpen(0.4, h=96, w=128), small),
        ("nis_scaler", "2x128x96 rs=0.75", scaler(0.5, h=96, w=128), small),
    ]
    for kernel, label, fn, img in checks:
        got = fn(img)
        for ref_name, want in (("plain cuda", fn.reference(img)),
                               ("plain cpu", fn(img.cpu()).to(dev))):
            ne, n, mx = lsb_diff(got, want)
            log(f"[parity] {kernel} {label} vs {ref_name}: unequal {ne} of "
                f"{n}, max {mx} LSB")
            if mx > PARITY_MAX_LSB or 1.0 - ne / n < PARITY_MIN_EQUAL:
                fail(f"{kernel} disagrees with its plain version")
            max_lsb[kernel] = max(max_lsb[kernel], mx)

    # ---- 3. the plans through the public API --------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)

    def pairs_of(h, w, first):
        u8 = torch.randint(0, 256, (N_PAIRS, 2, h, w, 4), dtype=torch.uint8,
                           device=dev, generator=gen)
        u8[0] = first.view(torch.uint8).view(2, h, w, 4)
        return u8

    def plan_of(cfg):
        pipe = Pipeline(cfg, device="cuda")
        return pipe.process, pipe

    def model_of(**kw):
        model = CasModel(device="cuda", **kw)
        return model, model.pipeline

    pairs_in = pairs_of(H, W, sets["in"]["zone+noise"])
    pairs_full = pairs_of(OH, OW, sets["full"]["zone+noise"])
    plans = {   # kernel -> (entry point, its Pipeline), input pairs
        "fsr_fused": (plan_of(Config(enabled=True, render_scale=0.75,
                                     sharpness=SHARPNESS, radius=0.5)),
                      pairs_in),
        "rcas_sharpen": (plan_of(Config(enabled=True, render_scale=1.0,
                                        sharpness=SHARPNESS, radius=0.5)),
                         pairs_full),
        "nis_scaler": (plan_of(Config(enabled=True, use_nis=True,
                                      render_scale=0.75, sharpness=SHARPNESS,
                                      radius=0.5)), pairs_in),
        "nis_sharpen": (plan_of(Config(enabled=True, use_nis=True,
                                       render_scale=1.0, sharpness=SHARPNESS,
                                       radius=0.5)), pairs_full),
        # the CAS family's own entry point at its defaults (sharpness 0.8,
        # radius 2.0): rs 1 runs B6, rs 0.75 runs B5
        "cas_sharpen": (model_of(), pairs_full),
        "cas_upscale": (model_of(render_scale=0.75), pairs_in),
    }
    launches, first_out = {}, {}
    for kernel, ((call, pipe), pairs_u8) in plans.items():
        pairs_packed = pairs_u8.view(torch.int32)[..., 0]
        call(pairs_u8[0])                           # builds (not counted)
        call(pairs_packed[0].contiguous())
        for k in pipe.kernels:
            k.launches = 0
        outs_u8, outs_packed = [], []
        for i in range(N_PAIRS):
            outs_u8.append(call(pairs_u8[i]))
            outs_packed.append(call(pairs_packed[i].contiguous()))
        torch.cuda.synchronize()
        counts = [k.launches for k in pipe.kernels]
        launches[kernel] = sum(counts)
        log(f"[main] {kernel} plan: {2 * N_PAIRS} calls, kernel launches "
            f"{counts}")
        if counts != [N_PAIRS, N_PAIRS]:
            fail(f"the {kernel} plan did not launch its kernel once per call")
        for i, (a, p) in enumerate(zip(outs_u8, outs_packed)):
            if a.shape != (2, OH, OW, 4) or a.dtype != torch.uint8 \
                    or not a.is_cuda:
                fail(f"{kernel} uint8 output {tuple(a.shape)} {a.dtype}")
            if p.shape != (2, OH, OW) or p.dtype != torch.int32 \
                    or not p.is_cuda:
                fail(f"{kernel} packed output {tuple(p.shape)} {p.dtype}")
            if not torch.equal(a.view(torch.int32)[..., 0], p):
                fail(f"{kernel} pair {i}: uint8 and packed paths disagree")
        first_out[kernel] = outs_u8[0]
        # the plan's output is the kernel's at the same config, and is
        # sane: finite texels, alpha routed per plan
        fn = pipe.kernels[1]
        if not torch.equal(outs_packed[0], fn(pairs_packed[0].contiguous())):
            fail(f"{kernel}: Pipeline output differs from its kernel's")
        alphas = outs_u8[0][..., 3].unique().numel()
        log(f"[main] {kernel} plan: output {tuple(outs_u8[0].shape)}, "
            f"{alphas} distinct alpha values")
    for kernel, key in (("fsr_fused", ("fsr", 0.5, False, "zone+noise")),
                        ("cas_upscale", ("cas_up", 2.0, False, "zone+noise")),
                        ("cas_sharpen", ("cas_sh", 2.0, False, "zone+noise"))):
        if not torch.equal(first_out[kernel].view(torch.int32)[..., 0],
                           kernel_out[key]):
            fail(f"the {kernel} plan differs from its kernel at the same "
                 "config in phase 2")

    # the NIS hotkey on a live pipeline, and the one-shot API
    pipe = Pipeline(plans["fsr_fused"][0][1].config, device="cuda")
    x = pairs_in[0]
    pipe.process(x)
    pipe.toggle_nis()
    got = pipe.process(x)
    torch.cuda.synchronize()
    if [k.launches for k in pipe.kernels] != [1] \
            or not torch.equal(got, first_out["nis_scaler"]):
        fail("toggle_nis() did not switch the live pipeline to NVScaler")
    log("[main] toggle_nis(): the live pipeline now launches NVScaler, "
        "equal to the NIS plan")
    up = upscale(x, render_scale=0.75, sharpness=SHARPNESS, radius=0.5,
                 use_nis=True, device="cuda")
    torch.cuda.synchronize()
    if not up.is_cuda or not torch.equal(up, first_out["nis_scaler"]):
        fail("upscale(use_nis=True) differs from Pipeline.process")
    log(f"[main] upscale(use_nis=True): {tuple(up.shape)} {up.dtype}, equal "
        "to Pipeline.process")
    # the CAS family by name, and the one-shot API with use_cas
    model = get_model("cas", device="cuda")
    got = model(pairs_full[0])
    torch.cuda.synchronize()
    if [k.launches for k in model.pipeline.kernels] != [1] \
            or not torch.equal(got, first_out["cas_sharpen"]):
        fail("get_model('cas') differs from CasModel()")
    for rs, kernel, x in ((None, "cas_sharpen", pairs_full[0]),
                          (0.75, "cas_upscale", pairs_in[0])):
        up = upscale(x, render_scale=rs, sharpness=CAS_SHARPNESS, radius=2.0,
                     use_cas=True, device="cuda")
        torch.cuda.synchronize()
        if not up.is_cuda or not torch.equal(up, first_out[kernel]):
            fail(f"upscale(use_cas=True, render_scale={rs}) differs from "
                 "Pipeline.process")
    log("[main] get_model('cas') and upscale(use_cas=True) at rs 1 and 0.75 "
        "equal the CasModel plans")
    dbg = Pipeline(plans["nis_sharpen"][0][1].config.with_(debug_mode=True),
                   device="cuda")
    dbg.process(pairs_full[0])
    if dbg.timer.count != 1 or not dbg.timer.summed > 0:
        fail("debug-mode GpuTimer recorded no CUDA time")

    # ---- 4. times -----------------------------------------------------------
    timed = {   # kernel -> (build at the default config, input)
        "fsr_fused": (fsr(0.5), sets["in"]["zone+noise"]),
        "rcas_sharpen": (rcas(0.5), sets["full"]["zone+noise"]),
        "nis_sharpen": (sharpen(0.5), sets["full"]["zone+noise"]),
        "nis_scaler": (scaler(0.5), sets["in"]["zone+noise"]),
        "cas_upscale": (cas_up(0.5), sets["in"]["zone+noise"]),
        "cas_sharpen": (cas_sh(0.5), sets["full"]["zone+noise"]),
    }
    ms, plain_ms = {}, {}
    log(f"[time] card: {card}")
    for kernel, (fn, img) in timed.items():
        rounds = {"kernel": [], "plain": []}
        for label, f, n in (("plain", fn.reference, 5), ("kernel", fn, 200),
                            ("kernel", fn, 200), ("plain", fn.reference, 5)):
            rounds[label].append(time_ms(f, img, n))
        ms[kernel] = float(np.mean(rounds["kernel"]))
        plain_ms[kernel] = float(np.mean(rounds["plain"]))
        mbytes = (img.numel() + fn(img).numel()) * 4 / 1e6
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn.reference(img)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"[time] {kernel} radius 0.5: kernel {rounds['kernel']} ms per "
            f"stereo pair ({mbytes:.1f} MB moved -> "
            f"{mbytes / ms[kernel]:.1f} GB/s); plain torch "
            f"{rounds['plain']} ms, peak {peak:.2f} GiB above its input")
    for radius in (2.0, 0.0):
        for kernel, build in (("fsr_fused", fsr), ("rcas_sharpen", rcas),
                              ("nis_sharpen", sharpen),
                              ("nis_scaler", scaler),
                              ("cas_upscale", cas_up),
                              ("cas_sharpen", cas_sh)):
            img = timed[kernel][1]
            fn = build(radius)
            t = time_ms(fn, img, 200)
            plain = (f", plain torch {time_ms(fn.reference, img, 5)} ms"
                     if kernel.startswith("cas") else "")
            log(f"[time] {kernel} radius={radius}: {t} ms per stereo "
                f"pair{plain}")

    # ---- 5. result lines ----------------------------------------------------
    sources = {
        "fsr_fused": "openvr_fsr_tpu/kernels/fsr.py:191",
        "rcas_sharpen": "openvr_fsr_tpu/kernels/rcas.py:35",
        "nis_sharpen": "openvr_fsr_tpu/kernels/nis.py:125",
        "nis_scaler": "openvr_fsr_tpu/kernels/nis.py:371",
        "cas_upscale": "openvr_fsr_tpu/kernels/cas.py:67",
        "cas_sharpen": "openvr_fsr_tpu/kernels/cas.py:418",
    }
    log(card)
    log(json.dumps({"kernels": [{
        "name": kernel,
        "route": "cuda",
        "source": f"openvr_fsr_tpu_torch/csrc/{kernel}.cu",
        "replaces": replaces,
        "launches": launches[kernel],
        "max_abs_err": max_lsb[kernel],
        "ms": ms[kernel],
        "plain_ms": plain_ms[kernel],
    } for kernel, replaces in sources.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
