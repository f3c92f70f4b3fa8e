#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (openvr_fsr_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

The run builds the CUDA kernels from openvr_fsr_tpu_torch/csrc with nvcc
(sm_90a), one nvcc per source, all at once, into openvr_fsr_tpu_torch/
_build/. Phases, in order; any failure exits non-zero before the result
lines:

  1. setup: card, power limit, toolchain versions, the kernel builds, and
     the registers, spills and CTAs per SM of the two class kernels of each
     upscaler (fsr_fused, nis_scaler, cas_upscale: the shared bilinear pass
     outside the foveation circle, and the kernel inside it) and of
     nis_sharpen, cas_sharpen and rcas_sharpen (the shared copy pass
     outside, the kernel inside), each at both texel formats (the RGBA8
     and R10G10B10A2 instantiations; a warning where the 10-bit one holds
     fewer CTAs per SM), and the registers and spills of fsr_fused's and
     cas_upscale's band instantiations (the row-band strips');
  2. each kernel against its plain torch version on the card, at full
     size, on a zone-plate + noise set and a uniform-random set, both with
     alpha that is not all 255:
       fsr_fused    2 x 1683x1869 -> 2 x 2244x2492, radius 0.5, 2.0, 0.0
                    and 0.5 with debug; two off-centre eyes at radius 0.3
                    (circle edges through many tiles); batch 4 (both sets
                    in one batch); plus a supersample (rs 1.3) case; 0
                    unequal texels, every case;
       rcas_sharpen 2 x 2244x2492, radius 0.4, 2.0, 0.0 and 0.4 with debug;
                    off-centre eyes at radius 0.3 (circle edges through
                    many 32x32 tiles of 16x16 groups) and batch 4; 0
                    unequal texels, every case;
       nis_sharpen  the same, hdr_mode 0, plus radius 0.5 and 2.0 at
                    hdr_mode 1 and 2; off-centre eyes at radius 0.3 and
                    batch 4; 0 unequal texels, every case;
       nis_scaler   2 x 1683x1869 -> 2 x 2244x2492, radius 0.5, 2.0, 0.0
                    and 0.5 with debug, hdr_mode 0, plus radius 2.0 at
                    hdr_mode 1 and 2; off-centre eyes at radius 0.3 (hdr 0,
                    1, 2) and batch 4; 0 unequal texels, every case;
       cas_upscale  2 x 1683x1869 -> 2 x 2244x2492 (sharpness 0.8), radius
                    0.5, 2.0, 0.0 and 0.5 with debug; off-centre eyes at
                    radius 0.3 and batch 4; the full-size supersample (rs
                    1.3); plus rs 1.3 and a scale above CAS's 4x area limit
                    (rs 0.4) small; 0 unequal texels, every case;
       cas_sharpen  2 x 2244x2492 (sharpness 0.8), radius 0.4, 2.0, 0.0 and
                    0.4 with debug; off-centre eyes at radius 0.3 (circle
                    edges through many 32x32 tiles of 16x16 groups) and
                    batch 4; plus max_color_delta 0.05, which must change
                    the output; 0 unequal texels, every case;
     and for each kernel a ring-pitch input and small cases (one with a
     bright border) against the CPU path; and, in a fresh process, a first
     NVScaler call on a side stream (torch.cuda.Stream()), 0 unequal
     texels: nothing the kernel reads may be ordered on another stream;
     then the six 10-bit kernels (color_bits=10, (2, H, W, 4) uint16)
     against their plain versions at full size, value for value: radius
     0.5, 2.0, 0.0 and 0.5 with debug, off-centre eyes at radius 0.3,
     NIS hdr 1, on a 10-bit zone plate + noise set and a uniform set (alpha
     in {0..3}; 1% of values above 1023, which saturate), the ring pitch,
     small frames over the whole uint16 range and a bright border against
     the CPU path, CAS max_color_delta 0.05; 0 unequal values, every case;
  2b. the row-band strips of fsr_fused and cas_upscale (band_range: the
     same two kernels on an input strip, storing a band of output rows),
     each strip build on its input strip against the single launch on the
     card, 0 unequal texels: 3 strips at the default band_rows at radius
     0.5, 2.0, 0.0 and 0.5 with debug, off-centre eyes at radius 0.3 and the
     full supersample (rs 1.3); every 32-row band alone; 24-row bands,
     whose edges cut the kernels' 32-row tiles (at 8 and at 10 bits); small
     strips against the plain version on the CPU. Then the spatial path's
     entry point, SpatialFsrPipeline with 3 strips on this card for FSR and
     CAS at 2 x 1683x1869 -> 2 x 2244x2492, its launch counts set to 0 just
     before 10 steady-state process_placed calls under
     torch.cuda.set_sync_debug_mode("error") (no host sync) and read just
     after, equal to Pipeline.process; the strips' summed device time
     beside the single launch's; ShardedPipeline over [cuda:0] * 2 and
     FsrModel().sharded() at batch 4, equal to Pipeline.process; and
     tools.spatial_onchip, in this process;
  3. the plans through the public API, each with the launch counts set to
     0 just before and read just after: FSR rs 0.75, FSR rs 1, NIS rs 0.75,
     NIS rs 1, CasModel() (rs 1) and CasModel(render_scale=0.75) process 10
     stereo pairs as uint8 NHWC and as packed frames; toggle_nis() on a
     live Pipeline; upscale(use_nis=True), get_model("cas") and
     upscale(use_cas=True); Pipeline(cfg), upscale(frame) and FsrModel() on
     numpy frames. No entry point is given a device: each must default to
     the card and launch its CUDA kernel. Then deferred capture on the
     card (arm_capture), for the uint8 and the packed int32 input: a
     right-eye-only batch writes no file, the next stereo batch writes one
     DDS whose texels (read_dds_rgba8) equal the eye-0 output byte for
     byte. The six plans again at 10 bits through Pipeline(color_bits=10)
     (10 stereo pairs each, launch counts from 0) and
     upscale(color_bits=10), with no device, and a 10-bit capture read
     back as R10G10B10A2, its payload byte-equal to the packed output;
  4. kernel and plain-version times in ms per stereo pair (CUDA events;
     a kernel's calls replayed from one CUDA graph, device time alone),
     and each plain version's peak device memory; fsr_fused also at rs 1.3;
     the six 10-bit kernels at radius 0.5 with their plain versions;
  5. the measurement path: the DMA floor (csrc/dma_floor.cu) keeps its
     TMA loads, shared reads and stores in its SASS, and equals its plain
     version word for word at the full-size geometry of each of the seven
     bench paths, on the ring-pitch input and on the unpadded one where its
     row pitch is a multiple of 16 bytes (the floor refuses any other with
     a ValueError, as it publishes: fn.pitch_words), and at the geometries
     of the three upscalers and of nis_sharpen, cas_sharpen and
     rcas_sharpen at radius 0.0 and 2.0;
     the fused kernel against its plain version at the full supersample
     size (2 x 2244x2492 -> 2 x 2917x3239); fsr_fused and its floor timed in
     turns (bench.measure: each from its CUDA graph, the best of B_ROUNDS
     replays, device time alone) at radius 0.0,
     0.5 and 2.0 and at rs 1.3 ([b1] lines), nis_scaler, cas_upscale,
     nis_sharpen, cas_sharpen and rcas_sharpen with theirs at radius 0.0,
     0.5 and 2.0 ([b3], [b5], [b4], [b6], [b2] lines), with their vs_sol;
     the floor's time at the fsr_fused geometry on a ring-pitch frame (also
     call by call, bench_fn) and the card's pure-read and pure-write rates
     (hbm_calibration); then the bench entries, bench.main() and
     tools.bench_paths.main() over all seven paths, in this process,
     printing their JSON lines, each with value (back to back, the host's
     cost of a call included) and device_ms (from the CUDA graph) and
     their difference, the host's cost per call that the card's work does
     not hide; and, per path,
     Pipeline.process's host time to enqueue a call (no sync) and its
     back-to-back time;
     the 10-bit floors word for word against their plain version at the
     six plans' 10-bit geometries at radius 0.0, 0.5 and 2.0, and the six
     10-bit kernels timed in turns with their floors at the same radii
     (the 10-bit [bN] lines; vs_sol at most 1.02);
     every path's kernel and floor must have launched in that run, value
     must be at least 0.98 x device_ms, vs_sol must be the floor's graph
     time over device_ms, and none may read vs_sol above 1.02 (a floor
     slower than its kernel is a wrong floor);
  6. the NumPy oracle at full size and the throughput tool: two cases of
     tools/parity.py through Pipeline.process on the card against the
     port's copy of the oracle (oracle/pipeline.py, computed on the host):
     fsr_fused_zone_r0.5 (0 unequal values), nvscaler_noise (at most 1
     LSB) and fsr_fused_noise10_r0.5 (0 unequal), each with its kernel
     launched; then tools.throughput_bench at
     batch 8, in this process, printing its JSON line;
  7. the rate probes (B8) and the audit: each probe (csrc/vpu_rate.cu,
     vmem_rate.cu, mxu_rate.cu) against its plain version at the audit's
     full k and steps (FP32 and shared-memory probes: 0 unequal; the
     tensor-core probe within kernels/sol.py::MXU_TOLERANCE, also at small
     k, where its values have not underflowed); the SASS of each keeps
     what it meters (FP32 arithmetic per cycle, LDS in the plane loop, 8
     HGMMA per round), the shared-memory probe's loops, the instruction
     counts of the inside kernels of B1-B6, and each one's float
     instructions per inside output beside the op meter's count that
     prices its f32 work (tools/sass.py::inside_float_per_output); each
     probe's and its plain
     version's time, and
     torch.matmul on one round's bf16 operands beside the tensor-core
     probe, and cuBLAS's MAC rate on one (8192, 8192) bf16 product; then
     tools.vpu_audit.main() and main(["--nis", "--quick"]) in this process,
     failing on a missing launch, a rate that is not finite, a pair spread
     above 1.5, a rate above 1.05 x its bound, or a kernel row whose bound
     is above 1.05 x its time;
  8. the result lines: the card, the kernels JSON (the 10-bit
     instantiations as <kernel>_10bit, the strips of the spatial path as
     fsr_fused_band and cas_upscale_band, their ms the strips' summed device
     time and their bytes the strips' rows; each bound the largest
     of its unique bytes over 3.35 TB/s, its operations over the peak for
     their type: f32 work, the FP32 probe's as the FP32 instructions its
     SASS keeps per cycle, at the FP32 issue bound SMs x 128 lanes x the
     max SM clock, bf16 MACs at SMs x 2,048 x the max SM clock, and, for the
     shared-memory probe, the plane bytes it reads over SMs x 128 B x the
     max SM clock: tools/vpu_audit.py::roofline_bound, probe_bounds), and
     {"ok": true, ...}.

Exits non-zero, printing no result, when torch finds no CUDA GPU.
"""

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

H, W = 1869, 1683            # per-eye render size at renderScale 0.75
OH, OW = 2492, 2244          # the headset's per-eye size (renderScale 1)
SHARPNESS = 0.9
CAS_SHARPNESS = 0.8          # CasModel's default
PARITY_MIN_EQUAL = 0.99999   # fraction of equal texels, kernel vs plain
PARITY_MAX_LSB = 1
EXACT = ("fsr_fused", "nis_scaler", "cas_upscale", "nis_sharpen",
         "cas_sharpen", "rcas_sharpen")   # held to 0 unequal texels
VS_SOL_MAX = 1.02            # floor / kernel; above it the floor is wrong
VALUE_MIN = 0.98             # back-to-back value / device_ms, at least
# tools/parity.py's cases run here: the headline (0 unequal), the TPU
# record's worst case (33 values at 1 LSB there) and the 10-bit FSR upscale
# (0 unequal)
ORACLE_CASES = ("fsr_fused_zone_r0.5", "nvscaler_noise",
                "fsr_fused_noise10_r0.5")
RATE_MAX = 1.05              # a measured rate over its bound
SHARE_MAX = 1.05             # an audit row's bound over its time
N_PAIRS = 10                 # stereo pairs per plan through the public API
STRIPS = 3                   # row-band strips of the spatial path
# the [bN] lines of phase 5: rounds of graph replays, kernel and floor in
# turns, the best of each
B_ROUNDS = 10
CENTRES = ((0.5, 0.5), (0.5, 0.5))
OFF_CENTRE = ((0.3, 0.6), (0.7, 0.4))   # eyes whose circles cut many tiles
# A fresh process whose first NVScaler launch is on a side stream; prints
# the unequal texels against the plain version and the launch count.
SIDE_STREAM = """
import sys, torch
from openvr_fsr_tpu_torch.core import constants as C
from openvr_fsr_tpu_torch.kernels.nis import build_nvscaler
h, w, oh, ow = map(int, sys.argv[1:5])
cfg = C.nvscaler_update_config(0.9, w, h, w, h, ow, oh, ow, oh)
fn = build_nvscaler(2, h, w, ow, oh, nis_cfg=cfg, centres=C.centres_payload(
    ow, oh, 2.0, ((0.5, 0.5), (0.5, 0.5)), (0, 1)))
gen = torch.Generator(device="cuda").manual_seed(3)
img = torch.randint(0, 256, (2, h, w, 4), dtype=torch.uint8, device="cuda",
                    generator=gen).view(torch.int32)[..., 0].contiguous()
torch.cuda.synchronize()
side = torch.cuda.Stream()
with torch.cuda.stream(side):
    got = fn(img)
side.synchronize()
print(int((got != fn.reference(img)).sum()), fn.launches)
"""


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


def sass_counts(lib, nvcc):
    """{kernel function: [UTMALDG, LDS, STG] instruction counts} in the
    SASS of a built library (cuobjdump beside nvcc), or None without it."""
    from openvr_fsr_tpu_torch.tools import sass
    text = sass.disassemble(lib, nvcc)
    if text is None:
        return None
    return {fn: [ops["UTMALDG"], ops["LDS"], ops["STG"]]
            for fn, ops in sass.function_counts(text).items()}


def graph_ms(f, x, n):
    """Device ms per call of f(x) over n calls replayed from one CUDA graph
    (no host launch between them; utils/timing.py), the best of 3 replays."""
    from openvr_fsr_tpu_torch.utils.timing import replay_ms, rotation_graph
    graph = rotation_graph(f, [x], n)
    return min(replay_ms(graph, n) for _ in range(3))


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
    from openvr_fsr_tpu_torch import (CasModel, Config, FsrModel, Pipeline,
                                      get_model, upscale)
    from openvr_fsr_tpu_torch.core import constants as C
    from openvr_fsr_tpu_torch.kernels import _build
    from openvr_fsr_tpu_torch.kernels._common import occupancy
    from openvr_fsr_tpu_torch.kernels.cas import (build_cas_sharpen,
                                                  build_cas_upscale)
    from openvr_fsr_tpu_torch.kernels.fsr import build_fsr_fused
    from openvr_fsr_tpu_torch.kernels.nis import build_nvscaler, build_nvsharpen
    from openvr_fsr_tpu_torch.kernels.rcas import build_rcas_sharpen
    from openvr_fsr_tpu_torch.tools import sass
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
    for kernel, prefix in (("fsr_fused", "fsr"), ("nis_scaler", "nis"),
                           ("cas_upscale", "cas"),
                           ("nis_sharpen", "nis_sharpen"),
                           ("cas_sharpen", "cas_sharpen"),
                           ("rcas_sharpen", "rcas_sharpen")):
        usage = sass.ptxas_usage(_build.library_path(kernel)
                                 .with_suffix(".log").read_text())
        ctas = {}
        for bits in (8, 10):     # the RGBA8 and R10G10B10A2 instantiations
            per_sm = occupancy(kernel, bits)
            for cls in ("outside", "inside"):
                u = [v for fn, v in usage.items()
                     if f"{prefix}_{cls}_kernel" in fn
                     and sass.of_codec(fn, bits)]
                if len(u) != 1 or per_sm[cls] < 1:
                    fail(f"{kernel} {bits}-bit {cls} kernel: ptxas {u}, "
                         f"{per_sm[cls]} CTAs per SM")
                u = u[0]
                smem = (f"{per_sm['inside_smem']} B smem" if cls == "inside"
                        else f"{u['smem']} B static smem")
                log(f"[setup] {kernel} {bits}-bit {cls} kernel: "
                    f"{u['registers']} registers, {u['spill_stores']} B "
                    f"spill stores, {u['spill_loads']} B spill loads, "
                    f"{smem}, {per_sm[cls]} CTAs per SM")
                ctas[bits, cls] = per_sm[cls]
        for cls in ("outside", "inside"):
            if ctas[10, cls] < ctas[8, cls]:
                log(f"[setup] WARNING: {kernel} {cls} kernel holds "
                    f"{ctas[10, cls]} CTAs per SM at 10 bits, "
                    f"{ctas[8, cls]} at 8 bits")
        # the row-band strips' instantiations (B1, B5: a row test before
        # each store)
        for fn, u in usage.items():
            if f"{prefix}_band_" in fn:
                log(f"[setup] {kernel} "
                    f"{8 if sass.of_codec(fn) else 10}-bit "
                    f"{fn.split('_band_')[1].split('_')[0]} band kernel: "
                    f"{u['registers']} registers, {u['spill_stores']} B "
                    f"spill stores, {u['spill_loads']} B spill loads")

    def centres(ow, oh, radius, b=2, eyes=CENTRES):
        return C.centres_payload(ow, oh, radius, eyes,
                                 tuple(i % 2 for i in range(b)))

    def fsr(radius, debug=False, h=H, w=W, rs=0.75, b=2, eyes=CENTRES,
            bits=8, **band):
        ow, oh = Config(render_scale=rs).output_size(w, h)
        return build_fsr_fused(b, h, w, ow, oh, sharpness=SHARPNESS,
                               centres=centres(ow, oh, radius, b, eyes),
                               debug=debug, color_bits=bits, **band)

    def rcas(radius, debug=False, h=OH, w=OW, b=2, eyes=CENTRES, bits=8):
        return build_rcas_sharpen(b, h, w, sharpness=SHARPNESS,
                                  centres=centres(w, h, radius, b, eyes),
                                  debug=debug, color_bits=bits)

    def sharpen(radius, debug=False, hdr=0, h=OH, w=OW, b=2, eyes=CENTRES,
                bits=8):
        cfg = C.nvsharpen_update_config(SHARPNESS, w, h, w, h, hdr_mode=hdr)
        return build_nvsharpen(b, h, w, nis_cfg=cfg,
                               centres=centres(w, h, radius, b, eyes),
                               debug=debug, color_bits=bits)

    def scaler(radius, debug=False, hdr=0, h=H, w=W, rs=0.75, b=2,
               eyes=CENTRES, bits=8):
        ow, oh = Config(render_scale=rs).output_size(w, h)
        cfg = C.nvscaler_update_config(SHARPNESS, w, h, w, h, ow, oh, ow, oh,
                                       hdr_mode=hdr)
        return build_nvscaler(b, h, w, ow, oh, nis_cfg=cfg,
                              centres=centres(ow, oh, radius, b, eyes),
                              debug=debug, color_bits=bits)

    def cas_up(radius, debug=False, h=H, w=W, rs=0.75, b=2, eyes=CENTRES,
               bits=8, **band):
        ow, oh = Config(render_scale=rs).output_size(w, h)
        return build_cas_upscale(b, h, w, ow, oh, sharpness=CAS_SHARPNESS,
                                 centres=centres(ow, oh, radius, b, eyes),
                                 debug=debug, color_bits=bits, **band)

    def cas_sh(radius, debug=False, mcd=1.0, h=OH, w=OW, b=2, eyes=CENTRES,
               bits=8):
        return build_cas_sharpen(b, h, w, sharpness=CAS_SHARPNESS,
                                 centres=centres(w, h, radius, b, eyes),
                                 debug=debug, max_color_delta=mcd,
                                 color_bits=bits)

    builds = {"fsr_fused": fsr, "rcas_sharpen": rcas, "nis_sharpen": sharpen,
              "nis_scaler": scaler, "cas_upscale": cas_up,
              "cas_sharpen": cas_sh}

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
        if mx > PARITY_MAX_LSB or 1.0 - ne / n < PARITY_MIN_EQUAL \
                or (kernel in EXACT and ne):
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
    # the upscalers at class borders: off-centre eyes, and a batch of 4
    both = torch.cat([sets["in"]["zone+noise"], sets["in"]["uniform"]])
    for kernel, build in (("fsr_fused", fsr), ("nis_scaler", scaler),
                          ("cas_upscale", cas_up)):
        for name, img in sets["in"].items():
            parity(kernel, f"2x{W}x{H}->2x{OW}x{OH} radius=0.3 eyes "
                   f"{OFF_CENTRE} {name}", build(0.3, eyes=OFF_CENTRE), img)
        parity(kernel, f"4x{W}x{H}->4x{OW}x{OH} radius=0.5 batch 4 (both "
               "sets)", build(0.5, b=4), both)
    for hdr in (1, 2):
        parity("nis_scaler", f"2x{W}x{H}->2x{OW}x{OH} radius=0.3 eyes "
               f"{OFF_CENTRE} hdr={hdr} uniform",
               scaler(0.3, hdr=hdr, eyes=OFF_CENTRE), sets["in"]["uniform"])
    # the sharpen-only class kernels at class borders, the same way
    both_full = torch.cat([sets["full"]["zone+noise"],
                           sets["full"]["uniform"]])
    for kernel, build in (("nis_sharpen", sharpen), ("cas_sharpen", cas_sh),
                          ("rcas_sharpen", rcas)):
        for name, img in sets["full"].items():
            parity(kernel, f"2x{OW}x{OH} radius=0.3 eyes {OFF_CENTRE} "
                   f"{name}", build(0.3, eyes=OFF_CENTRE), img)
        parity(kernel, f"4x{OW}x{OH} radius=0.5 batch 4 (both sets)",
               build(0.5, b=4), both_full)
    for hdr in (1, 2):
        for name in ("zone+noise", "uniform"):
            parity("nis_scaler", f"2x{W}x{H}->2x{OW}x{OH} radius=2.0 "
                   f"hdr={hdr} {name}", scaler(2.0, hdr=hdr), sets["in"][name])
            for radius in (0.5, 2.0):
                parity("nis_sharpen", f"2x{OW}x{OH} radius={radius} "
                       f"hdr={hdr} {name}", sharpen(radius, hdr=hdr),
                       sets["full"][name])

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
        ("nis_sharpen", "2x128x96 bright border, hdr=1",
         sharpen(2.0, hdr=1, h=96, w=128), border),
        ("nis_scaler", "2x128x96 rs=0.75", scaler(0.5, h=96, w=128), small),
    ]
    for kernel, label, fn, img in checks:
        got = fn(img)
        for ref_name, want in (("plain cuda", fn.reference(img)),
                               ("plain cpu", fn(img.cpu()).to(dev))):
            ne, n, mx = lsb_diff(got, want)
            log(f"[parity] {kernel} {label} vs {ref_name}: unequal {ne} of "
                f"{n}, max {mx} LSB")
            if mx > PARITY_MAX_LSB or 1.0 - ne / n < PARITY_MIN_EQUAL \
                    or (kernel in EXACT and ne):
                fail(f"{kernel} disagrees with its plain version")
            max_lsb[kernel] = max(max_lsb[kernel], mx)

    # NVScaler's first launch in a fresh process, on a side stream
    r = subprocess.run([sys.executable, "-c", SIDE_STREAM, str(H), str(W),
                        str(OH), str(OW)], cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"nis_scaler on a side stream: exit {r.returncode}\n{r.stderr}")
    ne, n_launch = map(int, r.stdout.split())
    log(f"[parity] nis_scaler 2x{W}x{H}->2x{OW}x{OH} radius=2.0, a fresh "
        f"process's first call on a side stream: unequal {ne} texels, "
        f"{n_launch} launch")
    if ne or n_launch != 1:
        fail("nis_scaler disagrees with its plain version on a side stream")

    # the 10-bit instantiations (R10G10B10A2: (B, H, W, 4) uint16) against
    # their plain versions, value for value: full size, every radius and
    # debug, off-centre eyes, NIS hdr 1; alpha in {0..3}; the uniform set
    # also holds 1% of out-of-range 16-bit values, which saturate
    from openvr_fsr_tpu_torch.tools.parity import noise10, zone_plate10

    def frame_sets10(h, w):
        zone = np.stack([zone_plate10(h, w), noise10(h, w, seed=1)])
        zone[..., 3] = rng.integers(0, 4, (2, h, w))
        uni = rng.integers(0, 1024, (2, h, w, 4)).astype(np.uint16)
        uni[..., 3] = rng.integers(0, 4, (2, h, w))
        wild = rng.random((2, h, w, 4)) < 0.01
        uni[wild] = rng.integers(1024, 65536, int(wild.sum()))
        return {"zone10+noise10": torch.from_numpy(zone).to(dev),
                "uniform10": torch.from_numpy(uni).to(dev)}

    sets10 = {"in": frame_sets10(H, W), "full": frame_sets10(OH, OW)}
    UPSCALERS = ("fsr_fused", "nis_scaler", "cas_upscale")
    for k in EXACT:
        max_lsb[f"{k}_10bit"] = 0

    def parity10(kernel, label, fn, img, want=None):
        got = fn(img)
        want = fn.reference(img) if want is None else want
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != torch.uint16 \
                or want.dtype != torch.uint16 or got.device != img.device:
            fail(f"{kernel} 10-bit output {tuple(got.shape)} {got.dtype} on "
                 f"{got.device}, plain {tuple(want.shape)} {want.dtype}")
        d = (got.to(torch.int32) - want.to(torch.int32).to(got.device)).abs()
        ne, mx = int((d > 0).sum()), int(d.max())
        log(f"[parity] {kernel} 10-bit {label}: unequal {ne} of "
            f"{d.numel()} values, max {mx} LSB")
        if ne:
            fail(f"{kernel} 10-bit disagrees with its plain version "
                 f"({ne}, {mx})")
        return got

    kernel_out10 = {}
    for kernel, build in builds.items():
        size = "in" if kernel in UPSCALERS else "full"
        shape = (f"2x{W}x{H}->2x{OW}x{OH}" if size == "in"
                 else f"2x{OW}x{OH}")
        for radius, debug in cases:
            for name, img in sets10[size].items():
                kernel_out10[kernel, radius, debug, name] = parity10(
                    kernel, f"{shape} radius={radius} debug={debug} {name}",
                    build(radius, debug, bits=10), img)
        for name, img in sets10[size].items():
            parity10(kernel, f"{shape} radius=0.3 eyes {OFF_CENTRE} {name}",
                     build(0.3, eyes=OFF_CENTRE, bits=10), img)
        if kernel.startswith("nis"):
            for name, img in sets10[size].items():
                parity10(kernel, f"{shape} radius=0.5 hdr=1 {name}",
                         build(0.5, hdr=1, bits=10), img)
        # the ring pitch, read in place
        fn = build(0.5, bits=10)
        img = sets10[size]["uniform10"]
        hp, wp = fn.pad_to
        ring = torch.full((2, hp, wp, 4), 1023, dtype=torch.uint16,
                          device=dev)
        ring[:, :img.shape[1], :img.shape[2]] = img
        parity10(kernel, f"ring pitch {hp}x{wp} vs unpadded", fn, ring,
                 fn(img))
    # the card's conversions against the CPU path: small frames whose
    # values span the whole uint16 range (saturating), and a bright border
    small10 = rng.integers(0, 65536, (2, 96, 128, 4)).astype(np.uint16)
    small10[:, ::2] = rng.integers(0, 1024, (2, 48, 128, 4))
    small10[:, ::2, :, 3] = rng.integers(0, 4, (2, 48, 128))
    border10 = np.full((2, 96, 128, 4), 80, np.uint16)
    border10[:, :2], border10[:, -2:] = 1000, 960
    border10[:, :, :2], border10[:, :, -2:] = 1023, 990
    border10[..., 3] = rng.integers(0, 4, (2, 96, 128))
    for label, frame in (("full uint16 range", small10),
                         ("bright border", border10)):
        img = torch.from_numpy(frame).to(dev)
        for kernel, build in builds.items():
            fn = build(2.0 if label == "bright border" else 0.5, h=96, w=128,
                       bits=10)
            parity10(kernel, f"2x128x96 {label} vs the CPU path", fn, img,
                     fn(img.cpu()))
    fn = cas_sh(2.0, mcd=0.05, bits=10)
    img = sets10["full"]["zone10+noise10"]
    if torch.equal(parity10("cas_sharpen", "max_color_delta=0.05", fn, img),
                   kernel_out10["cas_sharpen", 2.0, False, "zone10+noise10"]):
        fail("cas_sharpen 10-bit: max_color_delta 0.05 left the output as "
             "it was at 1.0")

    # ---- 2b. the row-band strips of B1 and B5 --------------------------------
    # each strip build (band_range) on its input strip against the full
    # launch on the card, 0 unequal texels: split STRIPS ways at the default
    # band_rows, every band alone at 32 rows, and 24-row bands, whose edges
    # cut 32-row tiles; one 10-bit case per kernel; small strips against the
    # CPU path
    from openvr_fsr_tpu_torch.kernels.cas import cas_band_layout
    from openvr_fsr_tpu_torch.kernels.fsr import fsr_band_layout
    from openvr_fsr_tpu_torch.parallel import (ShardedPipeline,
                                               SpatialFsrPipeline,
                                               split_bands)
    layouts = {"fsr_fused": (fsr, fsr_band_layout),
               "cas_upscale": (cas_up, cas_band_layout)}
    for k in ("fsr_fused_band", "cas_upscale_band"):
        max_lsb[k] = 0

    def value_diff(a, b):
        """(unequal values, max difference) of two frames of one format."""
        if a.shape != b.shape or a.dtype != b.dtype:
            return -1, -1
        if a.dtype == torch.uint16:
            d = (a.to(torch.int32) - b.to(torch.int32)).abs()
            return int((d > 0).sum()), int(d.max())
        ne, _, mx = lsb_diff(a, b)
        return ne, mx

    def strips(kernel, label, img, radius=0.5, band_rows=128, n=STRIPS,
               want=None, **kw):
        """The concatenated strips of `kernel` on img (n equal splits of the
        bands, or every band alone where n is None) against the full
        launch (or `want`); each strip kernel launched once."""
        build, layout = layouts[kernel]
        full = build(radius, **kw)
        want = full(img) if want is None else want
        _, gy = layout(want.shape[2], want.shape[1], band_rows)
        outs = []
        for g0, g1 in split_bands(gy, gy if n is None else n):
            fn = build(radius, band_rows=band_rows, band_range=(g0, g1), **kw)
            got = fn(img[:, fn.in_row_base:fn.in_row_base + fn.in_rows]
                     .contiguous())
            if fn.launches != 1 or got.shape[1] != fn.out_rows:
                fail(f"{kernel} strip {(g0, g1)}: {fn.launches} launches, "
                     f"{got.shape[1]} of {fn.out_rows} rows")
            outs.append(got)
        got = torch.cat(outs, 1)
        torch.cuda.synchronize()
        ne, mx = value_diff(got, want.to(got.device))
        log(f"[strip] {kernel} {label} band_rows={band_rows}, "
            f"{len(outs)} strips: unequal {ne} of {want.numel()} against "
            "the single launch")
        if ne:
            fail(f"{kernel}: the strips differ from the single launch "
                 f"({label}, band_rows {band_rows}: {ne} unequal)")
        max_lsb[f"{kernel}_band"] = max(max_lsb[f"{kernel}_band"], mx)

    shape_in = f"2x{W}x{H}->2x{OW}x{OH}"
    for kernel in ("fsr_fused", "cas_upscale"):
        for radius, debug in cases:
            strips(kernel, f"{shape_in} radius={radius} debug={debug}",
                   sets["in"]["zone+noise"], radius, debug=debug)
        strips(kernel, f"{shape_in} radius=0.3 eyes {OFF_CENTRE} uniform",
               sets["in"]["uniform"], 0.3, eyes=OFF_CENTRE)
        strips(kernel, f"2x{OW}x{OH} rs=1.3 radius=0.5",
               sets["full"]["zone+noise"], h=OH, w=OW, rs=1.3)
        strips(kernel, f"{shape_in} radius=0.5 every band alone",
               sets["in"]["zone+noise"], band_rows=32, n=None)
        strips(kernel, f"{shape_in} radius=2.0 (band edges inside tiles)",
               sets["in"]["uniform"], 2.0, band_rows=24)
        strips(kernel, f"{shape_in} 10-bit radius=0.5 (band edges inside "
               "tiles)", sets10["in"]["uniform10"], band_rows=24, bits=10)
        # small strips on the card against the plain version on the CPU
        small_img = small if kernel == "fsr_fused" else border
        want = layouts[kernel][0](0.5, h=96, w=128)(small_img.cpu()).to(dev)
        strips(kernel, "2x128x96 rs=0.75 against the CPU path", small_img,
               band_rows=24, want=want, h=96, w=128)
    # the spatial path through its entry point, in the steady state, with
    # the launch counts set to 0 just before: 3 strips on this card, under
    # set_sync_debug_mode("error") (no host sync), equal to Pipeline.process
    fsr_cfg0 = Config(enabled=True, render_scale=0.75, sharpness=SHARPNESS,
                      radius=0.5)
    spatial = {"fsr_fused": fsr_cfg0,
               "cas_upscale": Config(enabled=True, use_cas=True,
                                     render_scale=0.75,
                                     sharpness=CAS_SHARPNESS, radius=0.5)}
    strip_ms, strip_plain_ms, strip_bytes = {}, {}, {}
    launches = {}
    for kernel, cfg in spatial.items():
        img = sets["in"]["zone+noise"]
        want = Pipeline(cfg).process(img, eyes=(0, 1))
        sp = SpatialFsrPipeline(cfg, devices=[dev] * STRIPS)
        placed = sp.place(img, eyes=(0, 1))
        sp.process_placed(placed)              # builds, tables on the card
        torch.cuda.synchronize()
        for k in sp.kernels:
            k.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(N_PAIRS):
                outs = sp.process_placed(placed)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        counts = [k.launches for k in sp.kernels]
        launches[f"{kernel}_band"] = sum(counts)
        got = sp.gather(placed[0], outs)
        ne = int((got != want.cpu().numpy().view(np.uint32)).sum())
        log(f"[strip] {kernel} SpatialFsrPipeline {STRIPS} strips on the card, "
            f"{N_PAIRS} steady-state process_placed calls with no host sync: "
            f"launches {counts}, unequal {ne} of {got.size} against "
            "Pipeline.process")
        if ne or counts != [N_PAIRS] * STRIPS:
            fail(f"{kernel}: SpatialFsrPipeline differs from Pipeline.process "
                 f"or did not launch each strip once per call ({counts})")
        shards = sp._cache[placed[0]][0]
        per = [graph_ms(fn, x, 200) for (fn, *_), x in zip(shards, placed[1])]
        plain = [time_ms(fn.reference, x, 3)
                 for (fn, *_), x in zip(shards, placed[1])]
        strip_ms[kernel], strip_plain_ms[kernel] = sum(per), sum(plain)
        strip_bytes[kernel] = sum(x.numel() for x in placed[1]) * 4
        single = graph_ms(Pipeline(cfg)._build(2, H, W, (0, 1), True), img,
                          200)
        log(f"[strip] {kernel} radius 0.5: strips {per} ms, summed "
            f"{strip_ms[kernel]} ms per stereo pair against the single "
            f"launch's {single} ms (device; {card}); plain torch "
            f"{strip_plain_ms[kernel]} ms; input strips of "
            f"{[rows for _, _, rows, _, _ in shards]} rows")
    # batch splitting: ShardedPipeline over two slices on this card, and a
    # model family's sharded(), equal to Pipeline.process at batch 4
    both_in = torch.cat([sets["in"]["zone+noise"], sets["in"]["uniform"]])
    pipe = Pipeline(fsr_cfg0)
    want = pipe.process(both_in)
    outs = ShardedPipeline(pipe, [dev, dev]).process(both_in)
    torch.cuda.synchronize()
    fn = [k for k in pipe.kernels if k.launches == 2]
    if not torch.equal(torch.cat(outs), want) or len(fn) != 1 \
            or any(o.device != dev for o in outs):
        fail("ShardedPipeline over [cuda:0] * 2 differs from "
             "Pipeline.process or did not launch once per slice")
    model = FsrModel(render_scale=0.75, sharpness=SHARPNESS, radius=0.5)
    outs = model.sharded([dev, dev]).process(both_in.view(torch.uint8).view(
        4, H, W, 4))
    if not torch.equal(torch.cat(outs).view(torch.int32)[..., 0], want):
        fail("FsrModel().sharded() differs from Pipeline.process")
    log("[strip] ShardedPipeline over [cuda:0] * 2 at batch 4 (packed) and "
        "FsrModel().sharded() (uint8): equal to Pipeline.process, one launch "
        "per slice")
    from openvr_fsr_tpu_torch.tools import spatial_onchip
    spatial_onchip.main([])

    # ---- 3. the plans through the public API --------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)

    def pairs_of(h, w, first):
        u8 = torch.randint(0, 256, (N_PAIRS, 2, h, w, 4), dtype=torch.uint8,
                           device=dev, generator=gen)
        u8[0] = first.view(torch.uint8).view(2, h, w, 4)
        return u8

    def plan_of(cfg):
        pipe = Pipeline(cfg)                        # the card by default
        return pipe.process, pipe

    def model_of(**kw):
        model = CasModel(**kw)
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
    first_out = {}
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
    pipe = Pipeline(plans["fsr_fused"][0][1].config)
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
                 use_nis=True)
    torch.cuda.synchronize()
    if not up.is_cuda or not torch.equal(up, first_out["nis_scaler"]):
        fail("upscale(use_nis=True) differs from Pipeline.process")
    log(f"[main] upscale(use_nis=True): {tuple(up.shape)} {up.dtype}, equal "
        "to Pipeline.process")
    # the CAS family by name, and the one-shot API with use_cas
    model = get_model("cas")
    got = model(pairs_full[0])
    torch.cuda.synchronize()
    if [k.launches for k in model.pipeline.kernels] != [1] \
            or not torch.equal(got, first_out["cas_sharpen"]):
        fail("get_model('cas') differs from CasModel()")
    for rs, kernel, x in ((None, "cas_sharpen", pairs_full[0]),
                          (0.75, "cas_upscale", pairs_in[0])):
        up = upscale(x, render_scale=rs, sharpness=CAS_SHARPNESS, radius=2.0,
                     use_cas=True)
        torch.cuda.synchronize()
        if not up.is_cuda or not torch.equal(up, first_out[kernel]):
            fail(f"upscale(use_cas=True, render_scale={rs}) differs from "
                 "Pipeline.process")
    log("[main] get_model('cas') and upscale(use_cas=True) at rs 1 and 0.75 "
        "equal the CasModel plans")
    dbg = Pipeline(plans["nis_sharpen"][0][1].config.with_(debug_mode=True))
    dbg.process(pairs_full[0])
    if dbg.timer.count != 1 or not dbg.timer.summed > 0:
        fail("debug-mode GpuTimer recorded no CUDA time")
    # numpy frames through the entry points with no device: the card
    frame_np = pairs_in[0].cpu().numpy()
    fsr_cfg = plans["fsr_fused"][0][1].config
    pipe = Pipeline(fsr_cfg)
    model = FsrModel(render_scale=fsr_cfg.render_scale,
                     sharpness=fsr_cfg.sharpness, radius=fsr_cfg.radius)
    for label, call, kernels in (
            ("Pipeline(cfg).process", pipe.process, lambda: pipe.kernels),
            ("FsrModel()", model, lambda: model.pipeline.kernels),
            ("upscale()", lambda f: upscale(
                f, render_scale=fsr_cfg.render_scale,
                sharpness=fsr_cfg.sharpness, radius=fsr_cfg.radius), None)):
        got = call(frame_np)
        torch.cuda.synchronize()
        if not got.is_cuda or not torch.equal(got, first_out["fsr_fused"]):
            fail(f"{label} on a numpy frame with no device did not run the "
                 "FSR kernel on the card")
        if kernels is not None and [k.launches for k in kernels()] != [1]:
            fail(f"{label} did not launch its CUDA kernel")
    log("[main] Pipeline(cfg), FsrModel() and upscale() with no device, on "
        "numpy frames: on the card, the CUDA kernel launched, equal to the "
        "FSR plan")
    # deferred capture on the card: a right-eye-only batch writes nothing,
    # the next stereo batch saves its eye-0 output as a DDS
    from openvr_fsr_tpu_torch.api.capture import read_dds_rgba8
    for label, x in (("uint8", pairs_in[0]),
                     ("packed int32",
                      pairs_in[0].view(torch.int32)[..., 0].contiguous())):
        with tempfile.TemporaryDirectory() as tmp:
            pipe = Pipeline(fsr_cfg)
            pipe.arm_capture(tmp)
            pipe.process(x[1:], eyes=(1,))
            if pipe._capture_armed is None or any(Path(tmp).iterdir()):
                fail(f"capture ({label}): a right-eye-only batch captured")
            out = pipe.process(x)
            if pipe._capture_armed is not None \
                    or len(pipe.last_capture_paths) != 1:
                fail(f"capture ({label}): the stereo batch wrote "
                     f"{pipe.last_capture_paths}")
            got = read_dds_rgba8(pipe.last_capture_paths[0])
            want = out[0].cpu().contiguous().view(torch.uint8).numpy() \
                .reshape(OH, OW, 4)
            if not np.array_equal(got, want):
                fail(f"capture ({label}): the DDS differs from the eye-0 "
                     "output")
            log(f"[main] capture ({label}): the right-eye batch wrote "
                f"nothing; {pipe.last_capture_paths[0].name} "
                f"{got.shape} equals the eye-0 output byte for byte")

    # the six plans at 10 bits through Pipeline(color_bits=10), given no
    # device, with the launch counts set to 0 just before
    gen10 = np.random.default_rng(2)

    def pairs10(h, w, first):
        u16 = gen10.integers(0, 1024, (N_PAIRS, 2, h, w, 4)).astype(np.uint16)
        u16[..., 3] = gen10.integers(0, 4, (N_PAIRS, 2, h, w))
        out = torch.from_numpy(u16).to(dev)
        out[0] = first
        return out

    pairs10_in = pairs10(H, W, sets10["in"]["zone10+noise10"])
    pairs10_full = pairs10(OH, OW, sets10["full"]["zone10+noise10"])
    plans10 = {kernel: (Pipeline(pipe.config, color_bits=10,
                                 cas_max_color_delta=pipe.cas_max_color_delta),
                        pairs10_in if kernel in UPSCALERS else pairs10_full)
               for kernel, ((_, pipe), _) in plans.items()}
    first_out10 = {}
    for kernel, (pipe, xs) in plans10.items():
        pipe.process(xs[0])                         # builds (not counted)
        for k in pipe.kernels:
            k.launches = 0
        outs = [pipe.process(xs[i]) for i in range(N_PAIRS)]
        torch.cuda.synchronize()
        counts = [k.launches for k in pipe.kernels]
        launches[f"{kernel}_10bit"] = sum(counts)
        log(f"[main] {kernel} 10-bit plan: {N_PAIRS} calls, kernel launches "
            f"{counts}")
        if counts != [N_PAIRS] or pipe.kernels[0].color_bits != 10:
            fail(f"the {kernel} 10-bit plan did not launch its 10-bit "
                 "kernel once per call")
        for i, out in enumerate(outs):
            if out.shape != (2, OH, OW, 4) or out.dtype != torch.uint16 \
                    or not out.is_cuda:
                fail(f"{kernel} 10-bit output {tuple(out.shape)} {out.dtype}")
        fn = pipe.kernels[0]
        if not torch.equal(outs[0], fn(xs[0])):
            fail(f"{kernel}: the 10-bit Pipeline output differs from its "
                 "kernel's")
        values = outs[0].to(torch.int32)   # few CUDA kernels take uint16
        if int(values[..., :3].max()) > 1023 or int(values[..., 3].max()) > 3:
            fail(f"{kernel} 10-bit output above 1023 or alpha above 3")
        first_out10[kernel] = outs[0]
        log(f"[main] {kernel} 10-bit plan: output {tuple(outs[0].shape)} "
            f"uint16, alpha values {values[..., 3].unique().tolist()}")
    for kernel, radius in (("fsr_fused", 0.5), ("cas_upscale", 2.0),
                           ("cas_sharpen", 2.0)):
        if not torch.equal(first_out10[kernel], kernel_out10[
                kernel, radius, False, "zone10+noise10"]):
            fail(f"the {kernel} 10-bit plan differs from its kernel at the "
                 "same config in phase 2")
    for kernel, (pipe, xs) in plans10.items():
        cfg = pipe.config
        up = upscale(xs[0], render_scale=cfg.render_scale,
                     sharpness=cfg.sharpness, radius=cfg.radius,
                     use_nis=cfg.use_nis, use_cas=cfg.use_cas, color_bits=10)
        torch.cuda.synchronize()
        if not up.is_cuda or not torch.equal(up, first_out10[kernel]):
            fail(f"upscale(color_bits=10) differs from the {kernel} 10-bit "
                 "plan")
    log("[main] upscale(color_bits=10) with no device, each plan: on the "
        "card, equal to Pipeline(color_bits=10)")
    # RGB uint16 frames get the opaque alpha 3, as the JAX to_planar does
    opaque = pairs10_in[0].cpu().numpy()
    opaque[..., 3] = 3
    rgb = upscale(pairs10_in[0][..., :3], render_scale=0.75, color_bits=10)
    if not torch.equal(rgb, upscale(torch.from_numpy(opaque).to(dev),
                                    render_scale=0.75, color_bits=10)):
        fail("upscale(color_bits=10) on RGB frames differs from opaque RGBA")
    log("[main] upscale(color_bits=10) on RGB uint16 frames equals the same "
        "frames with alpha 3")
    # deferred capture of a 10-bit pipeline: an R10G10B10A2 DDS
    from openvr_fsr_tpu_torch.api.capture import (pack_r10g10b10a2,
                                                  read_dds)
    with tempfile.TemporaryDirectory() as tmp:
        pipe = Pipeline(fsr_cfg, color_bits=10)
        pipe.arm_capture(tmp)
        pipe.process(pairs10_in[0][1:], eyes=(1,))
        if any(Path(tmp).iterdir()):
            fail("10-bit capture: a right-eye-only batch captured")
        out = pipe.process(pairs10_in[0])
        (path,) = pipe.last_capture_paths
        got, bits = read_dds(path)
        payload = pack_r10g10b10a2(out[0].cpu().numpy()).tobytes()
        if bits != 10 or not np.array_equal(got, out[0].cpu().numpy()) \
                or path.read_bytes()[128:] != payload:
            fail("10-bit capture: the DDS differs from the eye-0 output")
        log(f"[main] capture (10-bit): {path.name} R10G10B10A2 {got.shape} "
            "equals the eye-0 output value for value")

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
            rounds[label].append((graph_ms if label == "kernel" else time_ms)(
                f, img, n))
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
            t = graph_ms(fn, img, 200)
            plain = (f", plain torch {time_ms(fn.reference, img, 5)} ms"
                     if kernel.startswith("cas") else "")
            log(f"[time] {kernel} radius={radius}: {t} ms per stereo "
                f"pair{plain}")
    # the 10-bit kernels at radius 0.5, the same way
    timed10 = {kernel: (build(0.5, bits=10),
                        sets10["in" if kernel in UPSCALERS else "full"]
                        ["zone10+noise10"])
               for kernel, build in builds.items()}
    for kernel, (fn, img) in timed10.items():
        rounds = {"kernel": [], "plain": []}
        for label, f, n in (("plain", fn.reference, 5), ("kernel", fn, 200),
                            ("kernel", fn, 200), ("plain", fn.reference, 5)):
            rounds[label].append((graph_ms if label == "kernel" else time_ms)(
                f, img, n))
        ms[f"{kernel}_10bit"] = float(np.mean(rounds["kernel"]))
        plain_ms[f"{kernel}_10bit"] = float(np.mean(rounds["plain"]))
        mbytes = (img.numel() + fn(img).numel()) * 2 / 1e6
        log(f"[time] {kernel} 10-bit radius 0.5: kernel {rounds['kernel']} "
            f"ms per stereo pair ({mbytes:.1f} MB moved -> "
            f"{mbytes / ms[f'{kernel}_10bit']:.1f} GB/s; 8-bit "
            f"{ms[kernel]} ms); plain torch {rounds['plain']} ms")
    log(f"[time] fsr_fused rs=1.3 2x{OW}x{OH} radius=0.5: "
        f"{graph_ms(fsr(0.5, h=OH, w=OW, rs=1.3), sets['full']['zone+noise'], 200)}"
        " ms per stereo pair")

    # ---- 5. the measurement path --------------------------------------------
    from openvr_fsr_tpu_torch import bench
    from openvr_fsr_tpu_torch.kernels.sol import build_dma_floor
    from openvr_fsr_tpu_torch.tools import bench_paths
    from openvr_fsr_tpu_torch.utils.timing import bench_fn, hbm_calibration

    counts = sass_counts(_build.library_path("dma_floor"), _build._nvcc())
    if counts is None:
        log("[floor] cuobjdump not found: SASS not checked")
    for fn_name, (tma, lds, stg) in (counts or {}).items():
        log(f"[floor] SASS {fn_name}: {tma} UTMALDG, {lds} LDS, {stg} STG")
        if not (tma and lds and stg):
            fail(f"dma_floor {fn_name}: the compiler dropped its TMA loads, "
                 "its shared reads or its stores")
    max_lsb["dma_floor"] = 0
    geometries = [(name, *bench_paths.path_config(name))
                  for name in bench_paths.PATHS]
    geometries += [(f"{path} radius {r}", cfg.with_(radius=r), h, w)
                   for path in ("fsr_fused", "nvscaler", "cas_upscale",
                                "nvsharpen", "cas_sharpen", "rcas_only")
                   for r in (0.0, 2.0)
                   for cfg, h, w in [bench_paths.path_config(path)]]
    for name, cfg, h, w in geometries:
        img = sets["in" if (h, w) == (H, W) else "full"]["zone+noise"]
        fn = Pipeline(cfg, device="cuda")._build(2, h, w, (0, 1), True)
        floor = build_dma_floor(fn.dma_geometry)
        want = floor.reference(img)
        hp, wp = floor.pad_to
        ring = torch.zeros((2, hp, wp), dtype=torch.int32, device=dev)
        ring[:, :h, :w] = img
        for label, x in (("unpadded", img), (f"ring pitch {hp}x{wp}", ring)):
            if x.shape[2] % floor.pitch_words:
                # TMA takes a row pitch of a multiple of 16 bytes: the
                # floor refuses this one, as it publishes, and launches
                # nothing
                try:
                    floor(x)
                except ValueError as e:
                    log(f"[floor] dma_floor {name} 2x{w}x{h} {label}: "
                        f"refused as published ({e})")
                    continue
                fail(f"dma_floor {name} ({label}): a {x.shape[2]}-word "
                     f"pitch is not a multiple of {floor.pitch_words} and "
                     "was not refused")
            got = floor(x)
            torch.cuda.synchronize()
            if got.shape != want.shape:
                fail(f"dma_floor {name}: output {tuple(got.shape)}")
            ne, n, mx = lsb_diff(got, want)
            log(f"[floor] dma_floor {name} 2x{w}x{h} -> "
                f"2x{got.shape[2]}x{got.shape[1]} {label}: unequal {ne} of "
                f"{n} words (read {floor.read_bytes / 1e6:.1f} MB, "
                f"{floor.hbm_bytes / 1e6:.1f} MB unique)")
            if ne:
                fail(f"dma_floor {name} ({label}) disagrees with its plain "
                     "version")
            max_lsb["dma_floor"] = max(max_lsb["dma_floor"], mx)
    ss_w, ss_h = Config(render_scale=1.3).output_size(OW, OH)
    for kernel, build in (("fsr_fused", fsr), ("cas_upscale", cas_up)):
        parity(kernel, f"2x{OW}x{OH}->2x{ss_w}x{ss_h} rs=1.3 radius=0.5 "
               "zone+noise", build(0.5, h=OH, w=OW, rs=1.3),
               sets["full"]["zone+noise"])
    floor = build_dma_floor(timed["fsr_fused"][0].dma_geometry)
    hp, wp = floor.pad_to         # the floor's TMA runs the ring pitch
    img = torch.zeros((2, hp, wp), dtype=torch.int32, device=dev)
    img[:, :H, :W] = timed["fsr_fused"][1]
    rounds = {"kernel": [], "plain": []}
    for label, f, n in (("plain", floor.reference, 5), ("kernel", floor, 200),
                        ("kernel", floor, 200), ("plain", floor.reference, 5)):
        rounds[label].append((graph_ms if label == "kernel" else time_ms)(
            f, img, n))
    ms["dma_floor"] = float(np.mean(rounds["kernel"]))
    plain_ms["dma_floor"] = float(np.mean(rounds["plain"]))
    log(f"[time] dma_floor at the fsr_fused geometry: {rounds['kernel']} ms "
        f"per stereo pair; plain torch {rounds['plain']} ms")
    # fsr_fused and its floor in turns over the bench's ring frames, at the
    # three radii of the main path and at the supersample
    for label, (cfg, h, w) in (
            *((f"radius {r}", (Config(enabled=True, render_scale=0.75,
                                      sharpness=SHARPNESS, radius=r), H, W))
              for r in (0.0, 0.5, 2.0)),
            ("rs 1.3 radius 0.5", bench_paths.path_config("fsr_supersample"))):
        run = bench.measure(cfg, h, w, rounds=B_ROUNDS)
        log(f"[b1] fsr_fused {label}: {run.device_ms} ms per stereo pair "
            f"(device; back to back {run.ms}), its DMA floor {run.sol_ms} "
            f"ms, vs_sol {run.vs_sol}, floor "
            f"{run.probe_effective_gbps:.1f} GB/s over the unique bytes")
    # nis_scaler, cas_upscale, nis_sharpen, cas_sharpen and rcas_sharpen
    # with their floors, the same way
    for tag, path in (("b3", "nvscaler"), ("b5", "cas_upscale"),
                      ("b4", "nvsharpen"), ("b6", "cas_sharpen"),
                      ("b2", "rcas_only")):
        cfg, h, w = bench_paths.path_config(path)
        for r in (0.0, 0.5, 2.0):
            run = bench.measure(cfg.with_(radius=r), h, w, rounds=B_ROUNDS)
            log(f"[{tag}] {path} radius {r}: {run.device_ms} ms per stereo "
                f"pair (device; back to back {run.ms}), its DMA floor "
                f"{run.sol_ms} ms, vs_sol {run.vs_sol}, floor "
                f"{run.probe_effective_gbps:.1f} GB/s over the unique bytes")
            if run.vs_sol > VS_SOL_MAX:
                fail(f"{path} radius {r}: vs_sol {run.vs_sol} > {VS_SOL_MAX}")
    # the 10-bit floors: word for word against their plain version at the
    # six plans' 10-bit geometries at radius 0.0, 0.5 and 2.0 (ring pitch,
    # and unpadded where its row pitch is a multiple of 16 bytes), then each
    # 10-bit kernel and its floor in turns ([b1]-[b6] 10-bit lines)
    max_lsb["dma_floor_10bit"] = 0
    paths10 = (("b1", "fsr_fused", "fsr_fused"), ("b3", "nvscaler", "nis_scaler"),
               ("b5", "cas_upscale", "cas_upscale"),
               ("b4", "nvsharpen", "nis_sharpen"),
               ("b6", "cas_sharpen", "cas_sharpen"),
               ("b2", "rcas_only", "rcas_sharpen"))
    for _, path, kernel in paths10:
        cfg, h, w = bench_paths.path_config(path)
        x10 = sets10["in" if (h, w) == (H, W) else "full"]["zone10+noise10"]
        for r in (0.0, 0.5, 2.0):
            fn10 = Pipeline(cfg.with_(radius=r), color_bits=10)._build(
                2, h, w, (0, 1), False)
            floor10 = build_dma_floor(fn10.dma_geometry)
            want = floor10.reference(x10)
            hp, wp = floor10.pad_to
            ring = torch.zeros((2, hp, wp, 4), dtype=torch.uint16, device=dev)
            ring[:, :h, :w] = x10
            for label, x in (("unpadded", x10), (f"ring pitch {hp}x{wp}",
                                                 ring)):
                if 2 * x.shape[2] % floor10.pitch_words:
                    try:
                        floor10(x)
                    except ValueError:
                        log(f"[floor] dma_floor 10-bit {path} radius {r} "
                            f"{label}: refused as published (a "
                            f"{2 * x.shape[2]}-word pitch)")
                        continue
                    fail(f"dma_floor 10-bit {path} ({label}): a "
                         f"{2 * x.shape[2]}-word pitch was not refused")
                got = floor10(x)
                torch.cuda.synchronize()
                ne = int((got.to(torch.int32) != want.to(torch.int32)).sum()) \
                    if got.shape == want.shape else -1
                log(f"[floor] dma_floor 10-bit {path} radius {r} {label}: "
                    f"unequal {ne} of {want.numel()} values (read "
                    f"{floor10.read_bytes / 1e6:.1f} MB, "
                    f"{floor10.hbm_bytes / 1e6:.1f} MB unique)")
                if ne:
                    fail(f"dma_floor 10-bit {path} radius {r} ({label}) "
                         "disagrees with its plain version")
    runs10 = []
    for tag, path, kernel in paths10:
        cfg, h, w = bench_paths.path_config(path)
        for r in (0.0, 0.5, 2.0):
            run = bench.measure(cfg.with_(radius=r), h, w, rounds=B_ROUNDS,
                                color_bits=10)
            runs10.append(run)
            log(f"[{tag}] {path} 10-bit radius {r}: {run.device_ms} ms per "
                f"stereo pair (device; back to back {run.ms}), its DMA floor "
                f"{run.sol_ms} ms, vs_sol {run.vs_sol}, floor "
                f"{run.probe_effective_gbps:.1f} GB/s over the unique bytes "
                f"({card})")
            if run.vs_sol > VS_SOL_MAX:
                fail(f"{path} 10-bit radius {r}: vs_sol {run.vs_sol} > "
                     f"{VS_SOL_MAX}")
    launches["dma_floor_10bit"] = sum(run.floor.launches for run in runs10)
    floor10 = build_dma_floor(timed10["fsr_fused"][0].dma_geometry)
    hp, wp = floor10.pad_to
    img10 = torch.zeros((2, hp, wp, 4), dtype=torch.uint16, device=dev)
    img10[:, :H, :W] = timed10["fsr_fused"][1]
    rounds = {"kernel": [], "plain": []}
    for label, f, n in (("plain", floor10.reference, 5),
                        ("kernel", floor10, 200), ("kernel", floor10, 200),
                        ("plain", floor10.reference, 5)):
        rounds[label].append((graph_ms if label == "kernel" else time_ms)(
            f, img10, n))
    ms["dma_floor_10bit"] = float(np.mean(rounds["kernel"]))
    plain_ms["dma_floor_10bit"] = float(np.mean(rounds["plain"]))
    log(f"[time] dma_floor at the fsr_fused 10-bit geometry: "
        f"{rounds['kernel']} ms per stereo pair; plain torch "
        f"{rounds['plain']} ms")
    best, avg = bench_fn(floor, img, warmup=3, iters=50)
    read_bw, write_bw = hbm_calibration(dev)
    log(f"[time] dma_floor call by call (bench_fn): best {best} ms, average "
        f"{avg} ms; device memory at the headline shapes (hbm_calibration): "
        f"pure-read reduce {read_bw / 1e9:.1f} GB/s, pure-write fill "
        f"{write_bw / 1e9:.1f} GB/s")

    # the bench entries: each builds its pipelines and floors inside the
    # run, so every launch count starts at 0 there and is read just after
    bench_record, bench_run = bench.main()
    paths = bench_paths.main([])
    records = [bench_record] + [record for record, _ in paths.values()]
    runs = [bench_run] + [run for _, run in paths.values()]
    for record, run in zip(records, runs):
        k, f = run.kernel.launches, run.floor.launches
        log(f"[bench] {record['metric']}: value {record['value']} ms back "
            f"to back, device_ms {record['device_ms']}, host per call not "
            f"hidden by the card {record['value'] - record['device_ms']} ms "
            f"({card}); kernel "
            f"launches {k}, floor launches {f}, vs_sol {record['vs_sol']}")
        # the kernel runs the back-to-back rounds besides the floor's calls
        if not (k > f > 0):
            fail(f"{record['metric']}: kernel launched {k} times, its floor "
                 f"{f}")
        for key in ("value", "device_ms", "hbm_sol_ms",
                    "probe_effective_gbps"):
            if not (math.isfinite(record[key]) and record[key] > 0):
                fail(f"{record['metric']}: {key} = {record[key]}")
        if record["value"] < VALUE_MIN * record["device_ms"]:
            fail(f"{record['metric']}: value {record['value']} below "
                 f"{VALUE_MIN} x device_ms {record['device_ms']}: the "
                 "back-to-back time cannot beat the device's")
        if record["vs_sol"] != record["hbm_sol_ms"] / record["device_ms"]:
            fail(f"{record['metric']}: vs_sol is not the floor's graph time "
                 "over device_ms")
        if record["vs_sol"] > VS_SOL_MAX:
            fail(f"{record['metric']}: vs_sol {record['vs_sol']} > "
                 f"{VS_SOL_MAX}: the floor is slower than its kernel")
    if len(paths) != len(bench_paths.PATHS):
        fail("bench_paths did not measure every path")
    # the API's host cost of a call: Pipeline.process on each path's
    # unpadded packed stereo pair, the host's time to enqueue a call (no
    # sync) and back to back ending in a sync, beside the path's device_ms
    from openvr_fsr_tpu_torch.utils.timing import wall_ms
    for name, (record, _) in paths.items():
        cfg, h, w = bench_paths.path_config(name)
        pipe = Pipeline(cfg)
        x = sets["in" if (h, w) == (H, W) else "full"]["zone+noise"]
        wall_ms(pipe.process, [x], 5)
        enqueue = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(40):
                pipe.process(x)
            enqueue.append((time.perf_counter() - t0) * 1000.0 / 40)
            torch.cuda.synchronize()
        b2b = min(wall_ms(pipe.process, [x], 40) for _ in range(3))
        log(f"[api] {name}: Pipeline.process enqueues in {min(enqueue)} ms "
            f"per call (host alone), {b2b} ms per call back to back; the "
            f"bench line's device_ms {record['device_ms']}, value "
            f"{record['value']} ({card})")
        if not 0 < min(enqueue) <= b2b * 1.05:
            fail(f"{name}: Pipeline.process enqueue {min(enqueue)} ms, "
                 f"back to back {b2b} ms")
    launches["dma_floor"] = sum(run.floor.launches for run in runs)

    # ---- 6. the oracle at full size, and the throughput tool ----------------
    from openvr_fsr_tpu_torch.tools import parity as parity_tool
    from openvr_fsr_tpu_torch.tools import throughput_bench

    results = parity_tool.run(parity_tool.select(names=ORACLE_CASES))
    for name, r in results.items():
        log(f"[oracle] {name} at full size on the card against the NumPy "
            f"oracle: unequal {r['mismatch_gt0']} of {r['pixels']} values, "
            f"{r['mismatch_gt1']} above 1 LSB, max {r['max_lsb']} LSB, "
            f"{r['launches']} kernel launches ({card})")
        if not parity_tool.meets_bar(name, r) or r["launches"] < 1:
            fail(f"{name}: the card misses the oracle's bar: {r}")
    tp = throughput_bench.main(["8"])
    if not (math.isfinite(tp["value"]) and tp["value"] > 0):
        fail(f"throughput_bench: {tp}")

    # ---- 7. the rate probes and the audit -----------------------------------
    from openvr_fsr_tpu_torch.kernels import sol
    from openvr_fsr_tpu_torch.tools import sass, vpu_audit

    loops = sass.probe_loops()
    if loops is None:
        log("[probe] cuobjdump not found: SASS not checked")
    else:
        log(f"[probe] SASS of the metering loops: {loops}")
        if not (loops["vpu_rate"]["fp32_per_cycle"] >= 20
                and loops["vmem_rate"]["lds_in_loop"] >= 1
                and (loops["vmem_rate"]["words_per_lds"] or 99) <= 4
                and loops["mxu_rate"]["hgmma_per_round"] >= 8):
            fail(f"a rate probe lost the work it meters: {loops}")
        for name in ("fsr_fused", "rcas_sharpen", "nis_scaler", "nis_sharpen",
                     "cas_upscale", "cas_sharpen"):
            text = sass.disassemble(_build.library_path(name), _build._nvcc())
            for fn_name, ops in sass.function_counts(text).items():
                log(f"[probe] SASS {name}: {ops['LDS']} LDS in "
                    f"{fn_name[-40:]} (math reads "
                    f"{vpu_audit.SMEM_WORDS[name]} words per output, inside "
                    "and fallback)")
        # what fsr_fused's class kernels issue: the inside kernel's stage-1
        # loop (one EASU or bilinear position per pass; EASU's rcp is the
        # only MUFU) and the whole outside kernel (4 outputs per thread)
        text = sass.disassemble(_build.library_path("fsr_fused"),
                                _build._nvcc())
        stage1 = sass.innermost_loop(text, "fsr_inside_kernel", "FMUL",
                                     "STS", "MUFU")
        outside = [ops for fn, ops in sass.function_counts(text).items()
                   if "fsr_outside_kernel" in fn and sass.of_codec(fn)]
        for label, ops in (("inside kernel, stage-1 loop", stage1),
                           ("outside kernel", outside[0] if outside
                            else None)):
            if ops is None:
                log(f"[probe] SASS fsr_fused {label}: not found")
                continue
            log(f"[probe] SASS fsr_fused {label}: {sum(ops.values())} "
                f"instructions, conversions I2F {ops['I2F']} F2I "
                f"{ops['F2I']} FRND {ops['FRND']}; "
                f"{dict(ops.most_common(14))}")
        # B3's run loop (one output per pass: its longest loop), B5's whole
        # inside kernel (4 outputs per thread, unrolled), and B4's, B6's and
        # B2's inside kernels (4 outputs per thread: the first peeled, a
        # loop of one sliding step per output, or unrolled)
        for name, part in (("nis_scaler", "nis_inside_kernel"),
                           ("cas_upscale", "cas_inside_kernel"),
                           ("nis_sharpen", "nis_sharpen_inside_kernel"),
                           ("cas_sharpen", "cas_sharpen_inside_kernel"),
                           ("rcas_sharpen", "rcas_sharpen_inside_kernel")):
            text = sass.disassemble(_build.library_path(name), _build._nvcc())
            found_loops = sass.loops(text)
            for fn_name, whole in sass.function_counts(text).items():
                if part not in fn_name:
                    continue
                found = found_loops[fn_name]
                ops = found[-1][3] if found else None
                longest = (f"longest loop {sum(ops.values())} instructions, "
                           f"LDS {ops['LDS']}, LDC {ops['LDC']}, MUFU "
                           f"{ops['MUFU']}" if ops else "no loop")
                bits = 8 if sass.of_codec(fn_name) else 10
                log(f"[probe] SASS {name} {part} ({bits}-bit): {longest}; "
                    f"whole kernel {sum(whole.values())}, "
                    f"{dict(whole.most_common(8))}")
        # one inside output's float instructions in each inside kernel's
        # SASS (static: tools/sass.py::inside_float_per_output) beside the
        # meter's ops, which price B1-B6's f32 work in the kernels line
        for name, (fn, _) in timed.items():
            g = fn.dma_geometry
            in_per_out = g["in_h"] * g["in_w"] / (g["out_h"] * g["out_w"])
            meter = vpu_audit.path_ops(
                name, in_per_out=in_per_out,
                sharpness=CAS_SHARPNESS if name.startswith("cas")
                else SHARPNESS)[0]
            got = sass.inside_float_per_output(
                sass.disassemble(_build.library_path(name), _build._nvcc()),
                name, in_per_out)
            log(f"[probe] SASS {name} inside output: " + (
                f"{got[0]:.2f} arithmetic + {got[1]:.2f} compare/select "
                f"float instructions = {sum(got):.2f}; meter {meter:.2f} "
                f"ops (SASS / meter {sum(got) / meter:.3f})" if got else
                f"its loops not found; meter {meter:.2f} ops"))
        # the shared-memory probe's loops: the staging, the unrolled blocks
        # of 8 planes and their remainder, the predicated tail, the fold
        text = sass.disassemble(_build.library_path("vmem_rate"),
                                _build._nvcc())
        log("[probe] SASS vmem_rate_kernel loops (instructions, LDS, FMUL), "
            "shortest first: " + str(
                [(sum(o.values()), o["LDS"], o["FMUL"])
                 for fn, found in sass.loops(text).items()
                 if "vmem_rate_kernel" in fn for *_, o in found]))
    (vk, vsteps), (mk, msteps), (xk, xsteps) = (
        vpu_audit.PROBES[n][0][1:] for n in ("vpu", "vmem", "mxu"))
    seed = torch.from_numpy(rng.random((130, 128), np.float32)).to(dev)
    planes = torch.from_numpy(rng.random((mk, 130, 128), np.float32)).to(dev)
    mx = torch.from_numpy(rng.random((128, 128), np.float32)).to(dev)
    mw = torch.from_numpy(rng.random((128, 128), np.float32) * 0.1).to(dev)
    probes = {   # name -> (build at the audit's full k and steps, inputs)
        "vpu_rate": (sol.build_vpu_rate(vk, steps=vsteps), (seed,)),
        "vmem_rate": (sol.build_vmem_rate(mk, steps=msteps), (planes,)),
        "mxu_rate": (sol.build_mxu_rate(xk, steps=xsteps), (mx, mw)),
    }
    checks = [(name, fn, args) for name, (fn, args) in probes.items()]
    checks += [("mxu_rate", sol.build_mxu_rate(k, steps=n), (mx, mw))
               for k, n in ((1, 1), (2, 4), (8, 16))]
    for name, fn, args in checks:
        got, want = fn(*args), fn.reference(*args)
        torch.cuda.synchronize()
        ne = int((got != want).sum())
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        log(f"[probe] {name} k={fn.k} steps={fn.steps}: unequal {ne} of "
            f"{got.numel()}, max abs err {err} (max |plain| {top})")
        if not bool(torch.isfinite(got).all()) or got.shape != (8, 128):
            fail(f"{name}: output {tuple(got.shape)} not finite")
        if name == "mxu_rate":
            if err > sol.MXU_TOLERANCE * top:
                fail(f"mxu_rate: {err} above {sol.MXU_TOLERANCE} x {top}")
        elif ne:
            fail(f"{name} disagrees with its plain version")
        max_lsb[name] = max(max_lsb.get(name, 0.0), err)
    for name, (fn, args) in probes.items():
        rounds = {"kernel": [], "plain": []}
        for label, f, n in (("plain", fn.reference, 1), ("kernel", fn, 5),
                            ("kernel", fn, 5), ("plain", fn.reference, 1)):
            rounds[label].append(time_ms(lambda a: f(*a), args, n, warmup=1))
        ms[name] = float(np.mean(rounds["kernel"]))
        plain_ms[name] = float(np.mean(rounds["plain"]))
        log(f"[time] {name} k={fn.k} steps={fn.steps}: kernel "
            f"{rounds['kernel']} ms, plain torch {rounds['plain']} ms")
    # the yardstick beside the tensor-core probe: one round's bf16 product
    a16 = torch.rand((8 * 128, 128), device=dev).to(torch.bfloat16)
    w16 = mw.to(torch.bfloat16)
    library_ms = {"mxu_rate": time_ms(lambda a: torch.matmul(a, w16), a16,
                                      200)}
    log(f"[time] torch.matmul bf16 (1024, 128) @ (128, 128): "
        f"{library_ms['mxu_rate']} ms (one probe round of one step)")
    # what a library reaches on this card: cuBLAS on a compute-bound bf16
    # product (a yardstick beside the probe's rate, not a gate)
    big = torch.rand((8192, 8192), device=dev).to(torch.bfloat16)
    big_ms = time_ms(lambda a: torch.matmul(a, a), big, 20)
    log(f"[time] torch.matmul bf16 (8192, 8192) @ (8192, 8192): {big_ms} ms, "
        f"{8192 ** 3 / big_ms / 1e9:.6g} TMAC/s (card: {card})")
    del big

    # the audit, in this process: the probes it builds count from 0
    audit, audit_probes = vpu_audit.main([])
    nis_audit, nis_probes = vpu_audit.main(["--nis", "--quick"])
    for i, name in enumerate(probes):    # the audit's lo and hi builds
        launches[name] = sum(f.launches for f in audit_probes[2 * i:2 * i + 2])
    for res, built in ((audit, audit_probes), (nis_audit, nis_probes)):
        if any(f.launches == 0 for f in built):
            fail("an audit probe was never launched")
        r = res["rates"]
        for name, rate, bound in (
                ("fp32", r["fp32"]["instruction_rate"], r["fp32"]["bound"]),
                ("smem", r["smem"]["rate"], r["smem"]["bound"]),
                ("tensor", r["tensor"]["rate"], r["tensor"]["bound"])):
            log(f"[audit] {name}: {rate:.6g} /s (net of side work "
                f"{r[name].get('net_rate')}), spread {r[name]['spread']:.3f}, "
                f"bound {bound:.6g}")
            if not (math.isfinite(rate) and rate > 0):
                fail(f"audit {name} rate {rate}")
            if r[name]["spread"] > vpu_audit.MAX_SPREAD:
                fail(f"audit {name} spread {r[name]['spread']}")
            if rate > RATE_MAX * bound:
                fail(f"audit {name} rate {rate} above {RATE_MAX} x its bound "
                     f"{bound}: a wrong count or rate")
        for row in res["kernels"]:
            if row["launches"] == 0 or not row["share"] <= SHARE_MAX:
                fail(f"audit row {row['kernel']} radius {row['radius']}: "
                     f"share {row['share']}, launches {row['launches']}")

    # the least time the card could take for each timed call: its unique
    # bytes over the memory rate, its ops over the peak rate of their type
    # (f32 ops at the FP32 issue bound, SMs x 128 lanes x the max SM clock,
    # as the audit's floors; bf16 MACs at SMs x 2,048 x the same clock) and,
    # for the shared-memory probe, the plane bytes it reads over the card's
    # shared-memory bound, whichever is largest
    bound = vpu_audit.roofline_bound
    issue = audit["rates"]["fp32"]["bound"]
    bounds = {}
    for kernel, (fn, img) in timed.items():
        g = fn.dma_geometry
        inside, fallback = vpu_audit.inside_pixels(g)
        per_px = vpu_audit.path_ops(
            kernel, in_per_out=g["in_h"] * g["in_w"] / (g["out_h"] * g["out_w"]),
            sharpness=CAS_SHARPNESS if kernel.startswith("cas") else SHARPNESS)
        bounds[kernel] = bound(
            (img.numel() + 2 * g["out_h"] * g["out_w"]) * 4,
            inside * per_px[0] + fallback * per_px[1], issue)
    for kernel, (fn, img) in timed10.items():
        g = fn.dma_geometry
        inside, fallback = vpu_audit.inside_pixels(g)
        per_px = vpu_audit.path_ops(
            kernel, in_per_out=g["in_h"] * g["in_w"] / (g["out_h"] * g["out_w"]),
            sharpness=CAS_SHARPNESS if kernel.startswith("cas") else SHARPNESS)
        bounds[f"{kernel}_10bit"] = bound(
            img.numel() * 2 + 2 * g["out_h"] * g["out_w"] * 4,
            inside * per_px[0] + fallback * per_px[1], issue)
    # the strips compute the full launch's outputs from strips of rows
    for kernel in ("fsr_fused", "cas_upscale"):
        g = timed[kernel][0].dma_geometry
        inside, fallback = vpu_audit.inside_pixels(g)
        per_px = vpu_audit.path_ops(
            kernel, in_per_out=g["in_h"] * g["in_w"] / (g["out_h"] * g["out_w"]),
            sharpness=CAS_SHARPNESS if kernel.startswith("cas") else SHARPNESS)
        bounds[f"{kernel}_band"] = bound(
            strip_bytes[kernel] + 2 * g["out_h"] * g["out_w"] * 4,
            inside * per_px[0] + fallback * per_px[1], issue)
    ms.update({f"{k}_band": v for k, v in strip_ms.items()})
    plain_ms.update({f"{k}_band": v for k, v in strip_plain_ms.items()})
    bounds["dma_floor"] = bound(floor.hbm_bytes, 0, issue)
    bounds["dma_floor_10bit"] = bound(floor10.hbm_bytes, 0, issue)
    bounds.update(vpu_audit.probe_bounds(
        *(probes[n][0] for n in ("vpu_rate", "vmem_rate", "mxu_rate")),
        audit["rates"]["sms"], audit["rates"]["max_sm_clock_hz"],
        audit["rates"]["fp32"]["fp32_instructions_per_cycle"]))
    log(f"[bound] {bounds}")

    # ---- 8. result lines ----------------------------------------------------
    sources = {
        "fsr_fused": "openvr_fsr_tpu/kernels/fsr.py:191",
        "rcas_sharpen": "openvr_fsr_tpu/kernels/rcas.py:35",
        "nis_sharpen": "openvr_fsr_tpu/kernels/nis.py:125",
        "nis_scaler": "openvr_fsr_tpu/kernels/nis.py:371",
        "cas_upscale": "openvr_fsr_tpu/kernels/cas.py:67",
        "cas_sharpen": "openvr_fsr_tpu/kernels/cas.py:418",
        "dma_floor": "openvr_fsr_tpu/kernels/sol.py:39",
        "vpu_rate": "openvr_fsr_tpu/kernels/sol.py:133",
        "vmem_rate": "openvr_fsr_tpu/kernels/sol.py:202",
        "mxu_rate": "openvr_fsr_tpu/kernels/sol.py:276",
    }
    # the 10-bit instantiations and the strips: the same sources and TPU
    # kernels (their color_bits=10 and band_range branches)
    sources.update({f"{k}_10bit": sources[k] for k in (*EXACT, "dma_floor")})
    sources.update({f"{k}_band": sources[k]
                    for k in ("fsr_fused", "cas_upscale")})
    log(card)
    log(json.dumps({"kernels": [{
        "name": kernel,
        "route": "cuda",
        "source": "openvr_fsr_tpu_torch/csrc/"
                  f"{kernel.removesuffix('_10bit').removesuffix('_band')}.cu",
        "replaces": replaces,
        "launches": launches[kernel],
        "max_abs_err": max_lsb[kernel],
        "ms": ms[kernel],
        "plain_ms": plain_ms[kernel],
        "bound_ms": bounds[kernel][0],
        "bound_by": bounds[kernel][1],
        "library_ms": library_ms.get(kernel),
    } for kernel, replaces in sources.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
