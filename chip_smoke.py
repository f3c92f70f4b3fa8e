#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (openvr_fsr_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments (one card):

    python3 chip_smoke.py [--parent DIR]

--parent DIR names a directory of earlier csrc sources (fsr_fused.cu,
nis_scaler.cu, cas_upscale.cu, dma_floor.cu, rcas_sharpen.cu and the
headers they were written with, e.g. `git archive <commit>
openvr_fsr_tpu_torch/csrc` unpacked into an ignored directory); phase 1
then holds the current builds of those kernels to it (below). The run builds the CUDA kernels from
openvr_fsr_tpu_torch/csrc with nvcc (sm_90a), one nvcc per source, all at
once, into openvr_fsr_tpu_torch/_build/. Phases, in order; any failure
exits non-zero before the result lines:

  1. setup: card, power limit, toolchain versions (g++ among them: it
     builds the native runtime library), the kernel builds, and
     the registers, spills and CTAs per SM of the two class kernels of each
     upscaler (fsr_fused, nis_scaler, cas_upscale: the shared bilinear pass
     outside the foveation circle, and the kernel inside it) and of
     nis_sharpen, cas_sharpen and rcas_sharpen (the shared copy pass
     outside, the kernel inside), each at both texel formats (the RGBA8
     and R10G10B10A2 instantiations; a warning where the 10-bit one holds
     fewer CTAs per SM), and the registers, spills and CTAs per SM of
     fsr_fused's and cas_upscale's band instantiations (the row-band
     strips', full and half); every instantiation of the bilinear pass
     (each *_outside_kernel of fsr_fused, nis_scaler and cas_upscale, at
     8 and 10 bits, band too) with its conversion instructions (I2F, F2I,
     FRND, F2F: the codec's exact forms leave none, else the run fails),
     FSETP and FSEL from its SASS (tools/sass.py); with --parent, the
     same counts of the parent's builds, and every other function of the
     parent's fsr_fused, nis_scaler, cas_upscale, dma_floor and
     rcas_sharpen libraries (the inside kernels, full, half and band, the
     floor's TMA forms, B2's copy pass) but those REDESIGNED names (B2's
     RGBA8 inside kernel, on the texels' levels; B1's inside kernels, with
     EASU's terms per window texel) must have compiled to the
     same SASS in the current build (tools/ab.py::same_sass), else the run
     fails;
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
     strips against the plain version on the CPU; the half strips
     (band_range with precision="half") at 8 and 10 bits, split 3 ways,
     every 32-row band alone (off-centre eyes) and 24-row bands, each
     against the half single launch and every strip against its plain
     bf16 version, 0 unequal texels or values, and a small case against the
     CPU path; every strip's DMA floor (B7: its band form where a band edge
     cuts a tile), full and half, 0 unequal words against its plain
     version and vs_sol at most 1.02 (device times from CUDA graphs of
     STRIP_ITERS calls on the strip at the ring pitch). Then the spatial
     path's entry point, SpatialFsrPipeline with 3 strips on this card for
     FSR and CAS at 2 x 1683x1869 -> 2 x 2244x2492, its launch counts set
     to 0 just before 10 steady-state process_placed calls under
     torch.cuda.set_sync_debug_mode("error") (no host sync) and read just
     after, equal to Pipeline.process; the strips' summed device time
     beside the single launch's; each strip's floor (the whole form, as
     each 128-row band starts on a tile row), N_PAIRS calls with its
     launch count from 0, equal to its plain version, timed beside its
     strip; the band form's path: the floors of the full-size 24-row strips
     split 3 ways whose first row cuts a tile (FSR and CAS), N_PAIRS calls
     each with the counts from 0, equal to their plain versions, timed
     beside their strips (vs_sol at most 1.02); the half strips through
     the builders, N_PAIRS calls each with the counts from 0, equal to the
     half single launch, timed;
     ShardedPipeline over [cuda:0] * 2 and
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
  4b. half precision ([half] lines): the half instantiations of all six
     compute kernels (precision="half", bf16 op by op as the JAX package's
     half cores; NIS under its kernels' half policy): their registers,
     spills (none beyond the full instantiation's) and CTAs per SM at both
     texel formats, and fsr_fused's and cas_upscale's half band
     instantiations beside them (a spill is logged); each against its
     plain bf16 version at full size, 0
     unequal texels: fsr_fused at radius 0.5, 2.0, 0.0 with debug and rs
     1.3, rcas_sharpen, cas_upscale and cas_sharpen at radius 0.5 and 2.0,
     nis_scaler and nis_sharpen at radius 0.5, 2.0, 0.0 with debug, two
     off-centre eyes at radius 0.3 and hdr_mode 1 and 2 at radius 2.0, on
     both 8-bit sets, and one 10-bit case per kernel (radius 0.5, both
     10-bit sets, 0 unequal values), each with its largest difference from
     the full kernel; the seven plans through Pipeline(precision="half")
     with no device (N_PAIRS packed pairs, the launch counts set to 0 just
     before and read just after, equal to the kernel and to
     upscale(precision="half")), the six 10-bit plans the same way, and
     toggle_nis() on a live half FSR pipeline (NVScaler at half, N_PAIRS
     calls, equal to the half nvscaler plan); tools.half_bench over the
     seven paths in this process (its vs_sol and value held as
     bench_paths' are); each half kernel at radius 0.5 timed in turns with
     its plain version for the kernels line, and at radius 2.0 in turns
     with its full kernel;
  5. the measurement path: the DMA floor (csrc/dma_floor.cu) keeps its
     TMA loads, shared reads and stores in the SASS of its ring forms (its
     one-box form, dma_floor_one_kernel, its stores), and equals its plain
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
     back-to-back time (tools/api_cost.py), taken in turns from one warm
     state (an enqueue round of 40 calls, a sync, a back-to-back round of
     40, five times; each round's pair logged), the least enqueue at most
     1.05 x the least back-to-back time;
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
  6b. the native runtime library, the stream, the 8K batch, the trace and
     the demo (phase_6b), each build's launch count from 0: [native] the
     library built with g++ from csrc/ovrfsr_native.cc, its FrameRing
     through a threaded push/pop of 64 tagged slots, in order; [stream]
     tools.stream_bench at the headline shape, a ring per eye: 3 s
     unpaced (at least 90 pairs/s, no tolerance) and 3 s paced at 90
     (drops, p50 / p99 ms per pair, the uploader's busy share), 3 s
     unpaced through the JAX tool's one ring of stereo slots (recorded),
     then 3 s device-resident: every
     frame's tag, read back from device memory behind its kernel, equal to
     the popped tags in push order, and a sampled output bit-equal to
     run() of that frame placed in device memory (the tool raises
     otherwise); [8k] tools.bench_8k at batches 4, 8, 16 and 32 (5760x3240
     -> 7680x4320, radius 2.0): ms per frame back to back, device_ms from
     a CUDA graph, the B7 floor and vs_sol (at most 1.02), peak memory,
     frames 0 and B-1 of each batch launch bit-equal to batch-1 launches;
     [trace] bench_fn on the headline with profile_dir, its Chrome trace
     holding B1's outside and inside kernel once per timed call and
     nothing else, their summed device time beside the event time (a
     CUPTI refusal must be bench_fn's named RuntimeError, logged); [demo]
     tools.demo scripted (--frames 8 --keys d+]c) on the card, its
     deferred capture written with the expected name and shape. Their B1
     and B7 launches join the kernels line's;
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
     time and their bytes the strips' rows; the half strips as
     fsr_fused_band_half and cas_upscale_band_half, the same way; the
     band-form floors of the 24-row strips as dma_floor_band, their ms
     and bytes summed the same way; each
     bound the largest
     of its unique bytes over 3.35 TB/s, its operations over the peak for
     their type (the half instantiations as <kernel>_half, their bf16 ops
     at twice the FP32 rate, tools/vpu_audit.py::issue_slots): f32 work,
     the FP32 probe's as the FP32 instructions its SASS keeps per cycle, at the FP32 issue bound SMs x 128 lanes x the
     max SM clock, bf16 MACs at SMs x 2,048 x the max SM clock, and, for the
     shared-memory probe, the plane bytes it reads over SMs x 128 B x the
     max SM clock: tools/vpu_audit.py::roofline_bound, probe_bounds), and
     {"ok": true, ...}.

Exits non-zero, printing no result, when torch finds no CUDA GPU.
"""

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
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
RING_SLOTS = 64              # tagged slots through the native ring ([native])
STREAM_S = 3.0               # seconds of each stream run ([stream])
TRACE_ITERS = 20             # timed calls under the profiler ([trace])
SHARE_MAX = 1.05             # an audit row's bound over its time
N_PAIRS = 10                 # stereo pairs per plan through the public API
# the [api] lines: rounds of an enqueue of API_CALLS calls, then as many
# back to back, in turns; min against min, at most API_MAX
API_ROUNDS, API_CALLS, API_MAX = 5, 40, 1.05
STRIPS = 3                   # row-band strips of the spatial path
STRIP_ITERS = 200            # calls per graph timing each strip and its floor
# the kernels whose parent SASS phase 1 compares with --parent: every
# function but the bilinear pass's (PASS_KERNELS' outside kernels, held to
# CONVERSIONS instead) and the REDESIGNED ones
PARENT_KERNELS = ("fsr_fused", "nis_scaler", "cas_upscale", "dma_floor",
                  "rcas_sharpen")
# (kernel function, texel bits) whose SASS the current source changed on
# purpose: B2's inside kernel at RGBA8 (full precision), which computes
# RCAS on the texels' 256 levels (csrc/rcas_sharpen.cu), and B1's inside
# kernels (whole and band, full and half, both codecs), which compute
# EASU's analysis terms once per window texel (csrc/fsr_fused.cu)
REDESIGNED = (("rcas_sharpen_inside_kernel", 8),
              *((f"fsr_{form}inside_kernel", bits)
                for form in ("", "band_", "half_", "band_half_")
                for bits in (8, 10)))
# the libraries of the bilinear pass (csrc/bilinear_pass.cuh), and the
# conversion instructions none of its instantiations may hold
PASS_KERNELS = ("fsr_fused", "nis_scaler", "cas_upscale")
CONVERSIONS = ("I2F", "F2I", "FRND", "F2F")
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


def phase_6b(card, x):
    """Phase 6b: the native library and its ring, the stream, the 8K
    batch, bench_fn's trace and the scripted demo, each on the card through
    the port's own entry points, every build counting from 0. x: the
    headline's (2, H, W) packed stereo pair for the trace. Returns the B1
    and B7 launches of these runs."""
    from openvr_fsr_tpu_torch import Config, Pipeline, native_rt
    from openvr_fsr_tpu_torch.tools import bench_8k, demo, stream_bench
    from openvr_fsr_tpu_torch.utils.timing import bench_fn, kernel_events

    t_6b = time.perf_counter()
    t0 = time.perf_counter()
    native_rt.build()
    log(f"[native] {native_rt.library_path().name} built with g++ "
        f"{' '.join(native_rt.CXX_FLAGS)} in {time.perf_counter() - t0:.2f} s")
    ring = native_rt.FrameRing(4096, nslots=6)

    def ring_producer():
        for i in range(RING_SLOTS):
            ring.push(np.full(1024, i, np.int32))

    producer = threading.Thread(target=ring_producer)
    producer.start()
    tags = [int(ring.pop((1024,), np.int32)[0]) for _ in range(RING_SLOTS)]
    producer.join(timeout=10)
    stats = ring.stats()
    ring.close()
    log(f"[native] FrameRing, threaded push/pop of {RING_SLOTS} tagged slots: "
        f"tags in order {tags == list(range(RING_SLOTS))}, stats {stats}")
    if producer.is_alive() or tags != list(range(RING_SLOTS)) or stats != {
            "pushed": RING_SLOTS, "popped": RING_SLOTS, "dropped": 0,
            "depth": 0}:
        fail(f"FrameRing: tags {tags}, stats {stats}")

    # the stream (tools/stream_bench.py): unpaced (gated) and paced at 90
    # through a ring per eye, the JAX tool's one ring (recorded), then
    # device-resident; each build counts from 0. A wrong tag or output
    # raises inside the tool.
    row, kern = stream_bench.measure(seconds=STREAM_S, log=log)
    paced = row["paced"]
    log(f"[stream] unpaced {row['value']} pairs/s (target "
        f"{row['target_fps']}, verdict {row['verdict']}); device-only "
        f"{row['device_only_pairs_per_s']} pairs/s; upload "
        f"{row['upload_gbs_this_session']} GB/s (need "
        f"{row['upload_need_gbs']}); paced at {paced['fps']}: "
        f"{paced['pairs_per_s']} pairs/s, dropped {paced['ring_dropped']} of "
        f"{paced['ring_pushed'] + paced['ring_dropped']}, p50 "
        f"{paced['p50_ms_per_pair']} p99 {paced['p99_ms_per_pair']} ms per "
        f"pair against a {paced['frame_budget_ms']} ms budget, uploader busy "
        f"{paced['uploader_busy_share']}; the JAX tool's one ring of stereo "
        f"slots, unpaced: {row['one_ring']['pairs_per_s']} pairs/s, uploader "
        f"busy {row['one_ring']['uploader_busy_share']}; B1 launches "
        f"{kern.launches} ({card})")
    log(f"[stream] row {json.dumps(row)}")
    if row["value"] < row["target_fps"] or row["verdict"] != "pass":
        fail(f"stream: {row['value']} pairs/s unpaced, below "
             f"{row['target_fps']} ({row['verdict']})")
    if not (row["unpaced"]["sample_equal"] and paced["sample_equal"]):
        fail("stream: no sampled output was checked")
    stream_launches = kern.launches
    row_r, kern = stream_bench.measure(seconds=STREAM_S, fps=0,
                                       device_resident=True, log=log)
    log(f"[stream] device-resident unpaced {row_r['value']} pairs/s, p50 "
        f"{row_r['p50_ms_per_pair']} p99 {row_r['p99_ms_per_pair']} ms; B1 "
        f"launches {kern.launches} ({card})")
    stream_launches += kern.launches
    if not stream_launches or not row_r["unpaced"]["sample_equal"]:
        fail("stream: the kernel was not launched or no output checked")

    # the 8K batch (tools/bench_8k.py): frames 0 and B-1 of each batch
    # launch equal batch-1 launches (the tool raises otherwise)
    k8_launches = f8_launches = 0
    for b in bench_8k.BATCHES:
        row8, kern, floor8 = bench_8k.measure(b, log=log)
        k8_launches += kern.launches
        f8_launches += floor8.launches
        log(f"[8k] batch {b}: {row8['value']} ms/frame back to back, "
            f"device_ms {row8['device_ms']} per frame, floor "
            f"{row8['floor_ms']}, vs_sol {row8['vs_sol']}, "
            f"{row8['mpix_per_s_per_chip']} Mpix/s, peak memory "
            f"{row8['peak_memory_bytes']} B ("
            f"{row8['peak_memory_bytes'] - row8['memory_at_start_bytes']} B "
            f"above the start), frames equal to batch-1 "
            f"launches {row8['frames_equal_to_batch1']}; launches B1 "
            f"{kern.launches}, B7 {floor8.launches} ({card})")
        for key in ("value", "device_ms", "floor_ms"):
            if not (math.isfinite(row8[key]) and row8[key] > 0):
                fail(f"8k batch {b}: {key} = {row8[key]}")
        if row8["vs_sol"] > VS_SOL_MAX or not all(
                row8["frames_equal_to_batch1"].values()):
            fail(f"8k batch {b}: {row8}")
        if not (kern.launches and floor8.launches):
            fail(f"8k batch {b}: a kernel was not launched")

    # the trace: bench_fn on the headline under torch.profiler
    pipe = Pipeline(Config(enabled=True, render_scale=0.75,
                           sharpness=SHARPNESS, radius=0.5))
    run = pipe._build(2, H, W, (0, 1), packed=True)
    run(x)
    run.kernel.launches = 0
    with tempfile.TemporaryDirectory() as trace_dir:
        try:
            best, avg = bench_fn(run, x, warmup=3, iters=TRACE_ITERS,
                                 profile_dir=trace_dir)
        except RuntimeError as e:
            if "CUPTI" not in str(e):
                raise
            log(f"[trace] bench_fn refused the trace: {e} ({card})")
        else:
            traces = list(Path(trace_dir).glob("bench_fn_*.json"))
            if len(traces) != 1:
                fail(f"trace: {traces}")
            events = kernel_events(traces[0])
            b1 = [(n, us) for n, us in events
                  if "fsr_outside_kernel" in n or "fsr_inside_kernel" in n]
            log(f"[trace] {traces[0].name} ({traces[0].stat().st_size} B): "
                f"{len(events)} CUDA kernel events over {TRACE_ITERS} timed "
                f"calls, {len(b1)} of B1 ("
                f"{sorted({re.search(r'fsr_\w+_kernel', n)[0] for n, _ in b1})}"
                f"); their summed "
                f"device time {sum(us for _, us in b1) / 1000.0} ms, the "
                f"calls' event time {avg * TRACE_ITERS} ms (best {best}, "
                f"average {avg} ms per call, the profiler's cost included) "
                f"({card})")
            if len(b1) != 2 * TRACE_ITERS or len(events) != len(b1):
                fail(f"trace: {len(b1)} B1 kernel events of {len(events)}, "
                     f"expected 2 per call over {TRACE_ITERS} calls")
    trace_launches = run.kernel.launches

    # the demo, scripted, on the card: its capture of the next frame
    with tempfile.TemporaryDirectory() as cap_dir:
        demo_pipe = demo.main(["--frames", "8", "--keys", "d+]c", "--out",
                               cap_dir])
        ow, oh = demo_pipe.output_size(1280, 720)
        caps = sorted(Path(cap_dir).glob("capture_*_fsr_s95_r55.*"))
        npy = [np.load(p) for p in caps if p.suffix == ".npy"]
        log(f"[demo] {[p.name for p in caps]}, npy shape "
            f"{[a.shape for a in npy]}; the last build's B1 launches "
            f"{[k.launches for k in demo_pipe.kernels]} "
            f"({demo_pipe.device})")
        if demo_pipe.device.type != "cuda" or len(caps) != 2 or \
                len(npy) != 1 or npy[0].shape != (oh, ow, 4) or \
                not sum(k.launches for k in demo_pipe.kernels):
            fail(f"demo: captures {caps}")
        demo_launches = sum(k.launches for k in demo_pipe.kernels)
    log(f"[6b] phase took {time.perf_counter() - t_6b:.1f} s; B1 launches: "
        f"stream {stream_launches}, 8K {k8_launches}, trace "
        f"{trace_launches}, demo {demo_launches}; B7 (8K floors) "
        f"{f8_launches}")
    return (stream_launches + k8_launches + trace_launches + demo_launches,
            f8_launches)


def parent_libraries(parent):
    """{kernel: the parent's library, built from parent/<kernel>.cu with its
    own headers first} for PARENT_KERNELS."""
    from openvr_fsr_tpu_torch.tools import ab
    return {k: ab.compile_parent(k, Path(parent) / f"{k}.cu")[1]
            for k in PARENT_KERNELS}


def pass_counts(lib):
    """{(pass kernel, texel bits): Counter of opcodes} for every bilinear
    pass instantiation (an *_outside_kernel) in a built library's SASS, or
    None without cuobjdump."""
    from openvr_fsr_tpu_torch.kernels import _build
    from openvr_fsr_tpu_torch.tools import sass
    text = sass.disassemble(lib, _build._nvcc())
    if text is None:
        return None
    return {(re.search(r"[a-z_]+_outside_kernel", fn).group(0),
             8 if sass.of_codec(fn) else 10): ops
            for fn, ops in sass.function_counts(text).items()
            if "_outside_kernel" in fn}


def log_pass_counts(kernel, counts, side):
    """Log each pass instantiation's conversions, FSETP and FSEL; return
    those that hold a conversion."""
    bad = []
    for (name, bits), ops in sorted(counts.items()):
        conv = {o: ops[o] for o in CONVERSIONS}
        log(f"[setup] {side} {kernel} {name} {bits}-bit SASS: conversions "
            f"{conv}, FSETP {ops['FSETP']}, FSEL {ops['FSEL']}, "
            f"{sum(ops.values())} instructions")
        if any(conv.values()):
            bad.append(f"{kernel} {name} {bits}-bit {conv}")
    return bad


def main():
    ap = argparse.ArgumentParser(prog="python3 chip_smoke.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a directory of earlier csrc sources whose "
                         f"{', '.join(PARENT_KERNELS)} the current builds "
                         "must compile to the same SASS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch finds no CUDA GPU")
    if args.parent is not None and not all(
            (Path(args.parent) / f"{k}.cu").is_file() for k in PARENT_KERNELS):
        fail(f"--parent {args.parent}: no {PARENT_KERNELS} sources there")
    from openvr_fsr_tpu_torch import (CasModel, Config, FsrModel, Pipeline,
                                      get_model, upscale)
    from openvr_fsr_tpu_torch.core import constants as C
    from openvr_fsr_tpu_torch.kernels import _build
    from openvr_fsr_tpu_torch.kernels._common import (band_occupancy,
                                                      occupancy)
    from openvr_fsr_tpu_torch.kernels.cas import (build_cas_sharpen,
                                                  build_cas_upscale)
    from openvr_fsr_tpu_torch.kernels.fsr import build_fsr_fused
    from openvr_fsr_tpu_torch.kernels.nis import build_nvscaler, build_nvsharpen
    from openvr_fsr_tpu_torch.kernels.rcas import build_rcas_sharpen
    from openvr_fsr_tpu_torch.tools import ab, sass
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
    # the native runtime library (csrc/ovrfsr_native.cc) builds with g++,
    # nvcc's host compiler
    from openvr_fsr_tpu_torch import native_rt
    gxx = subprocess.run([native_rt._cxx(), "--version"], capture_output=True,
                         text=True, timeout=60)
    log(f"[setup] g++: {gxx.stdout.strip().splitlines()[0]}")
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
    # kernel -> the prefix of its class kernels' names
    prefixes = {"fsr_fused": "fsr", "nis_scaler": "nis", "cas_upscale": "cas",
                "nis_sharpen": "nis_sharpen", "cas_sharpen": "cas_sharpen",
                "rcas_sharpen": "rcas_sharpen"}
    for kernel, prefix in prefixes.items():
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
        # each store; the inside kernel at full and half precision)
        for fn, u in usage.items():
            if f"{prefix}_band_" in fn:
                bits = 8 if sass.of_codec(fn) else 10
                part = fn.split("_band_")[1].split("_kernel")[0]
                prec = "half" if part.startswith("half") else "full"
                ctas = (f", {band_occupancy(kernel, bits, prec)} CTAs per SM"
                        if part.endswith("inside") else "")
                log(f"[setup] {kernel} {bits}-bit {part.replace('_', ' ')} "
                    f"band kernel: {u['registers']} registers, "
                    f"{u['spill_stores']} B spill stores, "
                    f"{u['spill_loads']} B spill loads{ctas}")
    # the bilinear pass decodes, saturates, rounds and encodes in the
    # codecs' exact forms (csrc/codec.cuh): no conversion instruction in
    # any of its instantiations
    bad = []
    for kernel in PASS_KERNELS:
        counts = pass_counts(_build.library_path(kernel))
        if not counts:
            fail(f"{kernel}: no bilinear pass SASS read (cuobjdump beside "
                 "nvcc?)")
        bad += log_pass_counts(kernel, counts, "current")
    if bad:
        fail(f"bilinear pass instantiations that hold a conversion: {bad}")
    # with --parent: every function of the parent's libraries but the
    # bilinear pass's (the inside kernels, full, half and band; the floor's
    # TMA forms) keeps its SASS
    if args.parent is None:
        log("[setup] sass_same: no parent sources given (--parent DIR)")
    else:
        libs = parent_libraries(args.parent)
        for kernel in PASS_KERNELS:
            log_pass_counts(kernel, pass_counts(libs[kernel]) or {}, "parent")
        same = {k: ab.same_sass(lib, _build.library_path(k))
                for k, lib in libs.items()}
        for lib, fns in same.items():
            for fn, ok in (fns or {}).items():
                log(f"[setup] sass_same {lib} {fn}: {ok} (against "
                    f"{args.parent})")
        def held(lib, fn):
            return not (lib in PASS_KERNELS and "_outside_kernel" in fn
                        or any(part in fn and sass.of_codec(fn, bits)
                               for part, bits in REDESIGNED))
        changed = [f"{lib} {fn}" for lib, fns in same.items()
                   for fn, ok in (fns or {"": None}).items()
                   if ok is not True and held(lib, fn)]
        if changed:
            fail(f"parent functions whose SASS changed, went or could not "
                 f"be read: {changed}")
        kept = sum(1 for lib, fns in same.items() for fn in fns
                   if held(lib, fn))
        log(f"[setup] sass_same: all {kept} functions of {list(same)} but "
            f"the bilinear pass's and {REDESIGNED} as {args.parent} built "
            "them")

    def centres(ow, oh, radius, b=2, eyes=CENTRES):
        return C.centres_payload(ow, oh, radius, eyes,
                                 tuple(i % 2 for i in range(b)))

    def fsr(radius, debug=False, h=H, w=W, rs=0.75, b=2, eyes=CENTRES,
            bits=8, **kw):
        ow, oh = Config(render_scale=rs).output_size(w, h)
        return build_fsr_fused(b, h, w, ow, oh, sharpness=SHARPNESS,
                               centres=centres(ow, oh, radius, b, eyes),
                               debug=debug, color_bits=bits, **kw)

    def rcas(radius, debug=False, h=OH, w=OW, b=2, eyes=CENTRES, bits=8,
             **kw):
        return build_rcas_sharpen(b, h, w, sharpness=SHARPNESS,
                                  centres=centres(w, h, radius, b, eyes),
                                  debug=debug, color_bits=bits, **kw)

    def sharpen(radius, debug=False, hdr=0, h=OH, w=OW, b=2, eyes=CENTRES,
                bits=8, **kw):
        cfg = C.nvsharpen_update_config(SHARPNESS, w, h, w, h, hdr_mode=hdr)
        return build_nvsharpen(b, h, w, nis_cfg=cfg,
                               centres=centres(w, h, radius, b, eyes),
                               debug=debug, color_bits=bits, **kw)

    def scaler(radius, debug=False, hdr=0, h=H, w=W, rs=0.75, b=2,
               eyes=CENTRES, bits=8, **kw):
        ow, oh = Config(render_scale=rs).output_size(w, h)
        cfg = C.nvscaler_update_config(SHARPNESS, w, h, w, h, ow, oh, ow, oh,
                                       hdr_mode=hdr)
        return build_nvscaler(b, h, w, ow, oh, nis_cfg=cfg,
                              centres=centres(ow, oh, radius, b, eyes),
                              debug=debug, color_bits=bits, **kw)

    def cas_up(radius, debug=False, h=H, w=W, rs=0.75, b=2, eyes=CENTRES,
               bits=8, **kw):
        ow, oh = Config(render_scale=rs).output_size(w, h)
        return build_cas_upscale(b, h, w, ow, oh, sharpness=CAS_SHARPNESS,
                                 centres=centres(ow, oh, radius, b, eyes),
                                 debug=debug, color_bits=bits, **kw)

    def cas_sh(radius, debug=False, mcd=1.0, h=OH, w=OW, b=2, eyes=CENTRES,
               bits=8, **kw):
        return build_cas_sharpen(b, h, w, sharpness=CAS_SHARPNESS,
                                 centres=centres(w, h, radius, b, eyes),
                                 debug=debug, max_color_delta=mcd,
                                 color_bits=bits, **kw)

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
    from openvr_fsr_tpu_torch.kernels.sol import build_dma_floor
    t_strips = time.perf_counter()
    for k in ("fsr_fused_band", "cas_upscale_band", "fsr_fused_band_half",
              "cas_upscale_band_half", "dma_floor_band"):
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

    def ring_of(floor, x):
        """The strip x padded to the ring pitch, which the floor's TMA
        takes."""
        hp, wp = floor.pad_to
        ring = torch.zeros((x.shape[0], hp, wp, *x.shape[3:]), dtype=x.dtype,
                           device=dev)
        ring[:, :, :x.shape[2]] = x
        return ring

    def strip_floor(fn, x):
        """The strip's DMA floor (its band form where a band edge cuts a
        tile) on the strip padded to the ring pitch: (unequal words against
        its plain version, vs_sol: its device time over the strip kernel's
        on that input, whether it ran the band form)."""
        floor = build_dma_floor(fn.dma_geometry)
        ring = ring_of(floor, x)
        ne = int((floor(ring) != floor.reference(ring)).sum())
        k_ms = graph_ms(fn, ring, STRIP_ITERS)
        return (ne, graph_ms(floor, ring, STRIP_ITERS) / k_ms,
                floor.band_form)

    def strips(kernel, label, img, radius=0.5, band_rows=128, n=STRIPS,
               want=None, precision="full", **kw):
        """The concatenated strips of `kernel` at `precision` on img (n
        equal splits of the bands, or every band alone where n is None)
        against the single launch (or `want`), each strip kernel launched
        once; at half each strip also against its plain bf16 version on
        the card. Each strip's floor against its plain version, with its
        vs_sol."""
        build, layout = layouts[kernel]
        full = build(radius, precision=precision, **kw)
        want = full(img) if want is None else want
        _, gy = layout(want.shape[2], want.shape[1], band_rows)
        outs, plain_ne, floor_ne, vs_sol, banded = [], 0, 0, [], 0
        for g0, g1 in split_bands(gy, gy if n is None else n):
            fn = build(radius, band_rows=band_rows, band_range=(g0, g1),
                       precision=precision, **kw)
            x = img[:, fn.in_row_base:fn.in_row_base + fn.in_rows].contiguous()
            got = fn(x)
            if fn.launches != 1 or got.shape[1] != fn.out_rows \
                    or fn.precision != precision:
                fail(f"{kernel} {precision} strip {(g0, g1)}: {fn.launches} "
                     f"launches, {got.shape[1]} of {fn.out_rows} rows")
            if precision == "half":
                plain_ne += int((got != fn.reference(x)).sum())
            ne, vs, band_form = strip_floor(fn, x)
            floor_ne, vs_sol = floor_ne + ne, vs_sol + [vs]
            banded += band_form
            outs.append(got)
        got = torch.cat(outs, 1)
        torch.cuda.synchronize()
        ne, mx = value_diff(got, want.to(got.device))
        tag = kernel if precision == "full" else f"{kernel} half"
        log(f"[strip] {tag} {label} band_rows={band_rows}, {len(outs)} "
            f"strips: unequal {ne} of {want.numel()} against the single "
            "launch" + (f", {plain_ne} against the strips' plain bf16 "
                        "versions" if precision == "half" else "")
            + f"; floors ({banded} of {len(outs)} in the band form): "
            f"unequal {floor_ne} words, vs_sol "
            f"{min(vs_sol):.4f}-{max(vs_sol):.4f}")
        if ne or plain_ne:
            fail(f"{kernel} {precision}: the strips differ from the single "
                 f"launch or their plain versions ({label}, band_rows "
                 f"{band_rows}: {ne}, {plain_ne} unequal)")
        if floor_ne or max(vs_sol) > VS_SOL_MAX:
            fail(f"{kernel} {precision} ({label}, band_rows {band_rows}): "
                 f"strip floors unequal {floor_ne}, vs_sol {max(vs_sol)}")
        floor_vs_sol.extend(vs_sol)
        band_strips[0] += banded
        band_strips[1] += len(outs)
        name = f"{kernel}_band" + ("_half" if precision == "half" else "")
        max_lsb[name] = max(max_lsb[name], mx)

    floor_vs_sol, band_strips = [], [0, 0]
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
        # the half strips (the builders' band_range with precision="half"):
        # split STRIPS ways, every band alone at 32 rows, and 24-row bands,
        # at 8 and 10 bits; one small case against the CPU path
        for bits, img in ((8, sets["in"]["zone+noise"]),
                          (10, sets10["in"]["zone10+noise10"])):
            strips(kernel, f"{shape_in} {bits}-bit radius=0.5", img,
                   precision="half", bits=bits)
            strips(kernel, f"{shape_in} {bits}-bit radius=0.3 eyes "
                   f"{OFF_CENTRE} every band alone", img, 0.3, band_rows=32,
                   n=None, precision="half", bits=bits, eyes=OFF_CENTRE)
            strips(kernel, f"{shape_in} {bits}-bit radius=2.0 (band edges "
                   "inside tiles)", img, 2.0, band_rows=24, precision="half",
                   bits=bits)
        want = layouts[kernel][0](0.5, h=96, w=128, precision="half")(
            small_img.cpu()).to(dev)
        strips(kernel, "2x128x96 rs=0.75 against the CPU path", small_img,
               band_rows=24, want=want, precision="half", h=96, w=128)
    log(f"[strip] floors of {len(floor_vs_sol)} strips ({band_strips[0]} "
        "in the band form; each on dma_floor_one_kernel where its grid holds "
        "a CTA per box item, else on dma_floor_band_kernel or "
        "dma_floor_kernel): 0 unequal words, "
        f"vs_sol {min(floor_vs_sol):.4f}-{max(floor_vs_sol):.4f} ({card}); "
        f"the strip cases took {time.perf_counter() - t_strips:.1f} s")
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
    band_ms, band_plain_ms = {}, {}   # the half strips' and strip floors'
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
        # each strip's floor on its placed strip, N_PAIRS calls each,
        # counts from 0: the whole form (dma_floor_kernel), since each
        # 128-row band starts on a 32-row tile
        floors = [build_dma_floor(fn.dma_geometry) for fn, *_ in shards]
        for f, x in zip(floors, placed[1]):
            f(x)
        torch.cuda.synchronize()
        for f in floors:
            f.launches = 0
        for _ in range(N_PAIRS):
            for f, x in zip(floors, placed[1]):
                f(x)
        torch.cuda.synchronize()
        counts = [f.launches for f in floors]
        unequal = sum(int((f(x) != f.reference(x)).sum())
                      for f, x in zip(floors, placed[1]))
        per_floor = [graph_ms(f, x, 200) for f, x in zip(floors, placed[1])]
        log(f"[strip] {kernel} radius 0.5: the strips' floors (whole form, "
            f"dma_floor_kernel: band form {[f.band_form for f in floors]}) "
            f"{per_floor} ms (vs_sol "
            f"{[f / k for f, k in zip(per_floor, per)]}), summed "
            f"{sum(per_floor)} ms; launches {counts}; unequal {unequal} "
            f"words against their plain versions ({card})")
        if unequal or counts != [N_PAIRS] * STRIPS:
            fail(f"{kernel}: the strips' floors differ from their plain "
                 f"versions or did not launch once per call ({counts})")
    # the band form's path (B7, dma_floor_band_kernel), for the kernels
    # line's dma_floor_band: the floors of the full-size strips of 24-row
    # bands split STRIPS ways whose first row cuts a 32-row tile (FSR and
    # CAS at radius 0.5), each on its strip at the ring pitch, N_PAIRS calls
    # each with the counts from 0; each equal to its plain version, vs_sol
    # against its strip kernel at most VS_SOL_MAX
    band_floors = []
    for kernel in ("fsr_fused", "cas_upscale"):
        build, layout = layouts[kernel]
        img = sets["in"]["zone+noise"]
        _, gy = layout(OW, OH, 24)
        for r in split_bands(gy, STRIPS):
            fn = build(0.5, band_rows=24, band_range=r)
            f = build_dma_floor(fn.dma_geometry)
            if f.band_form:
                x = img[:, fn.in_row_base:fn.in_row_base + fn.in_rows]
                band_floors.append((f"{kernel} {r}", fn, f,
                                    ring_of(f, x.contiguous())))
    for _, _, f, x in band_floors:
        f(x)
    torch.cuda.synchronize()
    for _, _, f, _ in band_floors:
        f.launches = 0
    for _ in range(N_PAIRS):
        for _, _, f, x in band_floors:
            f(x)
    torch.cuda.synchronize()
    counts = [f.launches for _, _, f, _ in band_floors]
    err = max(int((f(x).to(torch.int64) - f.reference(x).to(torch.int64))
                  .abs().max()) for _, _, f, x in band_floors)
    per_floor = [graph_ms(f, x, 200) for _, _, f, x in band_floors]
    vs = [t / graph_ms(fn, x, 200)
          for t, (_, fn, _, x) in zip(per_floor, band_floors)]
    log(f"[strip] band-form floors (dma_floor_band_kernel) of the 24-row "
        "strips (kernel, bands, row0) "
        f"{[(n, fn.dma_geometry['band'][0]) for n, fn, _, _ in band_floors]}: "
        f"launches {counts}, max word difference {err} against their plain "
        f"versions; {per_floor} ms, summed {sum(per_floor)} ms, vs_sol "
        f"{vs} ({card})")
    if len(band_floors) < 2 or counts != [N_PAIRS] * len(band_floors) \
            or err or max(vs) > VS_SOL_MAX:
        fail(f"the band-form floors: {len(band_floors)} of them, launches "
             f"{counts}, max word difference {err}, vs_sol {vs}")
    launches["dma_floor_band"] = sum(counts)
    max_lsb["dma_floor_band"] = err
    band_ms["dma_floor_band"] = sum(per_floor)
    band_plain_ms["dma_floor_band"] = sum(
        time_ms(f.reference, x, 3) for _, _, f, x in band_floors)
    strip_bytes["dma_floor"] = sum(f.hbm_bytes for _, _, f, _ in band_floors)
    # the half strips through the builders (band_range with
    # precision="half"): STRIPS strips at the default band_rows, N_PAIRS
    # calls each on their input strips, counts from 0; their summed device
    # time and plain bf16 time for the kernels line
    for kernel in ("fsr_fused", "cas_upscale"):
        build, layout = layouts[kernel]
        img = sets["in"]["zone+noise"]
        _, gy = layout(OW, OH)
        fns = [build(0.5, band_range=r, precision="half")
               for r in split_bands(gy, STRIPS)]
        xs = [img[:, f.in_row_base:f.in_row_base + f.in_rows].contiguous()
              for f in fns]
        for f, x in zip(fns, xs):
            f(x)
        torch.cuda.synchronize()
        for f in fns:
            f.launches = 0
        outs = [[f(x) for f, x in zip(fns, xs)] for _ in range(N_PAIRS)]
        torch.cuda.synchronize()
        counts = [f.launches for f in fns]
        launches[f"{kernel}_band_half"] = sum(counts)
        if counts != [N_PAIRS] * STRIPS or not torch.equal(
                torch.cat(outs[-1], 1), build(0.5, precision="half")(img)):
            fail(f"{kernel} half strips: launches {counts}, or their output "
                 "differs from the half single launch")
        name = f"{kernel}_band_half"
        per = [graph_ms(f, x, 200) for f, x in zip(fns, xs)]
        band_ms[name] = sum(per)
        band_plain_ms[name] = sum(time_ms(f.reference, x, 3)
                                  for f, x in zip(fns, xs))
        strip_bytes[f"{kernel}_half"] = sum(x.numel() for x in xs) * 4
        log(f"[strip] {kernel} half radius 0.5: {STRIPS} strips, "
            f"{N_PAIRS} calls each, launches {counts}; strips {per} ms, "
            f"summed {band_ms[name]} ms per stereo pair (device; {card}); "
            f"plain bf16 torch {band_plain_ms[name]} ms")
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

    # ---- 4b. half precision ----------------------------------------------------
    # the half instantiations of B1-B6 (precision="half", the JAX package's
    # bf16 cores op by op, NIS under its kernels' half policy): their
    # registers, spills and CTAs per SM, each against its plain bf16
    # version at full size (0 unequal texels, or values at 10 bits), the
    # plans through the public API with the launch counts from 0, toggle_nis
    # on a half pipeline, tools.half_bench, and the half kernels' times for
    # the kernels line
    from openvr_fsr_tpu_torch.tools import half_bench
    t_half = time.perf_counter()
    half_builds = {   # kernel -> (build, the half inside kernel's name)
        "fsr_fused": (fsr, "fsr_half_inside_kernel"),
        "rcas_sharpen": (rcas, "rcas_sharpen_half_inside_kernel"),
        "nis_scaler": (scaler, "nis_half_inside_kernel"),
        "nis_sharpen": (sharpen, "nis_sharpen_half_inside_kernel"),
        "cas_upscale": (cas_up, "cas_half_inside_kernel"),
        "cas_sharpen": (cas_sh, "cas_sharpen_half_inside_kernel")}
    for kernel, (build, part) in half_builds.items():
        usage = sass.ptxas_usage(_build.library_path(kernel)
                                 .with_suffix(".log").read_text())
        full_part = f"{prefixes[kernel]}_inside_kernel"
        for bits in (8, 10):
            per_sm = occupancy(kernel, bits, "half")
            u = [v for fn, v in usage.items()
                 if part in fn and sass.of_codec(fn, bits)]
            uf = [v for fn, v in usage.items()
                  if full_part in fn and sass.of_codec(fn, bits)]
            if len(u) != 1 or len(uf) != 1 or per_sm["inside"] < 1:
                fail(f"{kernel} {bits}-bit half inside kernel: ptxas {u}, "
                     f"{per_sm['inside']} CTAs per SM")
            u, uf = u[0], uf[0]
            log(f"[half] {kernel} {bits}-bit half inside kernel: "
                f"{u['registers']} registers, {u['spill_stores']} B spill "
                f"stores, {u['spill_loads']} B spill loads, "
                f"{per_sm['inside']} CTAs per SM (full: {uf['registers']} "
                f"registers, {uf['spill_stores']} B spill stores, "
                f"{occupancy(kernel, bits)['inside']} CTAs per SM)")
            # no spill beyond the full instantiation's (NVSharpen's 10-bit
            # one spills 4 B)
            if u["spill_stores"] > uf["spill_stores"] \
                    or u["spill_loads"] > uf["spill_loads"]:
                fail(f"{kernel} {bits}-bit half inside kernel spills more "
                     "than the full one")
            # the half strips' band instantiation beside the whole one's (a
            # spill is logged, not refused)
            band_part = part.replace("_half_", "_band_half_")
            ub = [v for fn, v in usage.items()
                  if band_part in fn and sass.of_codec(fn, bits)]
            if kernel in layouts:
                if len(ub) != 1:
                    fail(f"{kernel} {bits}-bit {band_part}: ptxas {ub}")
                ub = ub[0]
                log(f"[half] {kernel} {bits}-bit half band inside kernel: "
                    f"{ub['registers']} registers, {ub['spill_stores']} B "
                    f"spill stores, {ub['spill_loads']} B spill loads, "
                    f"{band_occupancy(kernel, bits, 'half')} CTAs per SM "
                    f"(whole half: {u['registers']} registers, "
                    f"{u['spill_stores']} B spill stores, "
                    f"{per_sm['inside']} CTAs per SM)"
                    + (" WARNING: it spills" if ub["spill_stores"]
                       or ub["spill_loads"] else ""))
        max_lsb[f"{kernel}_half"] = 0

    def parity_half(kernel, label, fn, img):
        got, want = fn(img), fn.reference(img)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype \
                or got.device != img.device or fn.precision != "half":
            fail(f"{kernel} half output {tuple(got.shape)} {got.dtype}")
        ne = int((got != want).sum())
        log(f"[half] parity {kernel} {label}: unequal {ne} of "
            f"{got.numel()} {'values' if fn.color_bits == 10 else 'texels'}")
        if ne:
            fail(f"{kernel} half disagrees with its plain bf16 version")
        return got

    half_cases = [("fsr_fused", dict(radius=r, debug=d))
                  for r, d in ((0.5, False), (2.0, False), (0.0, True))]
    half_cases += [("fsr_fused", dict(radius=0.5, h=OH, w=OW, rs=1.3))]
    half_cases += [(k, dict(radius=r)) for k in ("rcas_sharpen",
                                                 "cas_upscale", "cas_sharpen")
                   for r in (0.5, 2.0)]
    half_cases += [(k, kw) for k in ("nis_scaler", "nis_sharpen")
                   for kw in (dict(radius=0.5), dict(radius=2.0),
                              dict(radius=0.0, debug=True),
                              dict(radius=0.3, eyes=OFF_CENTRE),
                              dict(radius=2.0, hdr=1), dict(radius=2.0,
                                                            hdr=2))]
    for kernel, kw in half_cases:
        fn = half_builds[kernel][0](precision="half", **kw)
        size = "in" if kernel in UPSCALERS and "rs" not in kw else "full"
        for name, img in sets[size].items():
            got = parity_half(kernel, f"{kw} {name}", fn, img)
            if name == "zone+noise":
                ne, n, mx = lsb_diff(got, half_builds[kernel][0](**kw)(img))
                log(f"[half] {kernel} {kw} {name}: half against full "
                    f"{ne} of {n} texels unequal, max {mx} LSB")
    for kernel, (build, _) in half_builds.items():
        size = "in" if kernel in UPSCALERS else "full"
        fn = build(0.5, bits=10, precision="half")
        for name, img in sets10[size].items():
            parity_half(kernel, f"10-bit radius 0.5 {name}", fn, img)

    # through the public API, on the card by default: each plan's Pipeline
    # (precision="half") over N_PAIRS packed stereo pairs, counts from 0
    half_plans = {   # label -> (kernel, config, input pairs)
        "fsr_fused": ("fsr_fused", dict(render_scale=0.75), pairs_in),
        "fsr_supersample": ("fsr_fused", dict(render_scale=1.3), pairs_full),
        "rcas_only": ("rcas_sharpen", dict(render_scale=1.0), pairs_full),
        "nvscaler": ("nis_scaler", dict(render_scale=0.75, use_nis=True),
                     pairs_in),
        "nvsharpen": ("nis_sharpen", dict(render_scale=1.0, use_nis=True),
                      pairs_full),
        "cas_upscale": ("cas_upscale", dict(render_scale=0.75, use_cas=True),
                        pairs_in),
        "cas_sharpen": ("cas_sharpen", dict(render_scale=1.0, use_cas=True),
                        pairs_full)}
    half_firsts = {}
    for label, (kernel, kw, pairs_u8) in half_plans.items():
        cfg = Config(enabled=True, sharpness=SHARPNESS, radius=0.5, **kw)
        pipe = Pipeline(cfg, precision="half")
        packed_pairs = pairs_u8.view(torch.int32)[..., 0]
        first = pipe.process(packed_pairs[0].contiguous())    # the build
        (fn,) = pipe.kernels
        fn.launches = 0
        outs = [pipe.process(packed_pairs[i].contiguous())
                for i in range(N_PAIRS)]
        torch.cuda.synchronize()
        launches[f"{kernel}_half"] = launches.get(f"{kernel}_half", 0) \
            + fn.launches
        log(f"[half] {label} plan: {N_PAIRS} calls, kernel launches "
            f"{fn.launches}")
        if fn.launches != N_PAIRS or fn.precision != "half" \
                or not outs[0].is_cuda:
            fail(f"the half {label} plan did not launch its half kernel "
                 "once per call")
        if not torch.equal(outs[0], first) or not torch.equal(
                first, fn(packed_pairs[0].contiguous())):
            fail(f"the half {label} plan differs from its kernel")
        half_firsts[label] = first
        up = upscale(pairs_u8[0], render_scale=cfg.render_scale,
                     sharpness=SHARPNESS, radius=0.5, use_cas=cfg.use_cas,
                     use_nis=cfg.use_nis, precision="half")
        if not up.is_cuda or not torch.equal(up.view(torch.int32)[..., 0],
                                             first):
            fail(f"upscale(precision='half') differs from the {label} plan")
    log("[half] upscale(precision='half') with no device, each plan: on the "
        "card, equal to Pipeline(precision='half')")
    for label, (kernel, kw, pairs10) in (
            ("fsr_fused", ("fsr_fused", dict(render_scale=0.75),
                           pairs10_in)),
            ("rcas_only", ("rcas_sharpen", dict(render_scale=1.0),
                           pairs10_full)),
            ("nvscaler", ("nis_scaler", dict(render_scale=0.75, use_nis=True),
                          pairs10_in)),
            ("nvsharpen", ("nis_sharpen", dict(render_scale=1.0,
                                               use_nis=True), pairs10_full)),
            ("cas_upscale", ("cas_upscale", dict(render_scale=0.75,
                                                 use_cas=True), pairs10_in)),
            ("cas_sharpen", ("cas_sharpen", dict(render_scale=1.0,
                                                 use_cas=True),
                             pairs10_full))):
        pipe = Pipeline(Config(enabled=True, sharpness=SHARPNESS, radius=0.5,
                               **kw), color_bits=10, precision="half")
        first = pipe.process(pairs10[0])
        (fn,) = pipe.kernels
        fn.launches = 0
        for i in range(N_PAIRS):
            pipe.process(pairs10[i])
        torch.cuda.synchronize()
        launches[f"{kernel}_half"] += fn.launches
        log(f"[half] {label} 10-bit plan: {N_PAIRS} calls, kernel launches "
            f"{fn.launches}")
        if fn.launches != N_PAIRS or fn.color_bits != 10 \
                or not torch.equal(first, fn(pairs10[0])):
            fail(f"the half {label} 10-bit plan did not run its half kernel")
    # the NIS hotkey on a live half pipeline: NVScaler at half, its half
    # kernel launched once per call (counts from 0), equal to the half
    # nvscaler plan
    pipe = Pipeline(Config(enabled=True, sharpness=SHARPNESS, radius=0.5,
                           render_scale=0.75), precision="half")
    packed_in = pairs_in.view(torch.int32)[..., 0]
    pipe.process(packed_in[0].contiguous())
    pipe.toggle_nis()
    first = pipe.process(packed_in[0].contiguous())
    (fn,) = pipe.kernels
    fn.launches = 0
    for i in range(N_PAIRS):
        pipe.process(packed_in[i].contiguous())
    torch.cuda.synchronize()
    launches["nis_scaler_half"] += fn.launches
    log(f"[half] toggle_nis() on a half FSR pipeline: {N_PAIRS} NVScaler "
        f"calls, kernel launches {fn.launches}, precision {fn.precision}")
    if fn.launches != N_PAIRS or fn.precision != "half" \
            or not torch.equal(first, half_firsts["nvscaler"]):
        fail("toggle_nis() on a half pipeline did not run NVScaler at half")

    # times: half_bench's lines, then each half kernel at radius 0.5 in
    # turns with its plain version for the kernels line
    half_records = half_bench.main([])
    for name, (rec, runs) in half_records.items():
        for prec, run in runs.items():
            if not (run.vs_sol <= VS_SOL_MAX
                    and run.ms >= VALUE_MIN * run.device_ms
                    and run.kernel.launches and run.floor.launches):
                fail(f"half_bench {name} {prec}: vs_sol {run.vs_sol}, value "
                     f"{run.ms}, device_ms {run.device_ms}")
    timed_half = {kernel: (build(0.5, precision="half"),
                           sets["in" if kernel in UPSCALERS else "full"]
                           ["zone+noise"])
                  for kernel, (build, _) in half_builds.items()}
    for kernel, (fn, img) in timed_half.items():
        rounds = {"kernel": [], "plain": []}
        for label, f, n in (("plain", fn.reference, 5), ("kernel", fn, 200),
                            ("kernel", fn, 200), ("plain", fn.reference, 5)):
            rounds[label].append((graph_ms if label == "kernel" else time_ms)(
                f, img, n))
        ms[f"{kernel}_half"] = float(np.mean(rounds["kernel"]))
        plain_ms[f"{kernel}_half"] = float(np.mean(rounds["plain"]))
        log(f"[half] time {kernel} radius 0.5: half kernel "
            f"{rounds['kernel']} ms per stereo pair (full {ms[kernel]}); "
            f"plain bf16 torch {rounds['plain']} ms ({card})")
    for kernel, (build, _) in half_builds.items():   # all inside the circle
        img = timed_half[kernel][1]
        fns = {"full": build(2.0), "half": build(2.0, precision="half")}
        t = {p: [] for p in fns}
        for p in ("full", "half", "half", "full"):
            t[p].append(graph_ms(fns[p], img, 200))
        log(f"[half] time {kernel} radius 2.0: half kernel {t['half']} ms, "
            f"full kernel {t['full']} ms per stereo pair ({card})")
    log(f"[half] phase took {time.perf_counter() - t_half:.1f} s")

    # ---- 5. the measurement path --------------------------------------------
    from openvr_fsr_tpu_torch import bench
    from openvr_fsr_tpu_torch.tools import bench_paths
    from openvr_fsr_tpu_torch.utils.timing import bench_fn, hbm_calibration

    counts = sass_counts(_build.library_path("dma_floor"), _build._nvcc())
    if counts is None:
        log("[floor] cuobjdump not found: SASS not checked")
    for fn_name, (tma, lds, stg) in (counts or {}).items():
        log(f"[floor] SASS {fn_name}: {tma} UTMALDG, {lds} LDS, {stg} STG")
        # the one-box form gathers straight from the frame: stores only
        one_box = "dma_floor_one_kernel" in fn_name
        if not (stg if one_box else tma and lds and stg):
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
    # (tools/api_cost.py: the two quantities in turns from the same warm
    # state, an enqueue round with no sync inside it, a sync, then a
    # back-to-back round)
    from openvr_fsr_tpu_torch.tools import api_cost
    for name, (record, _) in paths.items():
        _, h, w = bench_paths.path_config(name)
        x = sets["in" if (h, w) == (H, W) else "full"]["zone+noise"]
        row = api_cost.measure(name, API_ROUNDS, API_CALLS, x=x)
        pairs, enqueue, b2b = (row["rounds"], row["enqueue_ms"],
                               row["back_to_back_ms"])
        log(f"[api] {name}: Pipeline.process ms per call, rounds (enqueue, "
            f"back to back) {pairs}; min {enqueue} (host alone) / {b2b} = "
            f"{enqueue / b2b}; the bench line's device_ms "
            f"{record['device_ms']}, value {record['value']} ({card})")
        if not 0 < enqueue <= b2b * API_MAX:
            fail(f"{name}: Pipeline.process enqueue {enqueue} ms, back to "
                 f"back {b2b} ms, above {API_MAX} x")
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

    # ---- 6b. the native ring, the stream, the 8K batch, the trace, the demo
    b1, b7 = phase_6b(card, sets["in"]["zone+noise"])
    launches["fsr_fused"] += b1
    launches["dma_floor"] += b7

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
        # only MUFU) and the whole outside kernel (a run of 8 outputs down
        # one column per thread)
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
    # the half instantiations: the same bytes, the half cores' ops in FP32
    # issue slots (a bf16 op one half: vpu_audit.issue_slots)
    for kernel, (fn, img) in timed_half.items():
        g = fn.dma_geometry
        inside, fallback = vpu_audit.inside_pixels(g)
        per_px = vpu_audit.path_ops(
            kernel, in_per_out=g["in_h"] * g["in_w"] / (g["out_h"] * g["out_w"]),
            sharpness=CAS_SHARPNESS if kernel.startswith("cas") else SHARPNESS,
            precision="half")
        bounds[f"{kernel}_half"] = bound(
            (img.numel() + 2 * g["out_h"] * g["out_w"]) * 4,
            inside * per_px[0] + fallback * per_px[1], issue)
    # the half strips: the half strips' bytes, the half cores' ops
    for kernel in ("fsr_fused", "cas_upscale"):
        g = timed_half[kernel][0].dma_geometry
        inside, fallback = vpu_audit.inside_pixels(g)
        per_px = vpu_audit.path_ops(
            kernel, in_per_out=g["in_h"] * g["in_w"] / (g["out_h"] * g["out_w"]),
            sharpness=CAS_SHARPNESS if kernel.startswith("cas") else SHARPNESS,
            precision="half")
        bounds[f"{kernel}_band_half"] = bound(
            strip_bytes[f"{kernel}_half"] + 2 * g["out_h"] * g["out_w"] * 4,
            inside * per_px[0] + fallback * per_px[1], issue)
    ms.update({f"{k}_band": v for k, v in strip_ms.items()})
    plain_ms.update({f"{k}_band": v for k, v in strip_plain_ms.items()})
    ms.update(band_ms)
    plain_ms.update(band_plain_ms)
    bounds["dma_floor"] = bound(floor.hbm_bytes, 0, issue)
    bounds["dma_floor_band"] = bound(strip_bytes["dma_floor"], 0, issue)
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
    # the half instantiations: their precision="half" branches; the half
    # strips both branches, and dma_floor_band B7's band form
    sources.update({f"{k}_half": sources[k] for k in half_builds})
    sources.update({f"{k}_band_half": sources[k]
                    for k in ("fsr_fused", "cas_upscale")})
    sources["dma_floor_band"] = sources["dma_floor"]

    def source_file(kernel):
        for suffix in ("_10bit", "_half", "_band"):
            kernel = kernel.removesuffix(suffix)
        return f"openvr_fsr_tpu_torch/csrc/{kernel}.cu"
    log(card)
    log(json.dumps({"kernels": [{
        "name": kernel,
        "route": "cuda",
        "source": source_file(kernel),
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
