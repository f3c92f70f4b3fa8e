"""The rate probes (kernels/sol.py, B8) and the compute-floor audit
(openvr_fsr_tpu_torch/tools/vpu_audit.py), on the CPU.

Each probe's plain version is held against the JAX builder in Pallas
interpret mode at (k, steps) = (2, 4) and (8, 16):
  - B8a (FP32 rate) within 1e-6 x max|out|: XLA:CPU contracts or reorders
    some mul+add pairs (a numpy f32 restatement reads 376 of 1,024 outputs
    unequal, at most 1.8e-7 of max, against it);
  - B8b (shared-memory rate) bit for bit at (8, 16) with one share (the
    JAX probe's summation order); at (2, 4) six of the 8 accumulators are
    never updated and XLA:CPU adds those constants in another order (103
    of 1,024 outputs differ, a numpy restatement of the JAX order agrees
    with the port), so that case is held within 1e-6 x max|out| and the
    port's order is held bit for bit against a numpy restatement;
  - B8c (tensor-core rate) within sol.MXU_TOLERANCE (1e-2) x max|out|:
    both multiply the same bf16 operands exactly and accumulate in f32 in
    different orders (measured: at most 2.3e-6 of max here, 3.4e-6 on an
    H100 against the CUDA kernel).
The CUDA kernels run only on the card: `python3 chip_smoke.py` holds them
against these plain versions there.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu.kernels import sol as jsol  # noqa: E402

import openvr_fsr_tpu_torch as T  # noqa: E402
from openvr_fsr_tpu_torch.kernels import sol  # noqa: E402
from openvr_fsr_tpu_torch.tools import sass  # noqa: E402
from openvr_fsr_tpu_torch.tools import vpu_audit as A  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SIZES = [(2, 4), (8, 16)]


def _jax_audit():
    """The repository's tools/vpu_audit.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_vpu_audit", REPO / "tools" / "vpu_audit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).random(shape, np.float32)
            * np.float32(scale))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("k,steps", SIZES)
def test_vpu_rate_plain_matches_jax(k, steps):
    x = _rand(0, 130, 128)
    want = np.asarray(jsol.build_vpu_rate(k, steps=steps, interpret=True)(x))
    fn = sol.build_vpu_rate(k, steps=steps)
    got = fn(torch.from_numpy(x)).numpy()
    assert got.shape == (8, 128) and fn.launches == 0
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("k,steps", SIZES)
def test_vmem_rate_plain_matches_jax(k, steps):
    x = _rand(3 + k, k, 130, 128)
    want = np.asarray(jsol.build_vmem_rate(k, steps=steps, interpret=True)(x))
    got = sol.build_vmem_rate(k, steps=steps, shares=1)(
        torch.from_numpy(x)).numpy()
    if k % 8 == 0:        # every accumulator updated: the same order
        assert np.array_equal(got, want)
    else:
        assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("k,steps", SIZES)
def test_mxu_rate_plain_matches_jax(k, steps):
    x, w = _rand(1, 128, 128), _rand(2, 128, 128, scale=0.1)
    want = np.asarray(jsol.build_mxu_rate(k, steps=steps, interpret=True)(x,
                                                                          w))
    got = sol.build_mxu_rate(k, steps=steps)(torch.from_numpy(x),
                                             torch.from_numpy(w)).numpy()
    assert np.abs(got - want).max() <= sol.MXU_TOLERANCE * np.abs(want).max()
    assert np.abs(want).max() > 0


def _vmem_numpy(x, steps, shares):
    """csrc/vmem_rate.cu in numpy: per share, each step's Horner fold, the
    accumulators summed, the rows folded, the folds added in step order;
    then the shares in order."""
    k, th_e, _ = x.shape
    parts = []
    for share in range(shares):
        red = None
        for i in range(share * steps // shares, (share + 1) * steps // shares):
            s = np.float32(1) - np.float32(i) * np.float32(2 ** -20)
            accs = [np.full(x.shape[1:], np.float32(u + 1)) for u in range(8)]
            for j in range(k):
                accs[j % 8] = accs[j % 8] * s + x[j]
            acc = accs[0]
            for a in accs[1:]:
                acc = acc + a
            f = acc[0:8]
            for r in range(8, th_e - 7, 8):
                f = f + acc[r:r + 8]
            if th_e % 8:
                f = f + acc[th_e - 8:th_e]
            red = f if red is None else red + f
        parts.append(red)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@pytest.mark.parametrize("k,steps,shares", [
    (2, 4, 1), (8, 16, 3), (13, 9, 2), (16, 24, 12), (20, 10, 7),
    (112, 6, 4), (48, 13, 12)])
def test_vmem_rate_plain_is_the_kernel_order(k, steps, shares):
    """The kernel's order at any shares (each of a CTA's step groups runs
    one contiguous range of steps), k a multiple of 8 (the unrolled loop
    only) or not (13, 20: the predicated tail too)."""
    x = _rand(k, k, 130, 128)
    fn = sol.build_vmem_rate(k, steps=steps, shares=shares)
    assert fn.shares == shares
    got = fn(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, _vmem_numpy(x, steps, shares))


def _vmem_constant(name):
    import re
    from openvr_fsr_tpu_torch.kernels import _build
    text = (_build.CSRC / "vmem_rate.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("k,steps,want", [(112, 4096, 12), (16, 4096, 12),
                                          (48, 1024, 12), (8, 16, 12),
                                          (16, 4, 4)])
def test_vmem_rate_shares_fill_the_card(k, steps, want):
    """The probe's CTA holds kMaxThreads / th_e step groups over one staged
    column (4 full-warp groups of 130 rows, 17 warps); at the audit's k,
    shared memory and threads let 3 CTAs of a column share an SM, so the
    132 SMs run 3 CTAs of each of the 128 columns at once: 12 shares."""
    assert sol.VMEM_THREADS == _vmem_constant("kMaxThreads") == 544
    assert sol.vmem_rate_groups(130) == 4
    assert _vmem_constant("kMinCtas") == 3
    assert sol.vmem_rate_shares(k, steps=steps) == want
    smem = sol.build_vmem_rate(k, steps=min(steps, 16)).smem_bytes
    assert smem == (-(-k // 4) * 4 * 130 + 2 * 4 * 130) * 4
    if k == 112:
        assert 3 * (smem + 1024) <= sol.SM_SMEM < 4 * (smem + 1024)


def test_probe_bounds():
    """Each probe's bound is the largest of its terms: the shared-memory
    probe's is the plane bytes its step loop reads over SMs x 128 B x the
    max SM clock (0.913 ms at the audit's k 112 and 4,096 steps on 132 SMs
    at 1980 MHz), far above its Horner ops at the FP32 issue bound; the
    FP32 probe is bound by its FP32 instructions at SMs x 128 lanes x the
    clock (26 per element and cycle in its SASS on the H100: 1.907 ms), or
    its meter ops there without the SASS; the tensor-core probe by its
    MACs over SMs x 2,048 dense bf16 MACs per clock x the clock (0.530 ms;
    the data sheet's 989.4 TFLOP/s is the same count at 1830 MHz)."""
    issue = 132 * 128 * 1980e6
    assert A.fp32_instructions_per_s(132, 1980e6) == issue \
        == A.smem_bytes_per_s(132, 1980e6)
    assert A.tensor_macs_per_s(132, 1980e6) == 132 * 2048 * 1980e6
    assert 2 * A.tensor_macs_per_s(132, 1830e6) == pytest.approx(989.4e12,
                                                                 rel=1e-4)
    builds = (sol.build_vpu_rate(144, steps=1024),
              sol.build_vmem_rate(112, steps=4096),
              sol.build_mxu_rate(64, steps=264))
    b = A.probe_bounds(*builds, 132, 1980e6, fp32_per_cycle=26)
    ms, by = b["vmem_rate"]
    assert by == "smem"
    assert ms == pytest.approx(112 * 130 * 128 * 4 * 4096
                               / (132 * 128 * 1980e6) * 1e3)
    assert round(ms, 3) == 0.913
    assert b["vpu_rate"][1] == b["mxu_rate"][1] == "operations"
    assert b["vpu_rate"][0] == pytest.approx(
        144 * 26 * 130 * 128 * 1024 / issue * 1e3)
    assert round(b["vpu_rate"][0], 3) == 1.907
    assert A.probe_bounds(*builds, 132, 1980e6)["vpu_rate"][0] == \
        pytest.approx(144 * 30 * 130 * 128 * 1024 / issue * 1e3)
    assert b["mxu_rate"][0] == pytest.approx(
        64 * 264 * 8 * 128 ** 3 / (132 * 2048 * 1980e6) * 1e3)
    assert round(b["mxu_rate"][0], 3) == 0.530
    # without its smem term the shared-memory probe would read "operations"
    assert A.roofline_bound(112 * 130 * 128 * 4, 2 * 112 * 130 * 128 * 4096,
                            issue)[1] == "operations"
    assert A.roofline_bound(1e9, 0, issue) == pytest.approx(
        (1e9 / A.HBM_BYTES_PER_S * 1e3, "bytes"))


def test_probes_publish_the_jax_attributes():
    v = sol.build_vpu_rate(4, steps=8)
    jv = jsol.build_vpu_rate(4, steps=8, interpret=True)
    assert (v.elems, v.steps, v.k) == (jv.elems, jv.steps, jv.k)
    m = sol.build_vmem_rate(4, steps=8)
    jm = jsol.build_vmem_rate(4, steps=8, interpret=True)
    assert (m.bytes_per_step, m.steps, m.k) == (jm.bytes_per_step, jm.steps,
                                                jm.k)
    x = sol.build_mxu_rate(4, steps=8)
    jx = jsol.build_mxu_rate(4, steps=8, interpret=True)
    assert (x.steps, x.k, x.tile) == (jx.steps, jx.k, jx.tile)
    assert x.macs == 8 * 4 * 8 * 128 ** 3
    # the audit's settings fit the card: one column of k_hi planes in
    # shared memory, and each probe's lo and hi builds share their shares
    k_lo, k_hi, steps = A.PROBES["vmem"][0]
    assert sol.build_vmem_rate(k_hi, steps=steps).smem_bytes <= sol.SMEM_MAX
    assert sol.vmem_rate_shares(k_hi, steps=steps) >= 1
    for f in (v, m, x):
        assert f.launches == 0 and callable(f.reference)


def test_probes_refuse_what_they_cannot_run():
    with pytest.raises(ValueError, match="float32"):
        sol.build_vpu_rate(2, steps=2)(torch.zeros(130, 128,
                                                   dtype=torch.float64))
    with pytest.raises(ValueError, match="shapes"):
        sol.build_vpu_rate(2, steps=2)(torch.zeros(128, 128))
    with pytest.raises(ValueError, match="shared memory"):
        sol.build_vmem_rate(500, steps=2)
    with pytest.raises(ValueError, match="tile 128"):
        sol.build_mxu_rate(2, tile=64)
    with pytest.raises(NotImplementedError, match="float32"):
        sol.build_vmem_rate(2, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no path"):
        sol.build_vpu_rate(2, steps=2)(torch.zeros(130, 128, device="meta"))


def test_vpu_cycle_ops_equal_the_jax_meter():
    import jax.numpy as jnp
    ja = _jax_audit()
    args = [jnp.zeros((130, 128), jnp.float32)] * 9
    jops = ja.count_ops(lambda a: jsol.vpu_cycle(a[:8], a[8]), args)
    assert jops / (130 * 128) == 30.0
    assert A.vpu_cycle_ops() == 30.0 == A.vpu_cycle_ops(130, 128)


def test_mxu_macs_equal_the_jax_meter():
    ja = _jax_audit()
    x, w = _rand(1, 128, 128), _rand(2, 128, 128, scale=0.1)
    p = jsol.build_mxu_rate(2, steps=4, interpret=True)
    jmacs = ja.count_macs(lambda xw: p(*xw), (x, w))
    fn = sol.build_mxu_rate(2, steps=4)
    macs = A.count_macs(fn, torch.from_numpy(x), torch.from_numpy(w))
    assert macs == jmacs == fn.macs == 134_217_728


@pytest.mark.parametrize("kernel", list(A.SMEM_WORDS))
def test_path_ops_per_pixel(kernel):
    """Per output pixel, the same count at two plane sizes, and the inside
    path costs more than the fallback."""
    a = A.path_ops(kernel, 8, 16)
    b = A.path_ops(kernel, 24, 40)
    assert a == b
    inside, fallback = a
    assert inside > fallback > 0


def test_smem_words_recounted_from_the_sources():
    """The redesigned kernels' shared words per inside pixel: B1 reads 4
    quadrant centres' EASU terms (16 words) beside its 12 taps; B5 reads its
    12 taps from three f32 planes; B3 the two diagonal phases' table rows
    per output, the fx rows per run of 6, and on each reload / one-row
    step of the source row 52 / 14 words (lumas and edge weights). Its
    average over the main path's runs is the pinned 44, within 50."""
    from openvr_fsr_tpu_torch.core import constants as C
    from openvr_fsr_tpu_torch.kernels._maps import nvscaler_maps
    assert A.SMEM_WORDS["nis_scaler"] == (44, 0)
    assert A.SMEM_WORDS["cas_upscale"] == (36, 0)
    # B1: 1 class + 4 map words + 12 taps x 4 + 4 centres' terms x 4 + 15
    assert A.SMEM_WORDS["fsr_fused"] == (1 + 4 + 48 + 16 + 15, 0) == (84, 0)
    cfg = C.nvscaler_update_config(A.NIS_SHARPNESS, 1683, 1869, 1683, 1869,
                                   2244, 2492, 2244, 2492)
    m = nvscaler_maps(2, 1869, 1683, 2244, 2492, cfg,
                      np.zeros((2, 5), np.int64))
    pyi, words = m.row_i[0], 0
    for oy0 in range(0, len(pyi), 6):     # a run: 6 rows of one tile
        words += 12
        cur = None
        for p in pyi[oy0:oy0 + 6]:
            step = None if cur is None else p - cur
            words += 24 + (0 if step == 0 else 14 if step == 1 else 52)
            cur = p
    assert round(words / len(pyi)) == A.SMEM_WORDS["nis_scaler"][0] <= 50


def test_nis_stage_ops_add_up():
    stages = A.nis_stage_ops()
    per_out = sum(v for k, v in stages.items() if k != "luma_and_edge_map_"
                  "per_input_pixel")
    inside, _ = A.path_ops("nis_scaler", sharpness=A.NIS_SHARPNESS,
                           in_per_out=0.5)
    assert inside == per_out + 0.5 * stages["luma_and_edge_map_per_input_"
                                            "pixel"]


def test_paired_slope_equals_the_jax_one_on_finite_pairs():
    ja = _jax_audit()
    times = iter([1.0, 3.0, 1.1, 3.2, 0.9, 2.8, 1.0, 3.1])
    jtimes = iter([1.0, 3.0, 1.1, 3.2, 0.9, 2.8, 1.0, 3.1])
    rate, slopes = A.paired_slope(lambda: next(times), lambda: next(times),
                                  2e9)
    jrate, jslopes = ja.paired_slope(lambda: next(jtimes),
                                     lambda: next(jtimes), 2e9)
    assert rate == jrate and slopes == jslopes


@pytest.mark.parametrize("case", ["nan", "zero_dt", "spread"])
def test_paired_slope_refuses(case):
    if case == "nan":      # NIS_AUDIT_r05.json's published pair slopes
        with pytest.raises(ValueError, match="finite"):
            A.rate_from_slopes([float("nan"), 86.9, 211.9, 933.5])
    elif case == "zero_dt":
        with pytest.raises(ValueError, match="not slower"):
            A.paired_slope(lambda: 1.0, lambda: 1.0, 1e9)
    else:
        with pytest.raises(ValueError, match="spread"):
            A.rate_from_slopes([86.9, 211.9])
        assert A.rate_from_slopes([100.0, 140.0, 120.0]) == 120.0


def test_floor_is_the_max_of_the_resources_not_their_sum():
    rates = {"fp32": 1e12, "smem": 1e12}
    row = A.kernel_floors(1000, 3000, (100.0, 10.0), (10, 1), 4e6, rates,
                          ms=1.0)
    # compute 1.3e5 ops -> 1.3e-4 ms; smem 1.3e4 words -> 5.2e-5 ms;
    # memory 4e6 B at 3.35 TB/s -> 1.19e-3 ms
    assert row["compute_floor_ms"] == pytest.approx(1.3e-4)
    assert row["smem_floor_ms"] == pytest.approx(5.2e-5)
    assert row["tensor_floor_ms"] == 0.0
    assert row["bound_by"] == "memory"
    assert row["bound_ms"] == pytest.approx(4e6 / A.HBM_BYTES_PER_S * 1e3)
    total = sum(row[f"{r}_floor_ms"] for r in ("compute", "smem", "memory"))
    assert row["bound_ms"] < total
    assert row["share"] == row["bound_ms"] / 1.0


def test_inside_pixels_follow_the_tile_test():
    pipe = T.Pipeline(T.Config(enabled=True, render_scale=0.75, radius=0.5),
                      device="cpu")
    g = pipe._build(2, 72, 96, (0, 1), True).dma_geometry
    inside, fallback = A.inside_pixels(g)
    assert inside + fallback == 2 * g["out_h"] * g["out_w"]
    assert 0 < inside < fallback


def test_audit_without_a_gpu_exits_1():
    code = ("import torch, runpy, sys; torch.cuda.is_available = lambda: "
            "False; sys.argv = ['vpu_audit']; runpy.run_module("
            "'openvr_fsr_tpu_torch.tools.vpu_audit', run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["value"] is None and "no CUDA GPU" in line["error"]


SASS = """
        Function : _Z15vpu_rate_kernelPKfPfiii
        /*0100*/                   FMUL R1, R2, 0.5 ;
        /*0110*/                   FADD R1, R1, R3 ;
        /*0120*/                   FMNMX R1, R1, R3, PT ;
        /*0130*/                   LDS.128 R4, [R0] ;
        /*0140*/              @!P0 BRA 0x100 ;
        /*0150*/                   FADD R5, R1, R1 ;
        /*0160*/              @P1 BRA 0xf0 ;
        /*0170*/                   EXIT ;
"""


def test_sass_loops():
    counts = sass.function_counts(SASS)
    (fn, ops), = counts.items()
    assert ops["FADD"] == 2 and ops["LDS"] == 1 and ops["BRA"] == 2
    inner = sass.innermost_loop(SASS, "vpu_rate_kernel", "FMNMX")
    assert (inner["FADD"], inner["FMUL"], inner["FMNMX"]) == (1, 1, 1)
    assert sass.innermost_loop(SASS, "vpu_rate_kernel", "EXIT") is None
    assert len(sass.loops(SASS)[fn]) == 2


PROBE_SASS = {
    "vpu_rate": SASS,
    "vmem_rate": """
        Function : _Z16vmem_rate_kernelPKfPfiiii
        /*0100*/                   LDS.128 R4, [R0] ;
        /*0110*/                   FMUL R1, R2, R4 ;
        /*0120*/                   FMUL R1, R2, R5 ;
        /*0130*/                   FMUL R1, R2, R6 ;
        /*0140*/                   FMUL R1, R2, R7 ;
        /*0150*/              @!P0 BRA 0x100 ;
        /*0160*/                   EXIT ;
""",
    "mxu_rate": """
        Function : _Z15mxu_rate_kernelPKfS0_Pfi
        /*0100*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0110*/                   WARPGROUP.ARRIVE ;
        /*0120*/                   HGMMA.64x128x16.F32.BF16 R24, R88, gdesc[UR8], RZ, !UPT ;
        /*0130*/                   HGMMA.64x128x16.F32.BF16 R24, R92, gdesc[UR12], R24 ;
        /*0140*/                   HGMMA.64x128x16.F32.BF16 R24, R96, gdesc[UR16], R24, gsb0 ;
        /*0150*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*0160*/                   FMUL R24, R24, 0.001 ;
        /*0170*/                   F2FP.BF16.F32.PACK_AB R88, R25, R24 ;
        /*0180*/              @P0 BRA 0x110 ;
        /*0190*/              @P1 BRA 0x100 ;
        /*01a0*/                   EXIT ;
""",
}


def test_sass_counts_hgmma_per_round():
    """The tensor-core probe's metering loop is the innermost one holding
    HGMMA (wgmma, 8 per round at m64n128k16 over K = 128); the outer
    stream loop also holds them, and is not the one counted."""
    loops = sass.probe_loop_counts(PROBE_SASS)
    assert loops["mxu_rate"] == {"hgmma_per_round": 3}
    assert loops["vpu_rate"] == {"fp32_per_cycle": 3}
    assert loops["vmem_rate"] == {"lds_in_loop": 1, "words_per_lds": 4.0}
    counts = sass.function_counts(PROBE_SASS["mxu_rate"])
    (ops,) = counts.values()
    assert ops["HGMMA"] == 3 and ops["HMMA"] == 0
    no_mma = PROBE_SASS["mxu_rate"].replace("HGMMA", "HMMA")
    assert sass.probe_loop_counts(dict(PROBE_SASS, mxu_rate=no_mma))[
        "mxu_rate"] == {"hgmma_per_round": 0}


INSIDE_SASS = {
    # a staging loop (one FMUL), then 4 unrolled outputs' float work
    "cas_sharpen": """
        Function : _Z25cas_sharpen_inside_kernel6Params
        /*0100*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0110*/                   FMUL R3, R2, 0.5 ;
        /*0120*/                   STS [R0], R3 ;
        /*0130*/              @P0 BRA 0x100 ;
        /*0140*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0150*/                   LDS R4, [R0] ;
        /*0160*/                   FADD R5, R4, R4 ;
        /*0170*/                   FMUL R5, R5, R4 ;
        /*0180*/                   FSETP.GT.AND P1, PT, R5, R4, PT ;
        /*0190*/                   FSEL R5, R5, R4, P1 ;
        /*01a0*/                   FMNMX R5, R5, R4, PT ;
        /*01b0*/                   STG.E desc[UR4][R6.64], R5 ;
        /*01c0*/                   EXIT ;
""",
    # a staging loop (two FMUL), then the run loop: one output per trip
    "nis_scaler": """
        Function : _Z17nis_inside_kernel6Params
        /*0100*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0110*/                   FMUL R3, R2, 0.5 ;
        /*0120*/                   FMUL R3, R3, 0.5 ;
        /*0130*/                   STS [R0], R3 ;
        /*0140*/              @P0 BRA 0x100 ;
        /*0150*/                   LDS R4, [R0] ;
        /*0160*/                   FADD R5, R4, R4 ;
        /*0170*/                   FADD R5, R5, R4 ;
        /*0180*/                   FFMA R5, R5, R4, R4 ;
        /*0190*/                   FSEL R5, R5, R4, P1 ;
        /*01a0*/                   STG.E desc[UR4][R6.64], R5 ;
        /*01b0*/                   IADD3 R0, R0, 0x4, RZ ;
        /*01c0*/              @P2 BRA 0x150 ;
        /*01d0*/                   EXIT ;
""",
    # the persistent tile loop: a decode loop (one FMUL), the stage-1 loop
    # (4 FMUL, 2 FSETP, an rcp), then RCAS (8 FADD, 4 FMNMX) and the store
    "fsr_fused": """
        Function : _Z17fsr_inside_kernel6Params
        /*0100*/                   LDS R2, [R0] ;
        /*0110*/                   FMUL R3, R2, 0.5 ;
        /*0120*/                   STS [R0], R3 ;
        /*0130*/              @P0 BRA 0x100 ;
        /*0140*/                   LDS R4, [R0] ;
        /*0150*/                   MUFU.RCP R5, R4 ;
        /*0160*/                   FMUL R5, R5, R4 ;
        /*0170*/                   FMUL R5, R5, R4 ;
        /*0180*/                   FMUL R5, R5, R4 ;
        /*0190*/                   FMUL R5, R5, R4 ;
        /*01a0*/                   FSETP.GT.AND P1, PT, R5, R4, PT ;
        /*01b0*/                   FSETP.LT.AND P2, PT, R5, R4, PT ;
        /*01c0*/                   STS [R1], R5 ;
        /*01d0*/              @P3 BRA 0x140 ;
        /*01e0*/                   FADD R6, R5, R4 ;
        /*01f0*/                   FADD R6, R6, R4 ;
        /*0200*/                   FADD R6, R6, R4 ;
        /*0210*/                   FADD R6, R6, R4 ;
        /*0220*/                   FADD R6, R6, R4 ;
        /*0230*/                   FADD R6, R6, R4 ;
        /*0240*/                   FADD R6, R6, R4 ;
        /*0250*/                   FADD R6, R6, R4 ;
        /*0260*/                   FMNMX R6, R6, R4, PT ;
        /*0270*/                   FMNMX R6, R6, R4, PT ;
        /*0280*/                   FMNMX R6, R6, R4, PT ;
        /*0290*/                   FMNMX R6, R6, R4, PT ;
        /*02a0*/                   STG.E desc[UR4][R6.64], R6 ;
        /*02b0*/              @P4 BRA 0x100 ;
        /*02c0*/                   EXIT ;
""",
}


def test_inside_float_per_output_reads_each_rule():
    """One inside output's float instructions (arithmetic, compare-select)
    from an inside kernel's SASS: B2/B4/B5/B6 the function less its staging
    loops over 4 outputs per thread; B3 its run loop plus each staging
    loop per input pixel; B1 its stage-1 loop per haloed position plus its
    tile loop's RCAS over 4. None without the inside kernel."""
    per = sass.inside_float_per_output
    assert per(INSIDE_SASS["cas_sharpen"], "cas_sharpen") == (2 / 4, 3 / 4)
    assert per(INSIDE_SASS["cas_sharpen"], "rcas_sharpen") is None
    assert per(INSIDE_SASS["nis_scaler"], "nis_scaler", 0.5) == \
        pytest.approx((3 + 2 * 0.5, 1))
    h = (34 / 32) ** 2
    assert per(INSIDE_SASS["fsr_fused"], "fsr_fused") == pytest.approx(
        (4 * h + (13 - 1 - 4) / 4, 2 * h + (6 - 2) / 4))
    # without a stage-1 loop (no MUFU) the FSR rule finds nothing to read
    no_rcp = INSIDE_SASS["fsr_fused"].replace("MUFU.RCP", "FCHK")
    assert per(no_rcp, "fsr_fused") is None
    assert set(sass.INSIDE_RULES) == set(A.SMEM_WORDS)


def test_wt_swizzle_is_a_bijection():
    """The W^T tile the tensor-core probe's wgmma reads (csrc/mxu_rate.cu
    wt_offset, stated in kernels/sol.py): the 128 x 128 bf16 elements map
    one to one onto the 32 KB tile's 2-byte slots; each row's 16-byte
    chunks of one atom stay in the row's 128 bytes, permuted by the row
    within its block of 8, and every 8 rows x 16 bytes of one k16 slice
    hit 8 distinct bank groups."""
    n, k = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    off = sol.wt_swizzle_offset(n, k)
    assert off.min() == 0 and off.max() == 32 * 1024 - 2
    assert (off % 2 == 0).all()
    assert len(np.unique(off)) == 128 * 128
    row = (k // 64) * 128 * 128 + n * 128
    assert ((off - row >= 0) & (off - row < 128)).all()
    assert np.array_equal((off - row) % 16, (k % 8) * 2)
    chunk = (off // 16) % 8
    for kk in range(8):
        for n0 in range(0, 128, 8):
            chunks = chunk[n0:n0 + 8, 16 * kk]
            assert len(set(chunks.tolist())) == 8
    # the descriptor's k16 step: 32 bytes further into the atom's rows
    assert np.array_equal(sol.wt_swizzle_offset(0, np.arange(0, 64, 16)),
                          np.arange(4) * 32)


def test_ab_drives_the_tensor_probe_through_another_entry():
    """tools/ab.py --kernel mxu_rate runs the earlier build through the
    probe's own wrapper with its entry point swapped in for the call (the
    prototype is unchanged), and restores the binder after."""
    from openvr_fsr_tpu_torch.kernels import _build
    from openvr_fsr_tpu_torch.tools import ab
    original = _build.entry_point
    seen = []
    run = ab._through_entry("entry", lambda: seen.append(_build.entry_point(
        "mxu_rate", "mxu_rate_launch")))
    run()
    assert seen == ["entry"] and _build.entry_point is original
    assert "mxu_rate" in ab.PROBE_KERNELS and "dma_floor" in ab.KERNELS


@pytest.mark.parametrize("entry", ["Pipeline", "upscale", "FsrModel"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """No device means the CUDA device: without a GPU the entry point
    raises at construction, naming the device; device="cpu" runs the plain
    version on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = np.zeros((2, 24, 32, 4), np.uint8)
    calls = {
        "Pipeline": lambda **kw: T.Pipeline(T.Config(enabled=True), **kw)
        .process(frame),
        "upscale": lambda **kw: T.upscale(frame, render_scale=0.75, **kw),
        "FsrModel": lambda **kw: T.FsrModel(**kw)(frame),
    }
    with pytest.raises(RuntimeError, match="'cuda' requested by default"):
        calls[entry]()
    out = calls[entry](device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.uint8


def test_ab_drives_the_probe_through_another_entry():
    """tools/ab.py --kernel vmem_rate runs the earlier or ablated build
    through the probe's own wrapper with its entry point swapped in for the
    call (and restored after), at the shares the earlier source filled the
    card with: 130-thread CTAs of 58 KB at the audit's k, 3 per SM, on 132
    SMs over 128 columns."""
    from openvr_fsr_tpu_torch.kernels import _build
    from openvr_fsr_tpu_torch.tools import ab
    original = _build.entry_point
    seen = []
    run = ab._through_entry("entry", lambda x: seen.append(
        (x, _build.entry_point("vmem_rate", "vmem_rate_launch"))))
    run(7)
    assert seen == [(7, "entry")] and _build.entry_point is original
    k_lo, k_hi, steps = A.PROBES["vmem"][0]
    smem = (-(-k_hi // 4) * 4 * 130 + 130) * 4
    per_sm = min(sol.SM_SMEM // (smem + 1024), 2048 // (32 * 5), 32)
    assert ab.PARENT_VMEM_SHARES == sol.SMS * per_sm // 128 == 3
