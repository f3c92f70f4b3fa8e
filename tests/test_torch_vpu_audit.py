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
    at 1980 MHz), far above its Horner ops over the data sheet's FP32 rate;
    the FP32 and tensor-core probes are bound by their operations."""
    b = A.probe_bounds(sol.build_vpu_rate(144, steps=1024),
                       sol.build_vmem_rate(112, steps=4096),
                       sol.build_mxu_rate(64, steps=264), 132, 1980e6)
    ms, by = b["vmem_rate"]
    assert by == "smem"
    assert ms == pytest.approx(112 * 130 * 128 * 4 * 4096
                               / (132 * 128 * 1980e6) * 1e3)
    assert round(ms, 3) == 0.913
    assert b["vpu_rate"][1] == b["mxu_rate"][1] == "operations"
    assert b["vpu_rate"][0] == pytest.approx(
        144 * 30 * 130 * 128 * 1024 / A.FP32_OPS_PER_S * 1e3)
    assert b["mxu_rate"][0] == pytest.approx(
        2 * 64 * 264 * 8 * 128 ** 3 / A.BF16_FLOPS_PER_S * 1e3)
    # without its smem term the shared-memory probe would read "operations"
    assert A.roofline_bound(112 * 130 * 128 * 4, 2 * 112 * 130 * 128 * 4096
                            )[1] == "operations"
    assert A.roofline_bound(1e9, 0) == pytest.approx(
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
    """The redesigned kernels' shared words per inside pixel: B5 reads its
    12 taps from three f32 planes; B3 the two diagonal phases' table rows
    per output, the fx rows per run of 6, and on each reload / one-row
    step of the source row 52 / 14 words (lumas and edge weights). Its
    average over the main path's runs is the pinned 44, within 50."""
    from openvr_fsr_tpu_torch.core import constants as C
    from openvr_fsr_tpu_torch.kernels._maps import nvscaler_maps
    assert A.SMEM_WORDS["nis_scaler"] == (44, 0)
    assert A.SMEM_WORDS["cas_upscale"] == (36, 0)
    assert A.SMEM_WORDS["fsr_fused"] == (68, 0)
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
    from openvr_fsr_tpu_torch.tools import ab
    original = sol._probe_launch
    seen = []
    run = ab._through_entry("vmem_rate", "entry",
                            lambda x: seen.append(
                                (x, sol._probe_launch("vmem_rate", 3, 5))))
    run(7)
    assert seen == [(7, "entry")] and sol._probe_launch is original
    k_lo, k_hi, steps = A.PROBES["vmem"][0]
    smem = (-(-k_hi // 4) * 4 * 130 + 130) * 4
    per_sm = min(sol.SM_SMEM // (smem + 1024), 2048 // (32 * 5), 32)
    assert ab.PARENT_VMEM_SHARES == sol.SMS * per_sm // 128 == 3
