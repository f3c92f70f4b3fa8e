"""The port's precision="half" (bf16 working type) for NIS on the CPU: the
four NIS half cores op by op against the JAX package's, the plain
NVScaler and NVSharpen half pipelines against the JAX package's Pallas
kernels in interpret mode, half against full precision, and the plumbing
(entry points, cache keys, toggle_nis, ShardedPipeline, NisModel).

What half means on NIS: the JAX Pallas kernels' policy (openvr_fsr_tpu/
kernels/nis.py build_nvscaler and build_nvsharpen at precision="half"),
each op in the dtype their bodies give it. The cores (ops/nis.py
eval_poly6_core, _calc_lti_jax, _eval_usm_jax, _calc_lti_fast_jax) are
held to the JAX cores bit for bit under jax.disable_jit(); the pipelines
to a JAX subprocess with --xla_allow_excess_precision=false (at most 1
LSB, the share of unequal values stated) and to one with the default
flags (a wider tier, stated below), as tests/test_torch_half.py does for
FSR and CAS. Every case with a radius above 0 shows that the bf16 math
ran: half differs from full somewhere (at 2 x 48x56 and radius 0.5 no
NVSharpen block is inside the circle, so its cases use radius 2.0).

The CUDA half instantiations run only on the card: `python3 chip_smoke.py`
holds them against these plain versions there (its [half] phase).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openvr_fsr_tpu.ops import nis as JN  # noqa: E402

import openvr_fsr_tpu_torch as T  # noqa: E402
from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.core.nis_tables import (COEF_SCALE,  # noqa: E402
                                                  COEF_USM)
from openvr_fsr_tpu_torch.ops import nis as TN  # noqa: E402
from openvr_fsr_tpu_torch.ops.common import HALF, lit  # noqa: E402
from openvr_fsr_tpu_torch.parallel.sharding import ShardedPipeline  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BF16 = ml_dtypes.bfloat16
SHAPE = (24, 40)


def _lumas(rng, shape, levels, scale=1.0):
    """bf16 lumas k / levels * scale (scale 255: NVScaler's scaled taps),
    k uniform in [0, levels], with flat runs in the first rows (both
    contrast windows 0: the LTI's epsilon alone divides there). Returns
    (numpy bf16, torch bf16) of the same values."""
    k = rng.integers(0, levels + 1, shape)
    k[..., :4, :] = k[..., :1, :1]
    x = (k.astype(np.float32) * np.float32(1.0 / levels)
         * np.float32(scale)).astype(np.float32)
    return x.astype(BF16), torch.from_numpy(x).to(HALF)


def _jax_bf16(fn):
    """fn evaluated op by op (each primitive on its own, no fusion)."""
    with jax.disable_jit():
        out = fn()
    return np.asarray(jax.device_get(out))


def _same_bits(got, want):
    """got (a torch bf16 tensor) and want (numpy) hold the same values,
    NaN for NaN."""
    assert got.dtype == HALF, got.dtype
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    both_nan = np.isnan(g) & np.isnan(w)
    ne = ~((g == w) | both_nan) | (np.signbit(g) != np.signbit(w)) & ~both_nan
    assert not ne.any(), (f"{int(ne.sum())} of {ne.size} values differ, "
                          f"first at {np.argwhere(ne)[0]}: {g[ne][:4]} vs "
                          f"{w[ne][:4]}")


def _scaler_cfg(sharpness):
    return C.nvscaler_update_config(sharpness, 56, 48, 56, 48, 74, 64, 74,
                                    64)


def _phases(rng):
    """int phases 0..63 over SHAPE and the lo mask (phase <= 32)."""
    ph = rng.integers(0, 64, SHAPE)
    return ph, ph <= 32


# ---- (a) the four NIS half cores against the JAX cores, op by op ----------

@pytest.mark.parametrize("levels", [255, 1023])
@pytest.mark.parametrize("seed", [0, 1])
def test_calc_lti_half_bit_equal(levels, seed):
    """ops/nis.py::_calc_lti(dt=bf16) equals the JAX _calc_lti_jax at
    dt=bfloat16 on scaled lumas (its division in f32, rounded once)."""
    rng = np.random.default_rng(seed)
    taps = [_lumas(rng, SHAPE, levels, 255.0) for _ in range(6)]
    _, lo = _phases(rng)
    cfg = _scaler_cfg(0.9)
    want = _jax_bf16(lambda: JN._calc_lti_jax(
        [jnp.asarray(a) for a, _ in taps], lo, cfg, BF16))
    got = TN._calc_lti([t for _, t in taps], torch.from_numpy(lo), cfg, HALF)
    _same_bits(got, want)


@pytest.mark.parametrize("levels", [255, 1023])
@pytest.mark.parametrize("sharpness", [0.0, 0.9, 1.0])
def test_eval_poly6_core_half_bit_equal(levels, sharpness):
    """ops/nis.py::eval_poly6_core(dt=bf16) equals the JAX eval_poly6_core
    at dt=bfloat16: scaled-luma taps and the COEF_SCALE / COEF_USM rows at
    random phases, both rounded to bf16 as the JAX kernel casts them."""
    rng = np.random.default_rng(levels + int(sharpness * 10))
    taps = [_lumas(rng, SHAPE, levels, 255.0) for _ in range(6)]
    ph, lo = _phases(rng)
    cs = [COEF_SCALE[:, i][ph] for i in range(6)]
    cu = [COEF_USM[:, i][ph] for i in range(6)]
    cfg = _scaler_cfg(sharpness)
    want = _jax_bf16(lambda: JN.eval_poly6_core(
        [jnp.asarray(a) for a, _ in taps],
        [jnp.asarray(c.astype(BF16)) for c in cs],
        [jnp.asarray(c.astype(BF16)) for c in cu], lo, cfg, BF16))
    got = TN.eval_poly6_core(
        [t for _, t in taps], [torch.from_numpy(c).to(HALF) for c in cs],
        [torch.from_numpy(c).to(HALF) for c in cu], torch.from_numpy(lo),
        cfg, HALF)
    _same_bits(got, want)


@pytest.mark.parametrize("levels", [255, 1023])
@pytest.mark.parametrize("seed", [0, 1])
def test_calc_lti_fast_half_bit_equal(levels, seed):
    """ops/nis.py::_calc_lti_fast(dt=bf16) equals the JAX
    _calc_lti_fast_jax at dt=bfloat16 on unscaled lumas: its epsilon is
    the f32 product kEps * f32(1/255) rounded once."""
    rng = np.random.default_rng(seed + 5)
    taps = [_lumas(rng, SHAPE, levels) for _ in range(5)]
    cfg = C.nvsharpen_update_config(0.9, 56, 48, 56, 48)
    want = _jax_bf16(lambda: JN._calc_lti_fast_jax(
        [jnp.asarray(a) for a, _ in taps], cfg, BF16))
    got = TN._calc_lti_fast([t for _, t in taps], cfg, HALF)
    _same_bits(got, want)


@pytest.mark.parametrize("levels", [255, 1023])
@pytest.mark.parametrize("sharpness", [0.0, 0.9, 1.0])
def test_eval_usm_half_bit_equal(levels, sharpness):
    """ops/nis.py::_eval_usm(dt=bf16) equals the JAX _eval_usm_jax at
    dt=bfloat16, with strength and limit made from the centre tap as the
    JAX NVSharpen kernel makes them (bf16, its dt literals)."""
    rng = np.random.default_rng(levels + 3 + int(sharpness * 10))
    taps = [_lumas(rng, SHAPE, levels) for _ in range(5)]
    cfg = C.nvsharpen_update_config(sharpness, 56, 48, 56, 48)

    def setup(yc, sat, dt):
        scale = dt(1.0) - sat((yc - dt(cfg.kSharpStartY))
                              * dt(cfg.kSharpScaleY))
        strength = scale * dt(cfg.kSharpStrengthScale) \
            + dt(cfg.kSharpStrengthMin)
        limit = (scale * dt(cfg.kSharpLimitScale)
                 + dt(cfg.kSharpLimitMin)) * yc
        return strength, limit

    def jax_usm():
        p = [jnp.asarray(a) for a, _ in taps]
        st, li = setup(p[2], lambda a: JN._sat_dt(a, BF16), BF16)
        return JN._eval_usm_jax(p, st, li, cfg, BF16)
    want = _jax_bf16(jax_usm)
    p = [t for _, t in taps]
    st, li = setup(p[2], TN.sat, lambda v: lit(v, HALF))
    _same_bits(TN._eval_usm(p, st, li, cfg, HALF), want)


# (JAX core, its arguments) at dt=bfloat16 -> the bf16 ops of its jaxpr
JAX_CORES = {
    "eval_poly6_core": (lambda a: JN.eval_poly6_core(
        a[:6], a[6:12], a[12:18], np.zeros((8, 8), bool), _scaler_cfg(0.9),
        BF16), 18, 63),
    "_calc_lti_jax": (lambda a: JN._calc_lti_jax(
        a, np.zeros((8, 8), bool), _scaler_cfg(0.9), BF16), 6, 24),
    "_eval_usm_jax": (lambda a: JN._eval_usm_jax(
        a[:5], a[5], a[6], _scaler_cfg(0.9), BF16), 7, 29),
    "_calc_lti_fast_jax": (lambda a: JN._calc_lti_fast_jax(
        a, _scaler_cfg(0.9), BF16), 5, 19),
}


@pytest.mark.parametrize("core", list(JAX_CORES))
def test_jax_nis_cores_are_bf16_but_the_division(core):
    """The JAX NIS half cores' jaxprs (jax.make_jaxpr at dt=bfloat16) hold
    bf16 ops and one f32 op, _div_dt's division: unlike EASU's sat, _sat_dt
    keeps its literals in dt, so nothing else lifts to f32. That is the
    dtype policy ops/nis.py implements (converts, broadcasts and reshapes
    not counted)."""
    fn, nargs, n_bf16 = JAX_CORES[core]
    skip = {"convert_element_type", "broadcast_in_dim", "reshape",
            "squeeze", "copy"}
    counts = {}

    def walk(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "pjit":
                walk(e.params["jaxpr"].jaxpr)
            elif e.primitive.name not in skip:
                dt = str(e.outvars[0].aval.dtype)
                counts[dt, e.primitive.name] = counts.get(
                    (dt, e.primitive.name), 0) + 1
    walk(jax.make_jaxpr(lambda *a: fn(a))(
        *[jnp.zeros((8, 8), jnp.bfloat16)] * nargs).jaxpr)
    f32 = {k: v for k, v in counts.items() if k[0] == "float32"}
    assert f32 == {("float32", "div"): 1}, f32
    assert sum(v for k, v in counts.items() if k[0] == "bfloat16") == n_bf16


def test_cores_keep_f32_at_full():
    """At dt=f32 (the default) the cores' literals are the f32 values the
    full paths always used: lit(v, f32) is float(f32(v))."""
    for v in (1.0 / 255.0, -0.6001, 1.2002, _scaler_cfg(0.9).kEps):
        assert lit(v) == float(np.float32(v))


# ---- (b)-(d) the plain half pipelines ----------------------------------------

NIS_PATHS = {"nvscaler": dict(render_scale=0.75, use_nis=True),
             "nvsharpen": dict(render_scale=1.0, use_nis=True)}


def _case(path, radius, debug=False, hdr=0, bits=8):
    return (dict(enabled=True, sharpness=0.9, radius=radius, debug_mode=debug,
                 **NIS_PATHS[path]), bits, hdr)


# case -> (Config kwargs, color_bits, hdr_mode)
CASES = {}
for _p in NIS_PATHS:
    CASES[f"{_p} r2.0"] = _case(_p, 2.0)
    CASES[f"{_p} r0.0 debug"] = _case(_p, 0.0, debug=True)
    CASES[f"{_p} r2.0 hdr1"] = _case(_p, 2.0, hdr=1)
    CASES[f"{_p} r2.0 hdr2"] = _case(_p, 2.0, hdr=2)
    CASES[f"{_p} r2.0 10-bit"] = _case(_p, 2.0, bits=10)
CASES["nvscaler r0.5"] = _case("nvscaler", 0.5)


def _frames():
    """{8: (2, 48, 56, 4) uint8 zone plate + noise, alpha not all 255;
    10: the same widened to R10G10B10A2 (v to v * 4 + v // 64, bench.py's
    ring_frames), alpha in {0..3}}."""
    from openvr_fsr_tpu_torch.utils import frames as FR
    rng = np.random.default_rng(15)
    f8 = np.stack([FR.zone_plate_frame(48, 56), FR.noise_frame(48, 56, 3)])
    f8[..., 3] = rng.integers(0, 256, (2, 48, 56))
    f10 = f8.astype(np.uint16) * 4 + f8 // 64
    f10[..., 3] = rng.integers(0, 4, (2, 48, 56))
    return {8: f8, 10: f10}


# One process computes every case through the JAX package's Pallas kernels
# in interpret mode at precision="half": argv cases (JSON), frames (.npz),
# output (.npz).
JAX_HALF = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import openvr_fsr_tpu as J
cases, src = json.loads(sys.argv[1]), np.load(sys.argv[2])
out = {}
for name, (kw, bits, hdr) in cases.items():
    pipe = J.Pipeline(J.Config(**kw), color_bits=bits, hdr_mode=hdr,
                      backend="pallas-interpret", precision="half")
    out[name] = np.asarray(pipe.process(src[str(bits)], eyes=(0, 1)))
np.savez(sys.argv[3], **out)
"""
# XLA_FLAGS of the two JAX runs: per-op rounding, and the default flags
# (excess precision allowed inside fusions)
JAX_FLAGS = {"per_op": "--xla_allow_excess_precision=false", "default": ""}


@pytest.fixture(scope="module")
def jax_half(tmp_path_factory):
    """{flags: {case: the JAX half output}}: both JAX runs at once, each in
    one subprocess over every case."""
    tmp = tmp_path_factory.mktemp("jax_nis_half")
    frames = _frames()
    np.savez(tmp / "frames.npz", **{str(k): v for k, v in frames.items()})
    procs = {}
    for flags, xla in JAX_FLAGS.items():
        env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=xla)
        procs[flags] = subprocess.Popen(
            [sys.executable, "-c", JAX_HALF, json.dumps(CASES),
             str(tmp / "frames.npz"), str(tmp / f"{flags}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    out = {}
    for flags, proc in procs.items():
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log[-4000:]
        with np.load(tmp / f"{flags}.npz") as z:
            out[flags] = {k: z[k] for k in z.files}
    return out


@pytest.fixture(scope="module")
def port_out():
    """{(case, precision): the port's plain version's output} on the CPU."""
    frames = _frames()
    out = {}
    for name, (kw, bits, hdr) in CASES.items():
        for prec in ("half", "full"):
            pipe = T.Pipeline(T.Config(**kw), color_bits=bits, hdr_mode=hdr,
                              precision=prec, device="cpu")
            out[name, prec] = pipe.process(frames[bits], eyes=(0, 1)).numpy()
    return out


def _diff(a, b):
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


def _lsb8(case, d):
    """d in 8-bit LSB (a 10-bit LSB is a quarter)."""
    return d / (4.0 if CASES[case][1] == 10 else 1.0)


@pytest.mark.parametrize("case", list(CASES))
def test_nis_half_pipeline_per_op(case, jax_half, port_out):
    """Each plain NIS half pipeline is within 1 LSB of the JAX package's
    Pallas kernels (interpret mode) run with
    --xla_allow_excess_precision=false, alpha included, at most 0.1% of
    the values unequal (measured: NVSharpen 0 in every case; NVScaler at
    most 0.034%, at radius 2.0: isolated rounding boundaries of its f32
    parts, one value even at radius 0.0, where only the full-precision
    fallback runs)."""
    got, want = port_out[case, "half"], jax_half["per_op"][case]
    assert got.shape == want.shape and got.dtype == want.dtype
    d = _diff(got, want)
    print(f"{case}: against the per-op run: max {d.max()} LSB, unequal "
          f"{(d > 0).mean():.6f}")
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 0.001, (d > 0).mean()


@pytest.mark.parametrize("case", list(CASES))
def test_nis_half_pipeline_default_flags(case, jax_half, port_out):
    """Against the same JAX kernels under the default XLA flags, whose
    fusions may skip bf16 round trips (xla_allow_excess_precision): the
    tier measured on these cases, in 8-bit LSB, far inside half against
    full (test_nis_half_against_full): at most 2 LSB (measured 2, at
    hdr_mode 1) and at most 1% of the values more than 1 LSB apart
    (measured 0.77%, NVScaler at hdr_mode 1; up to 26% of the values
    differ by 1 LSB, NVScaler at 10 bits)."""
    got, want = port_out[case, "half"], jax_half["default"][case]
    assert got.shape == want.shape and got.dtype == want.dtype
    d = _lsb8(case, _diff(got, want))
    print(f"{case}: against the default-flag run: max {d.max()} LSB, more "
          f"than 1 LSB {(d > 1).mean():.6f}, unequal {(d > 0).mean():.6f}")
    assert d.max() <= 2, d.max()
    assert (d > 1).mean() <= 0.01, (d > 1).mean()


@pytest.mark.parametrize("case", list(CASES))
def test_nis_half_runs_the_bf16_math(case, port_out):
    """Half differs from full somewhere in every case with a radius above
    0 (the bf16 filters ran inside the circle); at radius 0.0 only the
    full-precision fallback runs and half equals full."""
    half, full = port_out[case, "half"], port_out[case, "full"]
    if CASES[case][0]["radius"] > 0:
        assert (half != full).any()
    else:
        assert np.array_equal(half, full)


@pytest.mark.parametrize("path", list(NIS_PATHS))
def test_nis_half_against_full(path):
    """Half against full precision in the port at the JAX suite's bar for
    NIS half, on its own case (tests/test_kernels_fsr.py::
    TestHalfPrecisionAllPaths: 2 x 96x130 zone plate + noise, sharpness
    0.9, radius 0.5; the edge classification of bf16 luma can flip a
    pixel's blend, so the tail is bounded by quantile): at least 95% of the
    values within 2 LSB and 99.9% within 32 (measured: NVSharpen 99.95% and
    99.997%, max 53 LSB; NVScaler 99.87% and 100%, max 4). At radius 2.0
    every pixel takes the bf16 filters and the tail is longer (NVSharpen
    at hdr_mode 1: 91.6% within 2 LSB, max 158 on the 48x56 cases above),
    as the JAX kernels' own, which test_nis_half_pipeline_per_op holds the
    port to."""
    from openvr_fsr_tpu_torch.utils import frames as FR
    frames = np.stack([FR.zone_plate_frame(96, 130),
                       FR.noise_frame(96, 130, seed=3)])
    cfg = T.Config(enabled=True, sharpness=0.9, radius=0.5, **NIS_PATHS[path])
    half, full = (T.Pipeline(cfg, precision=p, device="cpu").process(
        frames, eyes=(0, 1)).numpy() for p in ("half", "full"))
    d = _diff(half, full)
    print(f"{path}: half vs full: max {d.max()} LSB, within 2 LSB "
          f"{(d <= 2).mean():.5f}, within 32 {(d <= 32).mean():.6f}")
    assert (d > 0).any()
    assert (d <= 2).mean() >= 0.95 and (d <= 32).mean() >= 0.999


# ---- (e) plumbing -------------------------------------------------------------

def _stereo():
    return _frames()[8]


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("path", list(NIS_PATHS))
def test_cache_key_holds_precision(path, sharded):
    """Pipeline.process's and ShardedPipeline.process's build keys hold the
    precision on the NIS plans: switching it builds again, with the other
    precision's output and build."""
    pipe = T.Pipeline(T.Config(enabled=True, radius=2.0, **NIS_PATHS[path]),
                      device="cpu")
    cpu = torch.device("cpu")
    run = (ShardedPipeline(pipe, [cpu, cpu]).process if sharded
           else pipe.process)

    def out(x):
        return torch.cat(x) if sharded else x
    frames = np.concatenate([_stereo()] * (2 if sharded else 1))
    full = out(run(frames))
    assert len(pipe._cache) == 1
    pipe.precision = "half"
    half = out(run(frames))
    assert len(pipe._cache) == 2 and not torch.equal(full, half)
    assert sorted(fn.precision for fn in pipe.kernels) == ["full", "half"]
    assert torch.equal(half, T.Pipeline(pipe.config, precision="half",
                                        device="cpu").process(frames))
    pipe.precision = "full"
    assert torch.equal(out(run(frames)), full) and len(pipe._cache) == 2


def test_toggle_nis_runs_half():
    """toggle_nis() on a live half pipeline builds the NIS kernel at half
    (never full precision in its place), equal to a half NIS pipeline;
    toggling back gives the half FSR output again."""
    frames = _stereo()
    pipe = T.Pipeline(T.Config(enabled=True, render_scale=0.75, radius=2.0),
                      precision="half", device="cpu")
    fsr = pipe.process(frames)
    pipe.toggle_nis()
    got = pipe.process(frames)
    (fn,) = pipe.kernels
    assert fn.precision == "half" and pipe.config.use_nis
    assert torch.equal(got, T.Pipeline(pipe.config, precision="half",
                                       device="cpu").process(frames))
    assert not torch.equal(got, T.Pipeline(pipe.config,
                                           device="cpu").process(frames))
    pipe.toggle_nis()
    assert torch.equal(pipe.process(frames), fsr)


@pytest.mark.parametrize("rs", [0.75, 1.0])
def test_nis_model_and_upscale_take_half(rs):
    """NisModel(precision="half"), its sharded() over two CPU slices and
    upscale(use_nis=True, precision="half") run the half build and agree
    with Pipeline(precision="half")."""
    frames = _stereo()
    want = T.Pipeline(T.Config(enabled=True, use_nis=True, render_scale=rs,
                               sharpness=0.9, radius=2.0), precision="half",
                      device="cpu").process(frames)
    model = T.NisModel(render_scale=rs, radius=2.0, precision="half",
                       device="cpu")
    assert torch.equal(model(frames), want)
    assert [fn.precision for fn in model.pipeline.kernels] == ["half"]
    cpu = torch.device("cpu")
    both = model.sharded([cpu, cpu]).process(np.concatenate([frames] * 2))
    assert all(torch.equal(x, want) for x in both)
    assert torch.equal(T.upscale(frames, render_scale=rs, use_nis=True,
                                 radius=2.0, precision="half", device="cpu"),
                       want)


@pytest.mark.parametrize("path", list(NIS_PATHS))
def test_half_build_keeps_the_geometry(path):
    """A half build publishes its precision and the full build's DMA
    geometry (the same texels move), and the same pad."""
    fns = {}
    for prec in ("full", "half"):
        pipe = T.Pipeline(T.Config(enabled=True, radius=0.5,
                                   **NIS_PATHS[path]), precision=prec,
                          device="cpu")
        pipe.process(_stereo())
        (fns[prec],) = pipe.kernels
    assert fns["half"].precision == "half"
    assert fns["half"].dma_geometry.keys() == fns["full"].dma_geometry.keys()
    for k, v in fns["full"].dma_geometry.items():
        assert np.array_equal(np.asarray(fns["half"].dma_geometry[k]),
                              np.asarray(v)), k
    assert fns["half"].pad_to == fns["full"].pad_to


# ---- the CUDA half instantiations' entry points (driven without a card) -------

# kernel -> (its Pipeline plan, its entry-point getter in kernels/nis.py)
NIS_KERNELS = {"nis_scaler": (NIS_PATHS["nvscaler"], "_scaler_fn"),
               "nis_sharpen": (NIS_PATHS["nvsharpen"], "_sharpen_fn")}


def _prototype(kernel, entry):
    import re
    from openvr_fsr_tpu_torch.kernels import _build
    text = (_build.CSRC / f"{kernel}.cu").read_text()
    (params,) = re.findall(rf'extern "C" int {entry}\((.*?)\)\s*\{{', text,
                           re.S)
    return [" ".join(p.split()).rsplit(" ", 1)[0].replace(" *", "*")
            for p in params.split(",")]


@pytest.mark.parametrize("kernel", list(NIS_KERNELS))
def test_half_entry_points_share_the_prototype(kernel):
    """Each NIS source exports <kernel>_launch_h, _launch10_h,
    _occupancy_h and _occupancy10_h with the full entry points'
    parameters, so one argtypes list binds all."""
    for entry in ("launch", "occupancy"):
        want = _prototype(kernel, f"{kernel}_{entry}")
        for suffix in ("_h", "10_h"):
            assert _prototype(kernel, f"{kernel}_{entry}{suffix}") == want


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("kernel", list(NIS_KERNELS))
def test_launch_takes_the_half_entry(kernel, bits, monkeypatch):
    """On a CUDA tensor a half NIS build would call the half entry point of
    its texel format, with the constants of the filters (nis::Consts 2-12,
    the JAX kernels' dt(cfg.k...)) rounded to bf16 on the host and the
    edge map's and the corrections' constants f32: driven here through the
    launch closure with the entry point swapped."""
    from openvr_fsr_tpu_torch.kernels import nis
    plan, getter = NIS_KERNELS[kernel]
    asked, seen = [], {}

    def entry(*args):
        seen["args"] = args
        return 0

    def get(*args):
        asked.append(args)
        return entry
    monkeypatch.setattr(nis, getter, get)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "S", (), {"cuda_stream": 0})())
    fns = {}
    for prec in ("full", "half"):
        pipe = T.Pipeline(T.Config(enabled=True, sharpness=0.9, **plan),
                          color_bits=bits, precision=prec, device="cpu")
        fns[prec] = pipe._build(2, 45, 61, (0, 1), False).kernel
    def cells(f):
        return dict(zip(f.__code__.co_freevars,
                        (c.cell_contents for c in f.__closure__)))
    launch = {p: cells(fn)["launch"] for p, fn in fns.items()}
    x = (torch.zeros((2, 45, 61, 4), dtype=torch.uint16) if bits == 10
         else torch.zeros((2, 45, 61), dtype=torch.int32))
    out, err = launch["half"](x)
    assert err == 0 and asked == [(bits, "half")] and fns["half"].launches == 0
    full, half = (cells(launch[p])["consts"] for p in ("full", "half"))
    assert half.ctypes.data in seen["args"] and half.dtype == np.float32
    assert np.array_equal(half[2:13], [lit(v, HALF) for v in full[2:13]])
    assert not np.array_equal(half[2:13], full[2:13])   # the rounding shows
    assert np.array_equal(half[:2], full[:2])
    assert np.array_equal(half[13:], full[13:])


def test_occupancy_names_the_half_entry(monkeypatch):
    """occupancy(name, bits, "half") asks <name>_occupancy_h and
    <name>_occupancy10_h of the NIS libraries."""
    from openvr_fsr_tpu_torch.kernels import _build, _common
    names = []

    class Lib:
        def __getattr__(self, name):
            names.append(name)

            def f(*args):
                for a in args:
                    a._obj.value = 2
                return 0
            return f
    monkeypatch.setattr(_build, "load_library", lambda name: Lib())
    _common.occupancy("nis_scaler", 8, "half")
    _common.occupancy("nis_sharpen", 10, "half")
    assert names == ["nis_scaler_occupancy_h", "nis_sharpen_occupancy10_h"]


@pytest.mark.parametrize("kernel", list(NIS_KERNELS))
def test_nis_half_ops_in_issue_slots(kernel):
    """tools/vpu_audit.py prices the NIS half cores' ops in FP32 issue
    slots, a bf16 op one half: the inside path's count lies between half
    and all of the full one's (the edge map and the combine stay f32), the
    fallback (f32 in both) is the full one's."""
    from openvr_fsr_tpu_torch.tools import vpu_audit
    full = vpu_audit.path_ops(kernel, in_per_out=0.5625)
    half = vpu_audit.path_ops(kernel, in_per_out=0.5625, precision="half")
    assert full[0] / 2 < half[0] < full[0] and half[1] == full[1]
