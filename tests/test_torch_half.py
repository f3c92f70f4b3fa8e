"""The port's precision="half" (bf16 working type) for FSR and CAS on the
CPU: the four half cores op by op against the JAX package's, the plain
half pipelines against the JAX package's Pallas kernels in interpret mode,
half against full precision, and the plumbing (cache keys, refusals).

What half means: the JAX package's dt=bfloat16 cores (ops/easu.py
easu_core_split, ops/rcas.py rcas_core, ops/cas.py cas_core and
cas_upscale_core), each op in the dtype its jaxpr gives it and each bf16
result the f32 result rounded to nearest even. That is what JAX computes
under jax.disable_jit(), and what torch's eager bf16 ops compute; the
cores are held to it bit for bit. A compiled XLA program may keep excess
precision inside a fusion (xla_allow_excess_precision, on by default), so
the pipelines are compared with a JAX subprocess that turns it off (at
most 1 LSB, the share of unequal values stated) and with the default
flags (a wider tier, stated below).

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

from openvr_fsr_tpu.ops import cas as JCAS  # noqa: E402
from openvr_fsr_tpu.ops import easu as JEASU  # noqa: E402
from openvr_fsr_tpu.ops import rcas as JRCAS  # noqa: E402

import openvr_fsr_tpu_torch as T  # noqa: E402
from openvr_fsr_tpu_torch.ops import cas as TCAS  # noqa: E402
from openvr_fsr_tpu_torch.ops import easu as TEASU  # noqa: E402
from openvr_fsr_tpu_torch.ops import rcas as TRCAS  # noqa: E402
from openvr_fsr_tpu_torch.ops.common import HALF  # noqa: E402
from openvr_fsr_tpu_torch.parallel.sharding import ShardedPipeline  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BF16 = ml_dtypes.bfloat16
SHAPE = (24, 40)


def _texels(rng, shape, levels):
    """f32 texel values k / levels decoded as the kernels do (k times the
    f32 reciprocal), k uniform in [0, levels], with runs of equal values
    (flat regions, where RCAS divides by zero) in the first rows."""
    k = rng.integers(0, levels + 1, shape)
    k[..., :4, :] = k[..., :1, :1]
    return (k.astype(np.float32) * (np.float32(1.0) / np.float32(levels))
            ).astype(np.float32)


def _fractions(rng, n):
    return rng.random(n, dtype=np.float32)


def _jax_bf16(fn):
    """fn evaluated op by op (each primitive on its own, no fusion)."""
    with jax.disable_jit():
        out = fn()
    return np.asarray(jax.device_get(out))


def _same_bits(got, want, dtype):
    """got (torch) and want (numpy) hold the same values in `dtype`, NaN
    for NaN."""
    assert got.dtype == dtype, got.dtype
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    both_nan = np.isnan(g) & np.isnan(w)
    ne = ~((g == w) | both_nan) | (np.signbit(g) != np.signbit(w)) & ~both_nan
    assert not ne.any(), (f"{int(ne.sum())} of {ne.size} values differ, "
                          f"first at {np.argwhere(ne)[0]}: {g[ne][:4]} vs "
                          f"{w[ne][:4]}")


# ---- (a) the four half cores against the JAX cores, op by op --------------

@pytest.mark.parametrize("levels", [255, 1023])
@pytest.mark.parametrize("seed", [0, 1])
def test_easu_core_half_bit_equal(levels, seed):
    """ops/easu.py::easu_core(dt=bf16) equals the JAX easu_core_split at
    dt=bfloat16 (exact_div off, as in the JAX half kernel) value for value:
    an f32 result, from bf16 taps and fractions."""
    rng = np.random.default_rng(seed)
    taps = {off: _texels(rng, (3, *SHAPE), levels) for off in JEASU.TAP_ORDER}
    ppx = _fractions(rng, (1, SHAPE[1]))
    ppy = _fractions(rng, (SHAPE[0], 1))
    want = _jax_bf16(lambda: jnp.stack(JEASU.easu_core_split(
        {k: [jnp.asarray(p) for p in v] for k, v in taps.items()},
        jnp.asarray(ppx), jnp.asarray(ppy), dt=BF16, exact_div=False)))
    got = TEASU.easu_core({k: torch.from_numpy(v) for k, v in taps.items()},
                          torch.from_numpy(ppx), torch.from_numpy(ppy),
                          dt=HALF)
    _same_bits(got, want, torch.float32)


@pytest.mark.parametrize("levels", [255, 1023])
@pytest.mark.parametrize("sharpness", [0.0, 0.9, 1.0])
def test_rcas_core_half_bit_equal(levels, sharpness):
    """ops/rcas.py::rcas_core(dt=bf16) equals the JAX rcas_core at
    dt=bfloat16: a bf16 result, NaN-free inputs (the flat runs divide by
    zero inside, as in the full core)."""
    from openvr_fsr_tpu_torch.core import constants as C
    rng = np.random.default_rng(levels)
    b, d, e, f, h = (_texels(rng, (3, *SHAPE), levels) for _ in range(5))
    sharp = C.fsr_rcas_con(C.rcas_stops_from_slider(sharpness))
    want = _jax_bf16(lambda: JRCAS.rcas_core(
        *(jnp.asarray(x) for x in (b, d, e, f, h)), sharp, dt=BF16))
    got = TRCAS.rcas_core(*(torch.from_numpy(x) for x in (b, d, e, f, h)),
                          sharp, dt=HALF)
    _same_bits(got, want, torch.bfloat16)


@pytest.mark.parametrize("levels", [255, 1023])
@pytest.mark.parametrize("mcd", [1.0, 0.05])
def test_cas_core_half_bit_equal(levels, mcd):
    """ops/cas.py::cas_core(dt=bf16) equals the JAX cas_core at
    dt=bfloat16, the maxColorDelta clamp in bf16: a bf16 result. Both are
    given the same f32 setup constant (the port's cas_setup)."""
    rng = np.random.default_rng(levels + 7)
    taps = {(dy, dx): _texels(rng, (3, *SHAPE), levels)
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)}
    sharp = TCAS.cas_setup(0.8)
    want = _jax_bf16(lambda: JCAS.cas_core(
        {k: jnp.asarray(v) for k, v in taps.items()}, sharp, mcd, dt=BF16))
    got = TCAS.cas_core({k: torch.from_numpy(v) for k, v in taps.items()},
                        sharp, mcd, dt=HALF)
    _same_bits(got, want, torch.bfloat16)


@pytest.mark.parametrize("levels", [255, 1023])
@pytest.mark.parametrize("sharpness", [0.0, 0.8])
def test_cas_upscale_core_half_bit_equal(levels, sharpness):
    """ops/cas.py::cas_upscale_core(dt=bf16) equals the JAX
    cas_upscale_core at dt=bfloat16: a bf16 result."""
    rng = np.random.default_rng(levels + 11)
    taps = {off: _texels(rng, (3, *SHAPE), levels)
            for off in TCAS.CAS_USED_TAPS}
    ppx = _fractions(rng, (1, SHAPE[1]))
    ppy = _fractions(rng, (SHAPE[0], 1))
    sharp = TCAS.cas_setup(sharpness)
    want = _jax_bf16(lambda: JCAS.cas_upscale_core(
        {k: jnp.asarray(v) for k, v in taps.items()}, jnp.asarray(ppx),
        jnp.asarray(ppy), sharp, dt=BF16))
    got = TCAS.cas_upscale_core(
        {k: torch.from_numpy(v) for k, v in taps.items()},
        torch.from_numpy(ppx), torch.from_numpy(ppy), sharp, dt=HALF)
    _same_bits(got, want, torch.bfloat16)


# ---- (b)-(d) the plain half pipelines ----------------------------------------

# the five FSR and CAS paths of tools/bench_paths.py::PATHS
PATHS = {"fsr_fused": dict(render_scale=0.75),
         "fsr_supersample": dict(render_scale=1.3),
         "rcas_only": dict(render_scale=1.0),
         "cas_upscale": dict(render_scale=0.75, use_cas=True),
         "cas_sharpen": dict(render_scale=1.0, use_cas=True)}
RADII = ((0.5, False), (2.0, False), (0.0, True))   # (radius, debug)
# one 10-bit case per kernel (B1, B2, B5, B6), at radius 0.5
TEN_BIT = ("fsr_fused", "rcas_only", "cas_upscale", "cas_sharpen")


def _case_config(path, radius, debug):
    return dict(enabled=True, sharpness=0.8 if "cas" in path else 0.9,
                radius=radius, debug_mode=debug, **PATHS[path])


CASES = {f"{p} r{r}{' debug' if d else ''}": (_case_config(p, r, d), 8)
         for p in PATHS for r, d in RADII}
CASES.update({f"{p} r0.5 10-bit": (_case_config(p, 0.5, False), 10)
              for p in TEN_BIT})


def _frames():
    """{8: (2, 48, 56, 4) uint8 zone plate + noise, alpha not all 255;
    10: the same widened to R10G10B10A2 (v to v * 4 + v // 64, bench.py's
    ring_frames), alpha in {0..3}}."""
    from openvr_fsr_tpu_torch.utils import frames as FR
    rng = np.random.default_rng(14)
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
for name, (kw, bits) in cases.items():
    pipe = J.Pipeline(J.Config(**kw), color_bits=bits,
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
    tmp = tmp_path_factory.mktemp("jax_half")
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
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-4000:]
        with np.load(tmp / f"{flags}.npz") as z:
            out[flags] = {k: z[k] for k in z.files}
    return out


@pytest.fixture(scope="module")
def port_out():
    """{(case, precision): the port's plain version's output} on the CPU."""
    frames = _frames()
    out = {}
    for name, (kw, bits) in CASES.items():
        for prec in ("half", "full"):
            pipe = T.Pipeline(T.Config(**kw), color_bits=bits,
                              precision=prec, device="cpu")
            out[name, prec] = pipe.process(frames[bits], eyes=(0, 1)).numpy()
    return out


def _diff(a, b):
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


@pytest.mark.parametrize("case", list(CASES))
def test_half_pipeline_per_op(case, jax_half, port_out):
    """Each plain half pipeline is within 1 LSB of the JAX package's Pallas
    kernels (interpret mode) run with --xla_allow_excess_precision=false,
    alpha included. Unequal values are isolated rounding boundaries that
    the compiled f32 parts (the bilinear fallback, the UNORM round trip,
    the approximations' f32 arithmetic) flip, as in the full-precision
    tier: at most 0.1% (measured at most 0.037%, FSR and CAS upscale; 0
    in the sharpen-only paths)."""
    got, want = port_out[case, "half"], jax_half["per_op"][case]
    assert got.shape == want.shape and got.dtype == want.dtype
    d = _diff(got, want)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 0.001, (d > 0).mean()


@pytest.mark.parametrize("case", list(CASES))
def test_half_pipeline_default_flags(case, jax_half, port_out):
    """Against the same JAX kernels under the default XLA flags, whose
    fusions skip bf16 round trips (xla_allow_excess_precision): the tier
    measured on these cases, in 8-bit LSB (a 10-bit LSB is a quarter):
    at most 8 LSB (measured 8, at FSR radius 2.0; 6.75 at 10 bits), and at
    most 15% of the values more than 1 LSB apart (measured 12.3%, the
    same case)."""
    got, want = port_out[case, "half"], jax_half["default"][case]
    assert got.shape == want.shape and got.dtype == want.dtype
    d = _diff(got, want) / (4.0 if CASES[case][1] == 10 else 1.0)
    assert d.max() <= 8, d.max()
    assert (d > 1).mean() <= 0.15, (d > 1).mean()


@pytest.mark.parametrize("case", list(CASES))
def test_half_against_full(case, port_out):
    """Half against full precision in the port, at the JAX suite's bar for
    half (tests/test_kernels_fsr.py::test_half_precision_mode,
    tests/test_cas.py::test_half_precision_bounded): at least 95% of the
    values within 2 LSB, none above 32, in 8-bit LSB."""
    half, full = port_out[case, "half"], port_out[case, "full"]
    d = _diff(half, full) / (4.0 if CASES[case][1] == 10 else 1.0)
    print(f"{case}: half vs full: max {d.max()} LSB, within 2 LSB "
          f"{(d <= 2).mean():.4f}")
    assert (d <= 2).mean() >= 0.95 and d.max() <= 32


# ---- (e) plumbing -------------------------------------------------------------

def _stereo():
    return _frames()[8]


@pytest.mark.parametrize("sharded", [False, True])
def test_cache_key_holds_precision(sharded):
    """Pipeline.process's and ShardedPipeline.process's build keys hold the
    precision (the JAX package's keys, tests/test_sharding.py::
    test_cache_respecializes_on_mutation): switching it builds again, with
    the other precision's output."""
    pipe = T.Pipeline(T.Config(enabled=True, render_scale=0.75, radius=2.0),
                      device="cpu")
    cpu = torch.device("cpu")
    run = (ShardedPipeline(pipe, [cpu, cpu]).process if sharded
           else pipe.process)

    def out(x):
        return torch.cat(x) if sharded else x
    frames = np.concatenate([_stereo()] * (2 if sharded else 1))
    full = out(run(frames))
    out(run(frames))
    assert len(pipe._cache) == 1
    pipe.precision = "half"
    half = out(run(frames))
    assert len(pipe._cache) == 2 and not torch.equal(full, half)
    assert torch.equal(half, T.Pipeline(pipe.config, precision="half",
                                        device="cpu").process(frames))
    pipe.precision = "full"
    assert torch.equal(out(run(frames)), full) and len(pipe._cache) == 2
    assert {("full" in k, "half" in k) for k in pipe._cache} == {
        (True, False), (False, True)}


def test_builds_publish_their_precision():
    """Each of the four kernels' builds takes precision and publishes it; the
    upscale() entry point passes it on."""
    pipe = T.Pipeline(T.Config(enabled=True, render_scale=0.75,
                               sharpness=0.9, radius=0.5),
                      precision="half", device="cpu")
    frames = _stereo()
    got = pipe.process(frames)
    assert [fn.precision for fn in pipe.kernels] == ["half"]
    assert torch.equal(got, T.upscale(frames, render_scale=0.75,
                                      precision="half", device="cpu"))
    for kw in (dict(render_scale=1.0), dict(render_scale=0.75, use_cas=True),
               dict(render_scale=1.0, use_cas=True)):
        pipe = T.Pipeline(T.Config(enabled=True, **kw), precision="half",
                          device="cpu")
        pipe.process(frames)
        assert [fn.precision for fn in pipe.kernels] == ["half"]


@pytest.mark.parametrize("kernel", ["fsr", "cas"])
def test_half_strips_raise(kernel):
    """The JAX package builds its row-band strips at full precision only:
    a half build with band_range raises ValueError."""
    from openvr_fsr_tpu_torch.core import constants as C
    from openvr_fsr_tpu_torch.kernels import cas, fsr
    build = fsr.build_fsr_fused if kernel == "fsr" else cas.build_cas_upscale
    cen = C.centres_payload(74, 64, 0.5, ((0.5, 0.5),) * 2, (0, 1))
    kw = dict(sharpness=0.9, centres=cen, band_rows=32)
    build(2, 48, 56, 74, 64, band_range=(0, 1), **kw)
    with pytest.raises(ValueError, match="strips"):
        build(2, 48, 56, 74, 64, band_range=(0, 1), precision="half", **kw)


@pytest.mark.parametrize("rs", [0.75, 1.0])
def test_nis_half_raises_naming_roadmap(rs):
    """Half on a NIS plan raised naming ROADMAP Queue A 6b until NIS half
    was ported (tests/test_torch_nis_half.py holds it): now it runs at
    construction, through upscale() and at the build after toggle_nis()
    switches a half FSR pipeline to NIS, each time the half build (never
    full precision in its place), with one output."""
    cfg = T.Config(enabled=True, render_scale=rs, use_nis=True, radius=2.0,
                   sharpness=0.9)
    pipe = T.Pipeline(cfg, precision="half", device="cpu")
    want = pipe.process(_stereo())
    assert [fn.precision for fn in pipe.kernels] == ["half"]
    assert not torch.equal(want, T.Pipeline(cfg, device="cpu").process(
        _stereo()))
    assert torch.equal(T.upscale(_stereo(), render_scale=rs, use_nis=True,
                                 radius=2.0, precision="half", device="cpu"),
                       want)
    pipe = T.Pipeline(cfg.with_(use_nis=False), precision="half",
                      device="cpu")
    pipe.process(_stereo())
    pipe.toggle_nis()
    assert torch.equal(pipe.process(_stereo()), want)
    assert [fn.precision for fn in pipe.kernels] == ["half"]


@pytest.mark.parametrize("precision", ["fp16", "bf16", None, "HALF"])
def test_unknown_precision_raises(precision):
    with pytest.raises(ValueError, match="precision"):
        T.Pipeline(T.Config(enabled=True), precision=precision, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        T.FsrModel(precision=precision, device="cpu")


# ---- the CUDA half instantiations' entry points (driven without a card) -------

# kernel -> (its Pipeline plan, its wrapper module and entry-point getter)
HALF_KERNELS = {
    "fsr_fused": (dict(render_scale=0.75), "fsr", "_launch_fn"),
    "rcas_sharpen": (dict(render_scale=1.0), "rcas", "_launch_fn"),
    "cas_upscale": (dict(render_scale=0.75, use_cas=True), "cas",
                    "_upscale_launch_fn"),
    "cas_sharpen": (dict(render_scale=1.0, use_cas=True), "cas",
                    "_sharpen_launch_fn"),
}


def _prototype(kernel, entry):
    import re
    from openvr_fsr_tpu_torch.kernels import _build
    text = (_build.CSRC / f"{kernel}.cu").read_text()
    (params,) = re.findall(rf'extern "C" int {entry}\((.*?)\)\s*\{{', text,
                           re.S)
    return [" ".join(p.split()).rsplit(" ", 1)[0].replace(" *", "*")
            for p in params.split(",")]


@pytest.mark.parametrize("kernel", list(HALF_KERNELS))
def test_half_entry_points_share_the_prototype(kernel):
    """Each source exports <kernel>_launch_h, _launch10_h, _occupancy_h
    and _occupancy10_h with the full entry points' parameters, so one
    argtypes list binds all."""
    for entry in ("launch", "occupancy"):
        want = _prototype(kernel, f"{kernel}_{entry}")
        for suffix in ("_h", "10_h"):
            assert _prototype(kernel, f"{kernel}_{entry}{suffix}") == want


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("kernel", list(HALF_KERNELS))
def test_launch_takes_the_half_entry(kernel, bits, monkeypatch):
    """On a CUDA tensor a half build would call the half entry point of its
    texel format, with the sharpness (and CAS sharpen's maxColorDelta)
    rounded to bf16 on the host: driven here through the launch closure
    with the entry point swapped."""
    import importlib
    from openvr_fsr_tpu_torch.ops.common import lit
    plan, module, getter = HALF_KERNELS[kernel]
    module = importlib.import_module(f"openvr_fsr_tpu_torch.kernels.{module}")
    asked, seen = [], {}

    def entry(*args):
        seen["args"] = args
        return 0

    def get(*args):
        asked.append(args)
        return entry
    monkeypatch.setattr(module, getter, get)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "S", (), {"cuda_stream": 0})())
    pipe = T.Pipeline(T.Config(enabled=True, sharpness=0.9, **plan),
                      color_bits=bits, precision="half",
                      cas_max_color_delta=0.05, device="cpu")
    fn = pipe._build(2, 45, 61, (0, 1), False).kernel
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    x = (torch.zeros((2, 45, 61, 4), dtype=torch.uint16) if bits == 10
         else torch.zeros((2, 45, 61), dtype=torch.int32))
    out, err = cells["launch"](x)
    assert err == 0 and asked == [(bits, "half")] and fn.launches == 0
    floats = [a for a in seen["args"] if isinstance(a, float)]
    if kernel.startswith("cas"):
        from openvr_fsr_tpu_torch.ops.cas import cas_setup
        sharp = cas_setup(0.9)
    else:
        from openvr_fsr_tpu_torch.core import constants as C
        sharp = C.fsr_rcas_con(C.rcas_stops_from_slider(0.9))
    assert lit(sharp, HALF) != float(sharp)      # the rounding shows
    assert floats[0] == lit(sharp, HALF)
    if kernel == "cas_sharpen":
        assert floats[1] == lit(0.05, HALF) != float(np.float32(0.05))


def test_occupancy_names_the_half_entry(monkeypatch):
    """occupancy(name, bits, "half") asks <name>_occupancy_h and
    <name>_occupancy10_h."""
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
    _common.occupancy("fsr_fused", 8, "half")
    _common.occupancy("cas_sharpen", 10, "half")
    assert names == ["fsr_fused_occupancy_h", "cas_sharpen_occupancy10_h"]


# ---- tools/half_bench.py -----------------------------------------------------

def test_half_bench_refuses_without_a_gpu(capsys):
    """No CUDA GPU: one error line per path, value null, exit code 1."""
    from openvr_fsr_tpu_torch.tools import half_bench
    with pytest.raises(SystemExit) as e:
        half_bench.main(["--paths", "fsr_fused,cas_sharpen"])
    assert e.value.code == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["value"] for x in lines] == [None, None]
    assert all("GPU" in x["error"] for x in lines)


class _Kernel:
    """A stand-in kernel function: fn(x), fn.pad_to."""

    def __init__(self, f):
        self.f, self.pad_to = f, (8, 8)

    def __call__(self, x):
        return self.f(x)


def test_half_bench_records(monkeypatch, capsys):
    """Each path, NIS included (it waited for ROADMAP Queue A 6b until NIS
    half was ported), is measured at both precisions (bench.measure's
    precision); the line holds both, their ratios and half against full
    over the RGB bytes of the first ring frame."""
    import types
    from openvr_fsr_tpu_torch import bench
    from openvr_fsr_tpu_torch.tools import half_bench
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2**31, (2, 8, 8), dtype=np.int64).astype(np.int32))
    calls = []

    def measure(config, h, w, *, iters, precision):
        calls.append((h, w, iters, precision))
        # the half "kernel" adds 1 to every red byte (wrapping)
        kernel = _Kernel((lambda x: x) if precision == "full" else
                         (lambda x: (x & ~255) | ((x + 1) & 255)))
        ms = 0.2 if precision == "full" else 0.3
        return bench.PathRun(kernel, types.SimpleNamespace(hbm_bytes=1),
                             ms + 0.01, ms, 0.05, 1.0, 8, 8)

    monkeypatch.setattr(bench, "measure", measure)
    monkeypatch.setattr(bench, "require_gpu", lambda metrics: None)
    monkeypatch.setattr(bench, "card", lambda: "NVIDIA H100, 700.00 W")
    monkeypatch.setattr(bench, "ring_frames", lambda h, w, pad, dev: [frame])
    results = half_bench.main(["--paths", "rcas_only,nvsharpen", "--iters",
                               "3"])
    out = capsys.readouterr()
    lines = [json.loads(x) for x in out.out.splitlines()]
    assert "Queue A 6b" not in out.err
    assert list(results) == ["rcas_only", "nvsharpen"]
    assert [x["path"] for x in lines] == ["rcas_only", "nvsharpen"]
    assert [c[2:] for c in calls] == [(3, "full"), (3, "half")] * 2
    line = lines[0]
    assert line["full"]["device_ms"] == 0.2 and line["half"]["device_ms"] == 0.3
    assert line["half_over_full_device"] == 0.3 / 0.2
    assert line["half"]["vs_sol"] == 0.05 / 0.3
    d = np.abs(((frame.numpy() & 255) + 1) % 256 - (frame.numpy() & 255))
    assert line["max_lsb"] == d.max()
    assert line["mean_lsb"] == pytest.approx(d.mean() / 3)
    assert line["psnr_db"] == pytest.approx(
        10 * np.log10(255.0 ** 2 / ((d.astype(float) ** 2).mean() / 3)))
    assert line["device"] == "NVIDIA H100, 700.00 W"


@pytest.mark.parametrize("kernel", list(HALF_KERNELS))
def test_half_ops_in_issue_slots(kernel):
    """tools/vpu_audit.py prices a half core's ops in FP32 issue slots, a
    bf16 op one half (packed bf16x2): the inside path's count lies between
    half and all of the full core's, the fallback (f32 in both) is the
    full one's; the NIS kernels, which raised a ValueError naming ROADMAP
    Queue A 6b until NIS half was ported, have a half count the same way
    (tests/test_torch_nis_half.py::test_nis_half_ops_in_issue_slots)."""
    from openvr_fsr_tpu_torch.tools import vpu_audit
    full = vpu_audit.path_ops(kernel)
    half = vpu_audit.path_ops(kernel, precision="half")
    assert full[0] / 2 <= half[0] < full[0] and half[1] == full[1]
    nis_full = vpu_audit.path_ops("nis_sharpen")
    nis_half = vpu_audit.path_ops("nis_sharpen", precision="half")
    assert nis_full[0] / 2 <= nis_half[0] < nis_full[0]
