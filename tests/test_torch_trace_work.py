"""The work each launch publishes (openvr_fsr_tpu_torch/utils/trace.py,
kernels/_common.py::kernel_fn, kernels/_maps.py::launch_work) and the
benchmark's reader of it (benchmark/metrics/inside_roofline.py), on the
CPU: a build's C entry point is stood in for, its launch taken on a tensor
that reports a CUDA device. Under torch.profiler each launch record names
the built function, the CUDA kernels its entry point enqueues and its
outputs inside and outside the circle, as the build's tile lists and the
circle test give them, and the counters add them up; with the profiler off
a launch after the first records and counts nothing."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openvr_fsr_tpu_torch.core import constants as C
from openvr_fsr_tpu_torch.core.foveation import (TILE_FSR, TILE_NIS_SCALER,
                                                 TILE_NIS_SHARPEN)
from openvr_fsr_tpu_torch.kernels import _common, cas, fsr, nis, rcas
from openvr_fsr_tpu_torch.kernels import _maps
from openvr_fsr_tpu_torch.utils import trace
from openvr_fsr_tpu_torch.utils.trace import Record

BENCH_DIR = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from fsrbench import work  # noqa: E402
from fsrbench.spec import Spec  # noqa: E402
from fsrbench.trace import TraceSummary  # noqa: E402

B, IH, IW, OH, OW = 2, 54, 63, 72, 84
CONFIG = "fsr_rs100_r20_2244x2492"
EYES = work.eye_centers(Spec().config(CONFIG))     # the benchmark's eyes
SHARP = 0.9


@pytest.fixture(autouse=True)
def _clear():
    trace.clear()
    yield
    trace.clear()


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: kernel_fn takes its launch
    branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _centres(w, h, radius):
    return C.centres_payload(w, h, radius, EYES, [0, 1])


def _stand_in(monkeypatch):
    """Every build's kernel_fn with its launch closure replaced by a stand-in
    for the C entry point that returns cudaSuccess."""
    real = _common.kernel_fn

    def fake_kernel_fn(name, batch, shape, pad_to, reference, launch, *a,
                       **k):
        return real(name, batch, shape, pad_to, reference,
                    lambda img: (torch.zeros(1, dtype=torch.int32), 0),
                    *a, **k)

    for module in (_common, fsr, rcas, nis, cas):
        monkeypatch.setattr(module, "kernel_fn", fake_kernel_fn)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def _fake_input(h, w):
    return torch.Tensor._make_subclass(
        _FakeCuda, torch.zeros((B, h, w), dtype=torch.int32))


def _inside(centres, h, w, tile, rows=None):
    """Outputs inside the circle, from the plain versions' per-pixel test."""
    m = _common.circle_mask(torch.as_tensor(centres), h, w, tile)
    r0, r1 = rows or (0, h)
    return int(m[:, r0:r1].sum())


def _case(name, radius):
    """(fn, its input's (h, w), expected info) of one build."""
    if name in ("rcas", "cas_sharpen", "nvsharpen"):
        cen = _centres(OW, OH, radius)
        if name == "nvsharpen":
            group = TILE_NIS_SHARPEN
            cfg = C.nvsharpen_update_config(SHARP, OW, OH, OW, OH)
            fn = nis.build_nvsharpen(B, OH, OW, nis_cfg=cfg, centres=cen)
        else:
            group = TILE_FSR
            build = (rcas.build_rcas_sharpen if name == "rcas"
                     else cas.build_cas_sharpen)
            fn = build(B, OH, OW, sharpness=SHARP, centres=cen)
        m = _maps.sharpen_maps(B, OH, OW, cen, group)
        tile, rows, shape = group, None, (OH, OW)
    elif name == "nvscaler":
        cen = _centres(OW, OH, radius)
        cfg = C.nvscaler_update_config(SHARP, IW, IH, IW, IH, OW, OH, OW, OH)
        fn = nis.build_nvscaler(B, IH, IW, OW, OH, nis_cfg=cfg, centres=cen)
        m = _maps.nvscaler_maps(B, IH, IW, OW, OH, cfg, cen)
        tile, rows, shape = TILE_NIS_SCALER, None, (IH, IW)
    else:                       # fsr, fsr_strip, cas_upscale
        cen = _centres(OW, OH, radius)
        kw = dict(sharpness=SHARP, centres=cen)
        if name == "fsr_strip":
            kw.update(band_rows=32, band_range=(1, 2))
        build = (cas.build_cas_upscale if name == "cas_upscale"
                 else fsr.build_fsr_fused)
        fn = build(B, IH, IW, OW, OH, **kw)
        maps = (_maps.cas_upscale_maps if name == "cas_upscale"
                else _maps.fsr_maps)(B, IH, IW, OW, OH, cen)
        rows = (32, 64) if name == "fsr_strip" else None
        m = maps if rows is None else _maps.band_strip(
            maps, rows, _maps.IN_TILE, "clamp")[0]
        tile = TILE_FSR
        shape = (fn.in_rows, IW) if rows else (IH, IW)
    r0, r1 = rows or (0, OH)
    inside = _inside(cen, OH, OW, tile, rows)
    expect = {"fn": NAMES[name], "kernels":
              int(len(m.inside_tiles) > 0) + int(len(m.outside_tiles) > 0),
              "inside": inside, "outside": B * (r1 - r0) * OW - inside}
    if name == "rcas":      # RGBA8 at full precision: every inside output
        expect["levels"] = inside      # on the texels' 256 levels
    if name.startswith("fsr"):  # the texels whose EASU terms B1 computes
        expect["analysed"] = _maps.analysed_texels(m)   # (its inside tiles')
    return fn, shape, expect


NAMES = {"rcas": "RCAS sharpen", "cas_sharpen": "CAS sharpen",
         "nvsharpen": "NVSharpen", "nvscaler": "NVScaler",
         "fsr": "fused FSR", "fsr_strip": "fused FSR strip",
         "cas_upscale": "CAS upscale"}
CASES = [("rcas", 2.0, 1), ("rcas", 0.5, 2), ("fsr", 2.0, 1),
         ("fsr", 0.5, 2), ("nvscaler", 0.5, 2), ("nvscaler", 2.0, 1),
         ("nvsharpen", 0.5, 2), ("cas_sharpen", 0.5, 2),
         ("cas_upscale", 0.5, 2), ("fsr_strip", 0.5, 2)]


@pytest.mark.parametrize("name,radius,kernels", CASES)
def test_launch_records_name_kernels_and_outputs(monkeypatch, name, radius,
                                                 kernels):
    _stand_in(monkeypatch)
    fn, shape, expect = _case(name, radius)
    assert expect["kernels"] == kernels
    if kernels == 1 and name != "fsr_strip":
        assert expect["outside"] == 0          # radius 2.0: all inside
    else:
        assert 0 < expect["inside"] and 0 < expect["outside"]
    img = _fake_input(*shape)
    fn(img)                                    # the first, cold launch
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("process"):
            fn(img)
        with trace.span("process"):
            fn(img)
    recs = trace.records()
    assert [r.name for r in recs] == ["launch", "process", "launch",
                                      "process", "launch"]
    for r in recs[::2]:
        assert r.info == expect
    n = trace.counters()
    assert n["launches"] == 3 == fn.launches
    assert n["kernels"] == 3 * expect["kernels"]
    assert n["inside_outputs"] == 3 * expect["inside"]
    assert n["outside_outputs"] == 3 * expect["outside"]


def test_off_launches_record_and_count_nothing(monkeypatch):
    _stand_in(monkeypatch)
    fn, shape, expect = _case("rcas", 0.5)
    img = _fake_input(*shape)
    fn(img)                                    # cold: records whatever
    recs, counts = trace.records(), trace.counters()
    assert [r.name for r in recs] == ["launch"] and recs[0].cold
    assert recs[0].info["inside"] == expect["inside"]
    for _ in range(5):
        fn(img)
    assert fn.launches == 6
    assert trace.records() == recs and trace.counters() == counts


def test_launch_work_counts_the_groups_of_a_band():
    cls = np.array([[[1, 0, 0], [0, 1, 1]]], bool)      # (1, GY 2, GX 3)
    w = _maps.launch_work(cls, (16, 16), 20, 40, 3, 0)
    # row 0..15: group 0 (16 px); rows 16..19: groups 1, 2 (16 + 8 px)
    assert w == {"kernels": 1, "inside": 16 * 16 + 4 * 24,
                 "outside": 20 * 40 - 16 * 16 - 4 * 24}
    assert _maps.launch_work(cls, (16, 16), 20, 40, 3, 5, (10, 18))[
        "inside"] == 6 * 16 + 2 * 24


# ---------------------------------------------------------------- the reader

KERNEL = "void (anonymous namespace)::rcas_sharpen_inside_kernel<x>(p)"


def _reader_ctx(radius, per_call_us=120.0, calls=2):
    config = dict(Spec().config(CONFIG), radius=radius)
    w = work.pair_work(config)
    kernels = [(KERNEL, 10.0 * i, per_call_us) for i in range(calls)]
    kernels.append(("void copy_kernel", 5.0, 40.0))          # not inside
    summary = TraceSummary(window_s=1.0, busy_s=0.5, kernels=kernels)
    return SimpleNamespace(trace=summary, window=SimpleNamespace(
        completed=calls), work=w, config=config, least_ms=work.least_ms)


def _records(w, calls=2, inside=None):
    """Set-up's cold launch, then `calls` process calls with a launch each."""
    info = {"fn": "RCAS sharpen", "kernels": 1 + int(w["outside"] > 0),
            "inside": w["inside"] if inside is None else inside,
            "outside": w["outside"]}
    recs = [Record("launch", 0, 5, None, 0, True, dict(info))]
    for i in range(calls):
        recs.append(Record("process", 10 + 10 * i, 18 + 10 * i, None, i + 1,
                           False, {}))
        recs.append(Record("launch", 11 + 10 * i, 15 + 10 * i,
                           len(recs) - 1, i + 1, False, dict(info)))
    return recs


def _counts(recs, **over):
    launches = [r for r in recs if r.name == "launch"]
    n = {"calls": sum(r.name == "process" for r in recs), "builds": 0,
         "launches": len(launches), "dropped": 0,
         "kernels": sum(r.info["kernels"] for r in launches),
         "inside_outputs": sum(r.info["inside"] for r in launches),
         "outside_outputs": sum(r.info["outside"] for r in launches)}
    n.update(over)
    return n


@pytest.fixture
def serve(monkeypatch):
    def serve(recs, counts):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    return serve


READ = Spec().reader("inside_roofline")


@pytest.mark.parametrize("radius", [2.0, 0.5])
def test_inside_roofline_known_value(serve, radius):
    ctx = _reader_ctx(radius)
    recs = _records(ctx.work)
    serve(recs, _counts(recs))
    w = ctx.work
    # each inside output's word written and its input's word read: 8 bytes
    t_bytes = w["inside"] * 8 / 3.35e12 * 1e3
    t_ops = w["inside"] * 92.0 / 67e12 * 1e3
    assert t_bytes > t_ops
    assert READ(ctx) == pytest.approx(100.0 * t_bytes / 0.120, rel=1e-12)
    if radius == 2.0:       # one kernel does the pair's work
        assert READ(ctx) == pytest.approx(
            100.0 * work.least_ms(w)[0] / 0.120, rel=1e-12)


@pytest.mark.parametrize("fault", ["no_counter", "dropped", "open",
                                   "disagrees", "sum", "other_count"])
def test_inside_roofline_none_on_unsound_records(serve, fault):
    ctx = _reader_ctx(2.0)
    recs = _records(ctx.work)
    counts = _counts(recs)
    if fault == "no_counter":         # a program that publishes no work
        for k in ("kernels", "inside_outputs", "outside_outputs"):
            counts.pop(k)
    elif fault == "dropped":
        counts["dropped"] = 1
    elif fault == "open":
        recs[-1].end_ns = None
    elif fault == "disagrees":        # launches against their records
        counts["launches"] += 1
    elif fault == "sum":              # a counter against its records' sum
        counts["inside_outputs"] += 1
    else:                             # the program computed other outputs
        recs = _records(ctx.work, inside=ctx.work["inside"] - 256)
        counts = _counts(recs)
    serve(recs, counts)
    assert READ(ctx) is None


def test_inside_roofline_none_without_inside_kernels(serve):
    ctx = _reader_ctx(2.0)
    ctx.trace.kernels = [k for k in ctx.trace.kernels if KERNEL != k[0]]
    recs = _records(ctx.work)
    serve(recs, _counts(recs))
    assert READ(ctx) is None
