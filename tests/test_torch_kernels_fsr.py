"""The fused FSR kernel module on the CPU: its plain version against the
NumPy pipeline oracle (bit-exact) and the JAX Pallas kernel in interpret
mode (within tolerance), its host tables, and its input checks.

The CUDA kernel itself runs only on the card: `python3 chip_smoke.py`
holds it against this plain version there, texel for texel.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu.core import constants as JC  # noqa: E402
from openvr_fsr_tpu.core import foveation as JF  # noqa: E402
from openvr_fsr_tpu.oracle.pipeline import pipeline_oracle  # noqa: E402
from openvr_fsr_tpu.utils import frames as JFR  # noqa: E402

from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.kernels import _build  # noqa: E402
from openvr_fsr_tpu_torch.kernels._maps import (FSR_TILE, IN_TILE,  # noqa: E402
                                                fsr_maps)
from openvr_fsr_tpu_torch.kernels.fsr import (build_fsr_fused,  # noqa: E402
                                              circle_mask)

CENTERS = ((0.5, 0.5), (0.5, 0.5))


def _out_size(h, w, rs):
    return (int(w / rs), int(h / rs)) if rs < 1 else (int(w * rs), int(h * rs))


def _frames(h, w, kind="zone"):
    if kind == "zone":
        return np.stack([JFR.zone_plate_frame(h, w),
                         JFR.noise_frame(h, w, seed=3)])
    rng = np.random.default_rng(h * w)
    return rng.integers(0, 256, (2, h, w, 4)).astype(np.uint8)


def _packed(frames):
    return np.ascontiguousarray(frames).view(np.int32)[..., 0]


def _build_for(h, w, rs, radius, debug=False, sharpness=0.9):
    ow, oh = _out_size(h, w, rs)
    cen = C.centres_payload(ow, oh, radius, CENTERS, (0, 1))
    return build_fsr_fused(2, h, w, ow, oh, sharpness=sharpness, centres=cen,
                           debug=debug)


def _run(fn, frames):
    out = fn(torch.from_numpy(_packed(frames)))
    return out.numpy().view(np.uint8).reshape(out.shape + (4,))


# (in_h, in_w, rs, radius, debug, frames): radius 0.5 / 2.0 / 0.0, debug,
# supersample, at the three test sizes
CASES = [
    (96, 128, 0.75, 0.5, False, "zone"),
    (96, 128, 0.75, 2.0, False, "zone"),
    (96, 128, 0.75, 0.0, False, "noise"),
    (48, 56, 0.75, 0.3, True, "zone"),
    (64, 72, 1.3, 0.5, False, "noise"),
    (64, 72, 1.3, 2.0, True, "zone"),
]


class TestAgainstOracle:
    @pytest.mark.parametrize("h,w,rs,radius,debug,kind", CASES)
    def test_bit_exact(self, h, w, rs, radius, debug, kind):
        frames = _frames(h, w, kind)
        got = _run(_build_for(h, w, rs, radius, debug), frames)
        want = np.stack([pipeline_oracle(frames[i], rs, 0.9, radius=radius,
                                         debug=debug, eye=i)
                         for i in range(2)])
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("value", [0, 137, 255])
    def test_flat_fields_bit_exact(self, value):
        """Flat fields divide by zero inside RCAS (NaN limiters)."""
        frames = np.full((2, 48, 56, 4), value, np.uint8)
        got = _run(_build_for(48, 56, 0.75, 0.5), frames)
        want = np.stack([pipeline_oracle(frames[i], 0.75, 0.9, radius=0.5,
                                         eye=i) for i in range(2)])
        assert np.array_equal(got, want)


class TestAgainstPallasInterpret:
    """The JAX package's Pallas kernel in interpret mode, as its own CPU
    tests run it; XLA:CPU contracts FMAs, so the bar is its quantized tier."""

    @pytest.mark.parametrize("h,w,rs,radius,debug", [
        (96, 128, 0.75, 0.5, False), (64, 72, 1.3, 2.0, True)])
    def test_close(self, h, w, rs, radius, debug):
        from openvr_fsr_tpu.kernels.fsr import build_fsr_fused as jax_build
        ow, oh = _out_size(h, w, rs)
        cen = JC.centres_payload(ow, oh, radius, CENTERS, (0, 1))
        frames = _frames(h, w)
        jfn = jax_build(2, h, w, ow, oh, sharpness=0.9, centres=cen,
                        debug=debug, interpret=True)
        ref = np.asarray(jfn(_packed(frames).view(np.uint32)))
        got = _run(_build_for(h, w, rs, radius, debug), frames)
        d = np.abs(got.astype(int) - ref.view(np.uint8).reshape(got.shape))
        assert (d == 0).mean() >= 0.999 and d.max() <= 2


class TestBuild:
    def test_ring_pitch_reads_in_place(self):
        assert _build_for(96, 128, 0.75, 0.5).pad_to == (96, 128)
        fn = _build_for(93, 131, 0.75, 0.5)
        frames = _frames(93, 131)
        hp, wp = fn.pad_to
        assert (hp, wp) == (96, 256)
        ring = np.zeros((2, hp, wp), np.int32)
        ring[:, :93, :131] = _packed(frames)
        a = fn(torch.from_numpy(_packed(frames)))
        b = fn(torch.from_numpy(ring))
        assert torch.equal(a, b)

    def test_cpu_never_counts_a_launch(self):
        fn = _build_for(48, 56, 0.75, 0.5)
        fn(torch.from_numpy(_packed(_frames(48, 56))))
        assert fn.launches == 0
        assert torch.equal(fn(torch.from_numpy(_packed(_frames(48, 56)))),
                           fn.reference(torch.from_numpy(
                               _packed(_frames(48, 56)))))

    @pytest.mark.parametrize("bad,err", [
        (lambda x: x.to(torch.int64), TypeError),
        (lambda x: x.numpy(), TypeError),
        (lambda x: x[:, :, :-1].contiguous(), ValueError),
        (lambda x: x[:1], ValueError),
        (lambda x: x.transpose(1, 2).contiguous().transpose(1, 2),
         ValueError),
        (lambda x: x.to("meta"), ValueError),
    ])
    def test_rejects_what_the_kernel_does_not_take(self, bad, err):
        fn = _build_for(48, 56, 0.75, 0.5)
        with pytest.raises(err):
            fn(bad(torch.from_numpy(_packed(_frames(48, 56)))))

    def test_no_nvcc_raises(self, monkeypatch):
        monkeypatch.setenv("PATH", "")
        import torch.utils.cpp_extension as ext
        monkeypatch.setattr(ext, "CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc"):
            _build._nvcc()


class TestMaps:
    @pytest.mark.parametrize("h,w,rs", [(96, 128, 0.75), (48, 56, 0.75),
                                        (64, 72, 1.3), (1869, 1683, 0.75),
                                        (100, 100, 0.99), (60, 90, 0.5),
                                        (2492, 2244, 1.3), (1246, 1122, 0.5),
                                        (1470, 1324, 0.59), (1669, 1503, 0.67),
                                        (1918, 1727, 0.77), (45, 61, 0.75)])
    def test_footprints_cover_every_tap(self, h, w, rs):
        """Every texel a tile's pixels (halo included) read lies inside the
        IN_TILE x IN_TILE window the inside kernel stages for that tile, at
        the main path, the supersample, the AMD presets and small shapes."""
        ow, oh = _out_size(h, w, rs)
        m = fsr_maps(1, h, w, ow, oh, np.zeros((1, 5), np.int64))
        for axis_i, origins, n_out, n_in in ((m.col_i, m.tile_x0, ow, w),
                                             (m.row_i, m.tile_y0, oh, h)):
            fi, b0 = axis_i
            for t, o in enumerate(origins):
                lo = max(t * FSR_TILE - 1, 0)
                hi = min(t * FSR_TILE + FSR_TILE, n_out - 1)
                idx = np.concatenate([
                    np.clip(fi[lo:hi + 1, None] + np.arange(-1, 3), 0,
                            n_in - 1).ravel(),
                    np.clip(b0[lo:hi + 1, None] + np.arange(0, 2), 0,
                            n_in - 1).ravel()])
                assert idx.min() >= o and idx.max() < o + IN_TILE

    @pytest.mark.parametrize("radius", [0.0, 0.3, 0.5, 2.0])
    @pytest.mark.parametrize("single_eye", [True, False])
    def test_circle_mask_matches_pixel_mask(self, radius, single_eye):
        ow, oh = 170, 128
        cen = C.centres_payload(ow, oh, radius, ((0.45, 0.5), (0.56, 0.47)),
                                (0, 1), single_eye)
        got = circle_mask(torch.from_numpy(cen), oh, ow).numpy()
        for b in range(2):
            want = JF.pixel_mask(ow, oh, JF.TILE_FSR,
                                 ((cen[b, 0], cen[b, 1]),
                                  (cen[b, 2], cen[b, 3])), int(cen[b, 4]))
            assert np.array_equal(got[b], want)


# the foveation tables of the redesigned kernel: (in_h, in_w, rs) at the
# main path, the supersample, the AMD presets at the headset's output, and
# small shapes; (radius, eyes) centred and off-centre
TABLE_SHAPES = [(1869, 1683, 0.75), (2492, 2244, 1.3), (1246, 1122, 0.5),
                (1470, 1324, 0.59), (1669, 1503, 0.67), (1918, 1727, 0.77),
                (96, 128, 0.75), (45, 61, 0.75), (64, 72, 1.3)]
TABLE_CIRCLES = [(0.0, CENTERS), (0.3, ((0.3, 0.6), (0.7, 0.4))),
                 (0.5, CENTERS), (2.0, CENTERS)]


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("radius,eyes", TABLE_CIRCLES,
                         ids=[f"r{r}" for r, _ in TABLE_CIRCLES])
@pytest.mark.parametrize("h,w,rs", TABLE_SHAPES,
                         ids=[f"{w}x{h}-rs{rs}" for h, w, rs in TABLE_SHAPES])
def test_foveation_tables(h, w, rs, radius, eyes, batch):
    """The host's class table and tile lists (kernels/_maps.py::fsr_maps):
    the class bits are the reference's circle test sampled per 16x16
    group; the inside and outside lists partition the 32x32 tiles, a tile
    inside where any of its outputs is; every tile's window fits its cap
    and holds its haloed outputs' taps before their edge clamp (the kernel
    stages windows edge-clamped)."""
    ow, oh = _out_size(h, w, rs)
    cen = C.centres_payload(ow, oh, radius, eyes,
                            tuple(i % 2 for i in range(batch)))
    m = fsr_maps(batch, h, w, ow, oh, cen)
    mask = circle_mask(torch.from_numpy(cen), oh, ow).numpy()
    assert m.group_cls.dtype == np.int32
    assert np.array_equal(m.group_cls, mask[:, ::16, ::16].astype(np.int32))
    ty, tx = -(-oh // FSR_TILE), -(-ow // FSR_TILE)
    pad = np.zeros((batch, ty * FSR_TILE, tx * FSR_TILE), bool)
    pad[:, :oh, :ow] = mask
    any_inside = pad.reshape(batch, ty, FSR_TILE, tx, FSR_TILE).any(
        axis=(2, 4)).ravel()
    ids = np.arange(batch * ty * tx)
    assert m.inside_tiles.dtype == m.outside_tiles.dtype == np.int32
    assert np.array_equal(m.inside_tiles, ids[any_inside])
    assert np.array_equal(m.outside_tiles, ids[~any_inside])
    assert np.array_equal(m.tile_inside.ravel(), any_inside)
    for (fi, b0), origins, n_out, n_in in ((m.col_i, m.tile_x0, ow, w),
                                           (m.row_i, m.tile_y0, oh, h)):
        out = np.arange(n_out)
        first = np.maximum(out // FSR_TILE * FSR_TILE - 1, 0)
        last = np.minimum(out // FSR_TILE * FSR_TILE + FSR_TILE, n_out - 1)
        taps = np.concatenate([fi[:, None] + np.arange(-1, 3),
                               b0[:, None] + np.arange(2)], axis=1)
        lo, hi = taps.min(axis=1), taps.max(axis=1)
        assert lo.min() >= -2 and hi.max() <= n_in + 1
        for t, o in enumerate(origins):
            seg = slice(first[t * FSR_TILE], last[t * FSR_TILE] + 1)
            assert lo[seg].min() >= o and hi[seg].max() < o + IN_TILE


def test_ptxas_usage_reads_a_build_log():
    from openvr_fsr_tpu_torch.tools.sass import ptxas_usage
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117fsr_inside_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117fsr_inside_kernelENS_6ParamsE
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 28976 bytes smem, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118fsr_outside_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118fsr_outside_kernelENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, 480 bytes cmem[0]
"""
    u = ptxas_usage(log)
    assert list(u) == ["_ZN12_GLOBAL__N_117fsr_inside_kernelENS_6ParamsE",
                       "_ZN12_GLOBAL__N_118fsr_outside_kernelENS_6ParamsE"]
    assert list(u.values()) == [
        {"registers": 96, "spill_stores": 8, "spill_loads": 12,
         "smem": 28976},
        {"registers": 38, "spill_stores": 0, "spill_loads": 0, "smem": 0}]


def test_ab_tool_without_a_gpu_fails(tmp_path):
    """tools/ab.py: no CUDA GPU, one error line and a non-zero exit,
    before anything is built; jax never imported."""
    import json
    import os
    import subprocess
    import sys
    code = ("import runpy, sys\n"
            "sys.argv = ['ab', '--kernel', 'nis_scaler', '--parent', "
            "'absent.cu']\n"
            "try:\n"
            "    runpy.run_module('openvr_fsr_tpu_torch.tools.ab', "
            "run_name='__main__')\n"
            "finally:\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'openvr_fsr_tpu'))\n"
            "    print('imported:', bad, file=sys.stderr)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=180)
    assert r.returncode != 0 and "imported: []" in r.stderr, r.stderr
    (line,) = r.stdout.splitlines()
    rec = json.loads(line)
    assert rec["metric"] == "ab" and rec["value"] is None
    assert "no CUDA GPU" in rec["error"]


@pytest.mark.parametrize("argv", [
    ["--kernel", "nis_scaler"],
    ["--kernel", "nis_scaler", "--parent", "p.cu", "--ablate", "noslide"],
    ["--kernel", "fsr_fused", "--ablate", "noslide"],
    ["--kernel", "nis_scaler", "--ablate", "nostage"],
], ids=["neither", "both", "fsr-has-none", "not-this-kernels"])
def test_ab_tool_takes_one_comparison(argv, capsys):
    """tools/ab.py compares with an earlier source or with one ablation of
    the current source, one of them, and only the kernel's own ablations;
    it refuses anything else before it looks for a GPU."""
    from openvr_fsr_tpu_torch.tools import ab
    with pytest.raises(SystemExit) as e:
        ab.main(argv)
    assert e.value.code == 2
    assert "no CUDA GPU" not in capsys.readouterr().out


ABLATED = [("cas_sharpen", "noslide"), ("cas_sharpen", "nostage"),
           ("cas_upscale", "noload"),
           ("cas_upscale", "nostage"), ("dma_floor", "nopersist"),
           ("nis_scaler", "noslide"),
           ("nis_sharpen", "noslide"), ("rcas_sharpen", "noslide"),
           ("vmem_rate", "nounroll"), ("vmem_rate", "onegroup"),
           ("vmem_rate", "predicated")]


@pytest.mark.parametrize("kernel,name", ABLATED)
def test_ablations_edit_the_current_source(kernel, name):
    """Each ablation's edits find their text once in csrc/<kernel>.cu (a
    source change that moves it fails here, not on the card), change only
    those lines, and keep the entry point."""
    from openvr_fsr_tpu_torch.kernels import _build
    from openvr_fsr_tpu_torch.tools import ab
    assert sorted((k, n) for k, v in ab.ABLATIONS.items() for n in v) \
        == ABLATED
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    out = ab.ablated_source(kernel, name, src)
    changed = [(a, b) for a, b in zip(src.splitlines(), out.splitlines())
               if a != b]
    edits = ab.ABLATIONS[kernel][name][1]
    assert len(out.splitlines()) == len(src.splitlines())
    assert len(changed) == len(edits)
    for (old, new), (a, b) in zip(edits, changed):
        assert old in a and new in b
    assert f"{kernel}_launch" in out
    with pytest.raises(ValueError, match="occurs 2 times"):
        ab.ablated_source(kernel, name, src + edits[0][0])


# the entry points of the earlier sources tools/ab.py drives as the parents:
# B1's class kernels before the row-band strips, NVScaler's one CTA per
# 32x24 block, CAS upscale's one CTA per 16x16 tile
PARENT_PROTOTYPES = {
    "fsr_fused": re.sub(r"int in_row_base, |int out_row0, int out_row1, ",
                        "", (_build.CSRC / "fsr_fused.cu").read_text()),
    "nis_scaler": """
extern "C" int nis_scaler_launch(const void* img, void* out, const void* col_i, const void* col_f,
                                 const void* row_i, const void* row_f, const void* tile_x0,
                                 const void* tile_y0, const void* centres, const void* coef,
                                 const float* consts, int n_consts, int batch, int in_h, int in_w,
                                 int rows, int pitch, int out_h, int out_w, int hdr_mode,
                                 float tint, int in_tile_w, int in_tile_h, void* stream) {
""",
    "cas_upscale": """
extern "C" int cas_upscale_launch(const void* img, void* out, const void* col_i,
                                  const void* col_f, const void* row_i, const void* row_f,
                                  const void* tile_x0, const void* tile_y0, const void* centres,
                                  int batch, int in_h, int in_w, int in_rows, int pitch, int out_h,
                                  int out_w, float sharp, float tint, int in_tile, void* stream) {
""",
}


def _parent_call(kernel, h, w, rs, monkeypatch):
    """(the arguments the A/B tool passes to the parent entry point, the
    current build's host tables) at one small shape."""
    from openvr_fsr_tpu_torch.tools import ab
    ow, oh = _out_size(h, w, rs)
    cen = C.centres_payload(ow, oh, 0.5, CENTERS, (0, 1))
    _, maps, kw = ab._build_current(kernel, 2, h, w, ow, oh, cen, 1)
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0
    run = ab.parent_launcher(kernel, entry, maps, 2, torch.device("cpu"),
                             **kw)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "S", (), {"cuda_stream": 0})())
    out = run(torch.zeros((2, h, w), dtype=torch.int32))
    assert out.shape == (2, oh, ow)
    assert len(seen["args"]) == len(ab.entry_argtypes(
        kernel, PARENT_PROTOTYPES[kernel]))
    return seen["args"], maps


def _holds(origins, taps, tile, window):
    """Every tile's window [origin, origin + window) holds its outputs'
    taps (taps: (n_out, k) input indices)."""
    for t, o in enumerate(origins):
        seg = taps[t * tile:(t + 1) * tile]
        assert o <= seg.min() and seg.max() < o + window


def test_parent_tables_are_the_16x16_kernels(monkeypatch):
    """The A/B tool drives the earlier CAS upscale kernel, one CTA per 16x16
    tile, with 20x20 windows that hold each tile's CAS taps and clamped
    bilinear taps."""
    from openvr_fsr_tpu_torch.tools import ab
    h, w = 96, 128
    args, m = _parent_call("cas_upscale", h, w, 0.75, monkeypatch)
    assert args[9:16] == (2, h, w, h, w, m.out_h, m.out_w)
    assert args[18] == ab.CAS_PARENT_WINDOW == 20
    assert ab.CAS_PARENT_TILE == 16
    x0, y0 = ab._parent_origins("cas_upscale", m)
    for (fi, b0), origins, n in ((m.col_i, x0, w), (m.row_i, y0, h)):
        taps = np.concatenate([fi[:, None] + np.arange(-1, 3),
                               np.clip(b0[:, None] + np.arange(2), 0, n - 1)],
                              axis=1)
        _holds(origins, taps, 16, 20)


@pytest.mark.parametrize("h,w,rs", [(96, 128, 0.75), (45, 61, 0.75),
                                    (40, 45, 1.3), (1869, 1683, 0.75)])
@pytest.mark.parametrize("kernel", ["fsr_fused", "nis_scaler"])
def test_parent_tables_hold_the_parent_kernels_taps(kernel, h, w, rs,
                                                    monkeypatch):
    """B1's parent takes the current entry point's arguments; B3's (the
    earlier source: one CTA per 32x24 block) 40x32 luma windows that hold
    each block's 6x6 taps and the 3x3s of its 2x2 edge taps, with the
    hdr_mode asked for."""
    from openvr_fsr_tpu_torch.tools import ab
    args, m = _parent_call(kernel, h, w, rs, monkeypatch)
    if kernel == "fsr_fused":
        assert args[10] == len(m.inside_tiles)
        assert args[12] == len(m.outside_tiles)
        assert args[-3:-1] == (FSR_TILE, IN_TILE)
        return
    assert args[11] == 16 and args[19] == 1          # constants, hdr_mode
    assert args[12:19] == (2, h, w, h, w, m.out_h, m.out_w)
    assert args[21:23] == ab.NIS_PARENT_WINDOW == (40, 32)
    x0, y0 = ab._parent_origins("nis_scaler", m)
    for src, origins, tile, win, n in (
            (m.col_i[0], x0, 32, 40, w), (m.row_i[0], y0, 24, 32, h)):
        taps = np.clip(src[:, None] + np.arange(-2, 4), 0, n - 1)
        edges = np.clip(np.clip(src[:, None] + np.arange(2), 0, n - 1)
                        [..., None] + np.arange(-1, 2), 0, n - 1)
        _holds(origins, taps, tile, win)
        _holds(origins, edges.reshape(len(src), -1), tile, win)
