"""The port's parallel/ on the CPU: the row-band strip builds of the fused
FSR kernel (B1) and CAS upscale (B5), their strip tables, the band layouts,
SpatialFsrPipeline over CPU strips and ShardedPipeline over CPU slices.

The strip builds' plain versions are held bit for bit to slices of the full
build and, through SpatialFsrPipeline, to the NumPy oracle; one small case
to the JAX package's strip kernels in interpret mode. The CUDA strips run
only on the card: `python3 chip_smoke.py` (phase 2b) holds them to the
single launch there, and `python3 -m openvr_fsr_tpu_torch.tools.
spatial_onchip` runs the JAX tool's check.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu.kernels import _band as JBD  # noqa: E402
from openvr_fsr_tpu.kernels.cas import cas_band_layout as j_cas_layout  # noqa: E402
from openvr_fsr_tpu.kernels.fsr import build_fsr_fused as j_build_fsr  # noqa: E402
from openvr_fsr_tpu.kernels.fsr import fsr_band_layout as j_fsr_layout  # noqa: E402
from openvr_fsr_tpu.parallel.spatial import split_bands as j_split_bands  # noqa: E402

from openvr_fsr_tpu_torch import (CasModel, Config, FsrModel,  # noqa: E402
                                  NisModel, Pipeline)
from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.kernels import _build  # noqa: E402
from openvr_fsr_tpu_torch.kernels import cas, fsr  # noqa: E402
from openvr_fsr_tpu_torch.kernels._maps import (CAS_IN_TILE, FSR_TILE,  # noqa: E402
                                                IN_TILE, band_strip,
                                                cas_upscale_maps, fsr_maps,
                                                input_padding)
from openvr_fsr_tpu_torch.oracle.pipeline import pipeline_oracle  # noqa: E402
from openvr_fsr_tpu_torch.parallel import (ShardedPipeline,  # noqa: E402
                                           SpatialFsrPipeline, make_mesh,
                                           shard_batch, split_bands)
from openvr_fsr_tpu_torch.tools import ab  # noqa: E402
from openvr_fsr_tpu_torch.utils import frames as FR  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CENTERS = ((0.5, 0.5), (0.5, 0.5))
OFF_CENTRE = ((0.3, 0.6), (0.7, 0.4))
# kernel -> (builder, layout, host maps, staged window rows, window rule)
KERNELS = {
    "fsr_fused": (fsr.build_fsr_fused, fsr.fsr_band_layout, fsr_maps,
                  IN_TILE, "clamp"),
    "cas_upscale": (cas.build_cas_upscale, cas.cas_band_layout,
                    cas_upscale_maps, CAS_IN_TILE, "zero"),
}


def _out_size(h, w, rs):
    return Config(render_scale=rs).output_size(w, h)


def _image(h, w, bits=8, seed=0):
    rng = np.random.default_rng(seed)
    if bits == 10:
        x = rng.integers(0, 1024, (2, h, w, 4)).astype(np.uint16)
        x[..., 3] = rng.integers(0, 4, (2, h, w))
        return torch.from_numpy(x)
    return torch.from_numpy(rng.integers(0, 2**32, (2, h, w),
                                         dtype=np.uint32).view(np.int32))


def _strips(kernel, h, w, rs, radius, band_rows, n, bits=8, debug=False,
            eyes=CENTERS, seed=0):
    """(the full build's output, the concatenated strip outputs, the strip
    builds) on one random frame; n None builds every band alone."""
    build, layout = KERNELS[kernel][:2]
    ow, oh = _out_size(h, w, rs)
    cen = C.centres_payload(ow, oh, radius, eyes, (0, 1))
    kw = dict(sharpness=0.9, centres=cen, color_bits=bits, debug=debug,
              band_rows=band_rows)
    img = _image(h, w, bits, seed)
    want = build(2, h, w, ow, oh, **kw)(img)
    _, gy = layout(ow, oh, band_rows)
    fns, outs = [], []
    for g0, g1 in split_bands(gy, gy if n is None else n):
        fn = build(2, h, w, ow, oh, band_range=(g0, g1), **kw)
        outs.append(fn(img[:, fn.in_row_base:fn.in_row_base + fn.in_rows]
                       .contiguous()))
        fns.append(fn)
    return want, torch.cat(outs, 1), fns


# ---- split_bands and the band layouts ---------------------------------------

def test_split_bands():
    """The JAX cases, and the JAX function over a grid."""
    assert split_bands(8, 3) == [(0, 3), (3, 5), (5, 8)]
    assert split_bands(4, 8) == [(0, 1), (1, 2), (2, 3), (3, 4)]  # capped
    assert split_bands(5, 1) == [(0, 5)]
    for gy, n in ((20, 8), (7, 2), (3, 3)):
        rs = split_bands(gy, n)
        assert rs[0][0] == 0 and rs[-1][1] == gy
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))
    for gy in (1, 2, 5, 20, 78, 104):
        for n in (0, 1, 2, 3, 4, 8, 200):
            assert split_bands(gy, n) == j_split_bands(gy, n)


@pytest.mark.parametrize("kind", ["fsr", "cas"])
def test_band_layouts_are_the_jax_ones(kind):
    """(TH, GY) equal the JAX package's over a grid of output sizes and
    band heights, 7680-wide outputs (the auto-shrink) included."""
    port = fsr.fsr_band_layout if kind == "fsr" else cas.cas_band_layout
    jax_ = j_fsr_layout if kind == "fsr" else j_cas_layout
    shrunk = 0
    for ow in (88, 2244, 2917, 3840, 5760, 7680):
        for oh in (70, 2492, 3239, 4320):
            for br in (8, 24, 32, 64, 128, 256, 512, oh, oh + 5):
                got = port(ow, oh, br)
                assert got == jax_(ow, oh, br), (ow, oh, br)
                shrunk += got[0] < min(br, oh)
    assert shrunk > 0


def test_band_rows_must_be_a_multiple_of_8_or_the_height():
    with pytest.raises(ValueError, match="multiple of 8"):
        fsr.fsr_band_layout(88, 70, 30)
    with pytest.raises(ValueError, match="multiple of 8"):
        cas.cas_band_layout(88, 70, 0)
    assert fsr.fsr_band_layout(88, 70, 75) == (70, 1)


# ---- the strip builds on the plain versions ---------------------------------

# (kernel, in_h, in_w, rs, radius, band_rows, strips, bits, debug, eyes)
STRIP_CASES = [
    ("fsr_fused", 90, 70, 0.75, 0.5, 32, 3, 8, False, CENTERS),
    ("fsr_fused", 90, 70, 0.75, 2.0, 32, 3, 8, False, CENTERS),
    ("fsr_fused", 90, 70, 0.75, 0.3, 32, 3, 8, True, OFF_CENTRE),
    ("fsr_fused", 60, 45, 1.3, 0.5, 32, 3, 8, False, CENTERS),
    ("fsr_fused", 90, 70, 0.75, 0.5, 24, 3, 8, False, CENTERS),
    ("fsr_fused", 90, 70, 0.75, 0.5, 24, 4, 10, False, CENTERS),
    ("cas_upscale", 90, 70, 0.75, 0.5, 32, 3, 8, False, CENTERS),
    ("cas_upscale", 90, 70, 0.75, 2.0, 32, 3, 8, True, CENTERS),
    ("cas_upscale", 90, 70, 0.75, 0.3, 24, 3, 8, False, OFF_CENTRE),
    ("cas_upscale", 90, 70, 0.75, 0.5, 24, 4, 10, False, CENTERS),
]


@pytest.mark.parametrize(
    "kernel,h,w,rs,radius,band_rows,n,bits,debug,eyes", STRIP_CASES)
def test_strips_are_slices_of_the_full_build(kernel, h, w, rs, radius,
                                             band_rows, n, bits, debug,
                                             eyes):
    """The concatenated strips equal the full build bit for bit: radius 0.5
    and 2.0, off-centre eyes and debug, the supersample, 24-row bands
    (edges inside 32-row tiles) and 10 bits."""
    want, got, fns = _strips(kernel, h, w, rs, radius, band_rows, n, bits,
                             debug, eyes)
    assert len(fns) == n
    assert got.dtype == want.dtype and torch.equal(got, want)
    if band_rows == 24:     # a band edge inside a 32-row tile
        assert any(fn.band_range[0] * 24 % FSR_TILE for fn in fns)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_every_band_alone(kernel):
    """Every band of 53x66 -> 70x88 built alone is the full build's rows
    [g * TH, g * TH + out_rows)."""
    want, got, fns = _strips(kernel, 53, 66, 0.75, 0.5, 32, None)
    assert [fn.band_range for fn in fns] == [(0, 1), (1, 2), (2, 3)]
    assert [fn.out_rows for fn in fns] == [32, 32, 6]
    for g, fn in enumerate(fns):
        rows = slice(32 * g, 32 * g + fn.out_rows)
        assert torch.equal(got[:, rows], want[:, rows])
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_strip_takes_the_ring_pitch(kernel):
    """A strip padded to the ring pitch's width is read in place: the same
    bits as the unpadded strip; a strip of another height raises."""
    build, layout = KERNELS[kernel][:2]
    h, w, ow, oh = 90, 70, 93, 120
    cen = C.centres_payload(ow, oh, 0.5, CENTERS, (0, 1))
    fn = build(2, h, w, ow, oh, sharpness=0.9, centres=cen, band_rows=32,
               band_range=(1, 3))
    img = _image(h, w)
    strip = img[:, fn.in_row_base:fn.in_row_base + fn.in_rows].contiguous()
    hp, wp = input_padding(h, w)
    assert fn.pad_to == (fn.in_rows, wp)
    ring = torch.zeros((2, fn.in_rows, wp), dtype=torch.int32)
    ring[:, :, :w] = strip
    assert torch.equal(fn(ring), fn(strip))
    with pytest.raises(ValueError, match="matches neither"):
        fn(img)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_band_build_publishes_the_jax_attributes(kernel):
    """band_range, in_row_base, in_rows and out_rows as the JAX builders
    publish them (the output rows the JAX ones: [g0 * TH, min(g1 * TH,
    OH))), the strip's DMA geometry (its band's out_rows rows over the
    strip's in_rows rows; tests/test_torch_half_strips.py holds it to the
    whole image's), and the refusals."""
    build, layout = KERNELS[kernel][:2]
    h, w = 1869, 1683
    ow, oh = _out_size(h, w, 0.75)
    cen = C.centres_payload(ow, oh, 0.5, CENTERS, (0, 1))
    th, gy = layout(ow, oh)
    assert (th, gy) == (128, 20)
    fns = [build(2, h, w, ow, oh, sharpness=0.9, centres=cen,
                 band_range=r) for r in split_bands(gy, 3)]
    assert [fn.band_range for fn in fns] == [(0, 7), (7, 13), (13, 20)]
    assert [fn.out_rows for fn in fns] == [896, 768, oh - 1664]
    assert [(fn.dma_geometry["in_h"], fn.dma_geometry["out_h"])
            for fn in fns] == [(fn.in_rows, fn.out_rows) for fn in fns]
    assert fns[0].in_row_base == 0
    for a, b in zip(fns, fns[1:]):      # overlapping strips, in order
        assert a.in_row_base < b.in_row_base < a.in_row_base + a.in_rows
    assert fns[-1].in_row_base + fns[-1].in_rows == h
    full = build(2, h, w, ow, oh, sharpness=0.9, centres=cen)
    assert not hasattr(full, "band_range")
    assert full.dma_geometry is not None
    for bad in ((0, 0), (3, 2), (0, 21), (-1, 2)):
        with pytest.raises(ValueError, match="band_range"):
            build(2, h, w, ow, oh, sharpness=0.9, centres=cen,
                  band_range=bad)


def _rows_read(m, rows, window, oob):
    """The input rows the band's kernels read, stated from the CUDA
    kernels: an inside tile stages its window (B1: rows clamped into the
    image, fsr_fused.cu stage_tile; B5: the rows inside the image,
    cas_upscale.cu), an outside tile's output rows in the band load their
    bilinear rows clamped (bilinear_pass.cuh)."""
    r0, r1 = rows
    n_ty, n_tx = len(m.tile_y0), len(m.tile_x0)
    h = m.in_h
    read = set()
    for t in m.inside_tiles:
        y0 = int(m.tile_y0[t % (n_ty * n_tx) // n_tx])
        ys = np.arange(y0, y0 + window)
        read |= set((np.clip(ys, 0, h - 1) if oob == "clamp"
                     else ys[(ys >= 0) & (ys < h)]).tolist())
    for t in m.outside_tiles:
        ty = t % (n_ty * n_tx) // n_tx
        for oy in range(max(r0, ty * FSR_TILE), min(r1, ty * FSR_TILE +
                                                     FSR_TILE)):
            y0 = int(m.row_i[1][oy])
            read |= {min(max(y0, 0), h - 1), min(max(y0 + 1, 0), h - 1)}
    return read


@pytest.mark.parametrize("band_rows", [24, 32, 128])
@pytest.mark.parametrize("kernel,h,w,rs", [
    ("fsr_fused", 187, 168, 0.75), ("fsr_fused", 150, 120, 1.3),
    ("cas_upscale", 187, 168, 0.75), ("cas_upscale", 150, 120, 0.6)])
def test_strip_tables_read_inside_the_strip(kernel, h, w, rs, band_rows):
    """The band's lists are the tiles of the 32-row tile rows that overlap
    its output rows, inside and outside partitioned as in the full build;
    every row their kernels read lies in [in_row_base, in_row_base +
    in_rows) and in the image, and the strip is no larger than that."""
    _, layout, maps_of, window, oob = KERNELS[kernel]
    ow, oh = _out_size(h, w, rs)
    m = maps_of(2, h, w, ow, oh, C.centres_payload(ow, oh, 0.6, OFF_CENTRE,
                                                   (0, 1)))
    th, gy = layout(ow, oh, band_rows)
    n_ty, n_tx = len(m.tile_y0), len(m.tile_x0)
    for g0, g1 in split_bands(gy, 4) + [(g, g + 1) for g in range(gy)]:
        rows = (g0 * th, min(g1 * th, oh))
        band, base, n_rows = band_strip(m, rows, window, oob)
        t0, t1 = rows[0] // FSR_TILE, -(-rows[1] // FSR_TILE)

        def of_band(ids):
            return ids[(ids % (n_ty * n_tx) // n_tx >= t0)
                       & (ids % (n_ty * n_tx) // n_tx < t1)]
        assert np.array_equal(band.inside_tiles, of_band(m.inside_tiles))
        assert np.array_equal(band.outside_tiles, of_band(m.outside_tiles))
        read = _rows_read(band, rows, window, oob)
        if rows == (0, oh):
            assert (base, n_rows) == (0, h)
            continue
        assert 0 <= base and base + n_rows <= h
        assert min(read) == base and max(read) == base + n_rows - 1


def test_strips_match_the_jax_strip_kernels():
    """At 2 x 48x56 -> 2 x 64x74 (32-row bands, 2 strips) the port's
    strips, concatenated, against the JAX package's strip kernels in
    interpret mode: within the JAX test's own tolerance (1 LSB on at most
    0.1% of texels, tests/test_spatial.py)."""
    h, w = 48, 56
    ow, oh = _out_size(h, w, 0.75)
    cen = C.centres_payload(ow, oh, 0.5, CENTERS, (0, 1))
    frames = np.stack([FR.zone_plate_frame(h, w),
                       FR.noise_frame(h, w, seed=3)])
    packed = np.ascontiguousarray(frames).view(np.uint32)[..., 0]
    hp, wp = JBD.input_padding(h, w)
    padded = np.pad(packed, ((0, 0), (0, hp - h), (0, wp - w)))
    _, gy = fsr.fsr_band_layout(ow, oh, 32)
    kw = dict(sharpness=0.9, centres=cen, band_rows=32)
    jax_out, port_out = [], []
    for g0, g1 in split_bands(gy, 2):
        jfn = j_build_fsr(2, h, w, ow, oh, band_range=(g0, g1),
                          interpret=True, **kw)
        jax_out.append(np.asarray(jfn(
            padded[:, jfn.in_row_base:jfn.in_row_base + jfn.in_rows]))
            [:, :jfn.out_rows])
        fn = fsr.build_fsr_fused(2, h, w, ow, oh, band_range=(g0, g1), **kw)
        assert fn.out_rows == jfn.out_rows
        port_out.append(fn(torch.from_numpy(np.ascontiguousarray(
            packed[:, fn.in_row_base:fn.in_row_base + fn.in_rows])
            .view(np.int32))).numpy())
    want = np.concatenate(jax_out, axis=1)
    got = np.concatenate(port_out, axis=1).view(np.uint32)
    assert got.shape == want.shape == (2, oh, ow)
    d = np.abs(got.view(np.uint8).astype(np.int16)
               - want.view(np.uint8).astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


# ---- the C entry points -------------------------------------------------------

def _prototype_argtypes(kernel, entry, text=None):
    """The ctypes types of the C prototype `entry` in csrc/<kernel>.cu (or
    in `text`), read here apart from kernels/_build.py's parser."""
    text = text or (_build.CSRC / f"{kernel}.cu").read_text()
    (params,) = re.findall(rf'extern "C" int {entry}\((.*?)\)\s*\{{', text,
                           re.S)
    return [ctypes.c_void_p if "*" in p else
            {"int": ctypes.c_int, "float": ctypes.c_float}[p.split()[0]]
            for p in (" ".join(q.split()) for q in params.split(","))]


def _before_strips(kernel):
    """csrc/<kernel>.cu with the class entry point's prototype before the
    row-band strips: no strip base, no band rows."""
    return re.sub(r"int in_row_base, |int out_row0, int out_row1, ", "",
                  (_build.CSRC / f"{kernel}.cu").read_text())


@pytest.mark.parametrize("kernel,argtypes", [
    ("fsr_fused", _prototype_argtypes("fsr_fused", "fsr_fused_launch")),
    ("cas_upscale", _prototype_argtypes("cas_upscale", "cas_upscale_launch"))])
@pytest.mark.parametrize("suffix", ["", "10"])
def test_argtypes_are_the_prototypes(kernel, argtypes, suffix):
    """The parser reads both entry points with the types of their
    prototypes, the strip's base and band rows included (a pointer bound as
    c_int would be cut to 32 bits); the two upscalers' are one prototype."""
    entry = f"{kernel}_launch{suffix}"
    text = (_build.CSRC / f"{kernel}.cu").read_text()
    assert _build.argtypes(entry, text) == argtypes
    assert _build.prototype(entry, text) == _build.prototype(
        f"fsr_fused_launch{suffix}",
        (_build.CSRC / "fsr_fused.cu").read_text())
    assert "int in_row_base, int in_rows" in text
    assert "int out_row0, int out_row1" in text


def test_ab_parents_of_the_class_kernels(monkeypatch):
    """tools/ab.py drives an upscaler parent with the class kernels' entry
    point before the strips where its source has that prototype (the
    current one's less ab.STRIP_PARAMS): B1's and B5's from the class
    kernels to the strips; the current sources have the strip prototype,
    and run through the current wrapper."""
    fused = (_build.CSRC / "fsr_fused.cu").read_text()
    upscale = (_build.CSRC / "cas_upscale.cu").read_text()
    before = _before_strips("cas_upscale")
    assert ab.class_parent("fsr_fused", _before_strips("fsr_fused"))
    assert ab.class_parent("cas_upscale", before)
    assert not ab.class_parent("fsr_fused", fused)
    assert not ab.class_parent("cas_upscale", upscale)
    assert not ab.class_parent("nis_scaler", before)
    assert not ab.class_parent("cas_upscale", "int main() {}")
    classes = ab.entry_argtypes("cas_upscale", before)
    assert classes == _prototype_argtypes("cas_upscale",
                                          "cas_upscale_launch", before)
    assert len(classes) == len(ab.entry_argtypes("cas_upscale")) - 3
    assert ab.entry_argtypes("fsr_fused", _before_strips("fsr_fused")) == \
        classes
    h, w = 96, 128
    ow, oh = _out_size(h, w, 0.75)
    cen = C.centres_payload(ow, oh, 0.5, CENTERS, (0, 1))
    _, maps, kw = ab._build_current("cas_upscale", 2, h, w, ow, oh, cen, 0)
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "S", (), {"cuda_stream": 0})())
    run = ab.parent_launcher("cas_upscale", entry, maps, 2, CPU,
                             classes=True, **kw)
    assert run(torch.zeros((2, h, w), dtype=torch.int32)).shape == (2, oh, ow)
    args = seen["args"]
    assert len(args) == len(classes)
    assert args[13:20] == (2, h, w, h, w, oh, ow)
    assert args[-3:-1] == (FSR_TILE, CAS_IN_TILE)


@pytest.mark.parametrize("form", ["launcher", "main"])
def test_ab_refuses_other_b1_parents(form, tmp_path, capsys, monkeypatch):
    """A B1 parent whose fsr_fused_launch has neither the current
    prototype's types nor the class kernels' before the strips has no
    launcher: parent_launcher refuses it rather than take CAS's earlier
    layout, and the tool stops on it before it builds anything."""
    if form == "launcher":
        h, w = 96, 128
        ow, oh = _out_size(h, w, 0.75)
        cen = C.centres_payload(ow, oh, 0.5, CENTERS, (0, 1))
        _, maps, kw = ab._build_current("fsr_fused", 2, h, w, ow, oh, cen, 0)
        with pytest.raises(ValueError, match="fsr_fused"):
            ab.parent_launcher("fsr_fused", lambda *a: 0, maps, 2, CPU,
                               classes=False, **kw)
        return
    src = tmp_path / "fsr_fused.cu"
    src.write_text('extern "C" int fsr_fused_launch(const void* img, '
                   'void* out, int batch, int h, int w, void* stream) {}')
    assert not ab.class_parent("fsr_fused", src.read_text())
    from openvr_fsr_tpu_torch import bench
    monkeypatch.setattr(bench, "require_gpu", lambda what: None)
    monkeypatch.setattr(ab, "build_parent", lambda *a: pytest.fail("built"))
    with pytest.raises(SystemExit) as e:
        ab.main(["--kernel", "fsr_fused", "--parent", str(src)])
    assert e.value.code == 2
    assert "neither" in capsys.readouterr().err


# ---- SpatialFsrPipeline ------------------------------------------------------

def _stereo(h, w):
    return np.stack([FR.zone_plate_frame(h, w), FR.noise_frame(h, w, seed=3)])


@pytest.mark.parametrize("cfg", [
    dict(render_scale=0.75, sharpness=0.9, radius=0.5),
    dict(render_scale=0.75, sharpness=0.9, radius=2.0, debug_mode=True),
    dict(render_scale=1.3, sharpness=0.9, radius=0.5),
    dict(render_scale=0.75, sharpness=0.6, radius=0.5, use_cas=True)],
    ids=["fsr", "fsr-debug", "supersample", "cas"])
def test_spatial_pipeline_is_the_oracle_and_the_pipeline(cfg):
    """SpatialFsrPipeline over 3 CPU strips at 24-row bands is bit-equal to
    the port's Pipeline(device="cpu") and to the NumPy pipeline oracle."""
    cfg = Config(enabled=True, **cfg)
    h, w = 40, 48
    frames = _stereo(h, w)
    sp = SpatialFsrPipeline(cfg, devices=[CPU] * 3, band_rows=24)
    got = sp.process(frames, eyes=(0, 1))
    ow, oh = cfg.output_size(w, h)
    assert got.shape == (2, oh, ow) and got.dtype == np.uint32
    assert len(sp.kernels) == 3
    want = Pipeline(cfg, device="cpu").process(frames, eyes=(0, 1)).numpy()
    assert np.array_equal(got.view(np.uint8).reshape(want.shape), want)
    for e in (0, 1):
        oracle = pipeline_oracle(
            frames[e], cfg.render_scale, cfg.sharpness, radius=cfg.radius,
            use_cas=cfg.use_cas, debug=cfg.debug_mode, eye=e)
        assert np.array_equal(want[e], oracle)


def test_spatial_pipeline_place_process_gather():
    """place puts one overlapping strip per device in the ring pitch's
    width; process_placed returns the strips in band order, (B, out_rows,
    OW) int32; gather concatenates them; packed int32, uint32 and uint8
    frames give the same output."""
    cfg = Config(enabled=True, render_scale=0.75, sharpness=0.9, radius=0.5)
    h, w = 53, 66
    frames = _stereo(h, w)
    sp = SpatialFsrPipeline(cfg, devices=[CPU, CPU], band_rows=32)
    key, strips = sp.place(frames)
    assert key == (2, h, w, (0, 1))
    shards = sp._cache[key][0]
    _, wp = input_padding(h, w)
    assert [tuple(s.shape) for s in strips] == [
        (2, rows, wp) for _, _, rows, _, _ in shards]
    outs = sp.process_placed((key, strips))
    assert [tuple(o.shape) for o in outs] == [(2, 64, 88), (2, 6, 88)]
    assert all(o.dtype == torch.int32 for o in outs)
    got = sp.gather(key, outs)
    packed = np.ascontiguousarray(frames).view(np.uint32)[..., 0]
    assert np.array_equal(sp.process(packed), got)
    assert np.array_equal(sp.process(torch.from_numpy(packed.view(np.int32))),
                          got)
    assert np.array_equal(sp.process(torch.from_numpy(frames)), got)
    assert len(sp._cache) == 1


def test_spatial_pipeline_refusals():
    """The JAX class's asserts (fused FSR at rs != 1, or CAS at rs < 1);
    with no devices, every CUDA device: none here."""
    for cfg in (Config(enabled=True, render_scale=1.0),
                Config(enabled=True, render_scale=0.75, use_nis=True),
                Config(enabled=True, render_scale=1.3, use_cas=True)):
        with pytest.raises(AssertionError):
            SpatialFsrPipeline(cfg, devices=[CPU])
    cfg = Config(enabled=True, render_scale=0.75)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            SpatialFsrPipeline(cfg)
    with pytest.raises(TypeError, match="packed RGBA8"):
        SpatialFsrPipeline(cfg, devices=[CPU]).process(
            np.zeros((2, 8, 8, 4), np.uint16))


# ---- ShardedPipeline -----------------------------------------------------------

def _batch(b, h=32, w=40):
    return np.stack([FR.noise_frame(h, w, seed=i) for i in range(b)])


@pytest.mark.parametrize("model,kw", [
    (FsrModel, dict(render_scale=0.75)), (FsrModel, dict(render_scale=1.0)),
    (NisModel, dict(render_scale=0.75)), (CasModel, dict(render_scale=0.75)),
    (CasModel, dict(render_scale=1.0))])
def test_sharded_equals_the_pipeline(model, kw):
    """Every plan over 2 CPU slices at batch 4 equals Pipeline.process, as
    uint8 frames and packed planes; the outputs are per-slice tensors in
    batch order."""
    m = model(device="cpu", **kw)
    frames = _batch(4)
    sp = ShardedPipeline(m.pipeline, [CPU, CPU])
    outs = sp.process(frames)
    assert len(outs) == 2 and all(o.shape[0] == 2 for o in outs)
    assert torch.equal(torch.cat(outs), m(frames))
    packed = torch.from_numpy(np.ascontiguousarray(frames)).view(
        torch.int32)[..., 0].contiguous()
    assert torch.equal(torch.cat(sp.process(packed)),
                       m.pipeline.process(packed))


def test_sharded_ten_bit_and_eyes():
    """10-bit frames, an explicit repeating eye pattern, and packed frames
    refused at 10 bits."""
    pipe = Pipeline(Config(enabled=True, render_scale=0.75), color_bits=10,
                    device="cpu")
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 1024, (4, 24, 32, 4)).astype(np.uint16)
    eyes = (1, 0, 1, 0)
    outs = ShardedPipeline(pipe, [CPU, CPU]).process(frames, eyes=eyes)
    assert torch.equal(torch.cat(outs), pipe.process(frames, eyes=eyes))
    with pytest.raises(ValueError, match="require color_bits=8"):
        ShardedPipeline(pipe, [CPU]).process(np.zeros((2, 8, 8), np.uint32))
    with pytest.raises(TypeError, match="uint16"):
        ShardedPipeline(pipe, [CPU]).process(np.zeros((2, 8, 8, 4), np.uint8))


def test_sharded_refuses_a_ragged_batch_and_a_non_repeating_pattern():
    sp = ShardedPipeline(Pipeline(Config(enabled=True, render_scale=0.75),
                                  device="cpu"), [CPU, CPU])
    with pytest.raises(ValueError, match="not divisible"):
        sp.process(_batch(3))
    with pytest.raises(ValueError, match="eye pattern"):
        sp.process(_batch(4), eyes=(0, 1, 1, 0))
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(np.zeros((3, 2)), [CPU, CPU])


def test_sharded_builds_again_after_mutation():
    """The build is cached under Pipeline.process's key fields: a second
    call reuses it; sharpness, toggle_nis, color_bits and hdr_mode each
    build again, with the new plan's output."""
    pipe = Pipeline(Config(enabled=True, render_scale=0.75), device="cpu")
    sp = ShardedPipeline(pipe, [CPU, CPU])
    frames = _batch(4)
    first = torch.cat(sp.process(frames))
    sp.process(frames)
    assert len(pipe._cache) == 1
    pipe.adjust_sharpness(-0.5)
    second = torch.cat(sp.process(frames))
    assert not torch.equal(first, second)
    assert torch.equal(second, pipe.process(frames))
    pipe.toggle_nis()
    assert torch.equal(torch.cat(sp.process(frames)), pipe.process(frames))
    pipe.hdr_mode = 1
    assert torch.equal(torch.cat(sp.process(frames)), pipe.process(frames))
    pipe.color_bits = 10
    ten = np.random.default_rng(2).integers(0, 1024, (4, 32, 40, 4)).astype(
        np.uint16)
    assert torch.equal(torch.cat(sp.process(ten)), pipe.process(ten))
    keys = [k for k in pipe._cache if k[0] == "shard"]
    assert len(keys) == 3 and len({k[6:] for k in keys}) == 3


def test_sharded_double_wide_and_crop():
    """Double-wide frames (half-width bounds) hold both eyes: the eye
    indices are normalised, so any pattern runs; crop returns each slice's
    bounded region, as Pipeline.process does."""
    pipe = Pipeline(Config(enabled=True, render_scale=0.75), device="cpu")
    sp = ShardedPipeline(pipe, [CPU, CPU])
    frames = _batch(4, 32, 64)
    bounds = (0.0, 0.0, 0.5, 1.0)
    outs = sp.process(frames, eyes=(0, 1, 1, 0), bounds=bounds, crop=True)
    assert not pipe.single_eye_per_frame
    want = pipe.process(frames, bounds=bounds, crop=True)
    assert torch.equal(torch.cat(outs), want)
    assert outs[0].shape[2] == want.shape[2] < 85


def test_make_mesh_and_shard_batch():
    """shard_batch cuts contiguous batch slices, one per mesh device; with
    no CUDA GPU, make_mesh (the default mesh) raises."""
    x = np.arange(6 * 4).reshape(6, 4)
    parts = shard_batch(x, [CPU] * 3)
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:4].tolist(),
                                           x[4:].tolist()]
    assert all(p.device == CPU and p.is_contiguous() for p in parts)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            FsrModel(device="cpu").sharded()


# ---- the on-card tool ------------------------------------------------------------

def test_spatial_onchip_refuses_without_a_gpu():
    """No CUDA GPU: an error line and exit 1, jax never imported, nothing
    written."""
    code = ("import runpy, sys\n"
            "try:\n"
            "    runpy.run_module('openvr_fsr_tpu_torch.tools.spatial_onchip',"
            " run_name='__main__')\n"
            "finally:\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'openvr_fsr_tpu'))\n"
            "    print('imported:', bad, file=sys.stderr)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "imported: []" in r.stderr, r.stderr
    (line,) = r.stdout.splitlines()
    assert "no CUDA GPU" in json.loads(line)["error"]


def test_ab_same_sass_matches_functions_across_builds(monkeypatch):
    """tools/ab.py's sass_same matches the parent's functions with the
    current build's by name less the anonymous namespace (whose name hashes
    the source's path): equal, unequal and missing functions."""
    from openvr_fsr_tpu_torch.tools import sass

    def fake(ns, body):
        return "\n".join(
            f"\t\tFunction : _ZN{len(ns)}{ns}{name}\n"
            + "".join(f"        /*{16 * i:04x}*/   {t} ;\n"
                      for i, t in enumerate(ins))
            for name, ins in body.items())

    same = ["MOV R1, c[0x0][0x28]", "EXIT"]
    texts = {
        "parent.so": fake("_GLOBAL__N__835d9542_13_nis_scaler_cu_c_coef",
                          {"17nis_inside_kernelv": same,
                           "18nis_outside_kernelv": same,
                           "9gone_kernelv": same}),
        "current.so": fake("_GLOBAL__N__0bad1dea_13_nis_scaler_cu_0f0f0f0f",
                           {"17nis_inside_kernelv": same,
                            "18nis_outside_kernelv": ["EXIT"]}),
    }
    monkeypatch.setattr(sass, "disassemble", lambda lib, nvcc: texts[lib])
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    assert ab.same_sass("parent.so", "current.so") == {
        "17nis_inside_kernelv": True, "18nis_outside_kernelv": False,
        "9gone_kernelv": None}
    monkeypatch.setattr(sass, "disassemble", lambda lib, nvcc: None)
    assert ab.same_sass("parent.so", "current.so") is None
    # the prototypes ab.py tells apart
    assert ab.entry_argtypes("fsr_fused", (_build.CSRC / "fsr_fused.cu")
                             .read_text()) == _prototype_argtypes(
        "fsr_fused", "fsr_fused_launch")
    assert ab.entry_argtypes("fsr_fused", "int main() {}") is None
