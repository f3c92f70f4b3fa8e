"""EASU's analysis split at FsrEasuSetF's weighting, as B1's inside kernel
computes it (csrc/fsr_fused.cu: the terms pass and easu_from_terms).

Each of EASU's four FsrEasuSetF calls takes the 4-neighbour cross of one
quadrant centre (f, g, j, k) and all of it but the weighting by the
quadrant's w and the sums depends on that centre texel alone: its luma's
differences give dirX, dirY, lenX² and lenY². The kernel computes these
terms once per window texel and each output position only weights and sums
its four centres' terms. The model here does the same in plain torch: the
lumas of an edge-clamped plane, the terms of every texel at its unclamped
position, each position's four centres gathered and summed in the kernel's
order, and ops/easu.py::easu_resolve after the sums. It must equal
ops/easu.py::easu_core bit for bit (NaN for NaN) at f32 and bf16.

The launch work's `analysed` (kernels/_maps.py::analysed_texels: the
texels whose terms one launch computes) is held to a brute-force count of
each inside tile's quadrant centres.
"""

import numpy as np
import pytest
import torch

from openvr_fsr_tpu_torch.core import constants as C
from openvr_fsr_tpu_torch.core.config import Config
from openvr_fsr_tpu_torch.kernels import _maps, fsr
from openvr_fsr_tpu_torch.ops.common import HALF, aprx_lo_rcp, sat, via_f32
from openvr_fsr_tpu_torch.ops.easu import (easu_core, easu_gather,
                                           easu_index_maps, easu_resolve)

IN_H, IN_W = 21, 26
PAD = 2     # the terms of the edge-clamped plane from position -1 to n


def _plane(kind, levels, seed):
    """(3, IN_H, IN_W) f32 texels k / levels as the kernels decode them (k
    times the f32 reciprocal): random, or with flat regions (zero
    gradients: aprx_lo_rcp(0)) over the left half and the bottom rows."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, levels + 1, (3, IN_H, IN_W))
    if kind == "flat":
        k[:, :, :IN_W // 2] = k[:, :1, :1]
        k[:, -5:, :] = rng.integers(0, levels + 1, (3, 1, 1))
    return torch.from_numpy(
        k.astype(np.float32) * (np.float32(1.0) / np.float32(levels)))


def _terms(rgb, dt):
    """(dirX, dirY, lenX², lenY²) of every position of the plane padded by
    PAD texels of its edge (the kernel's edge-clamped window), from the
    lumas of its channels in dt; the inner PAD - 1 ring and the image have
    all four neighbours. ffx::easu_set's ops, in its order."""
    p = torch.nn.functional.pad(rgb[None], (PAD,) * 4, mode="replicate")[0]
    r, g, b = p.to(dt).unbind(0)
    L = b * 0.5 + (r * 0.5 + g)
    lo_rcp = via_f32(aprx_lo_rcp, dt)
    c = L[1:-1, 1:-1]
    lA, lB, lD, lE = L[:-2, 1:-1], L[1:-1, :-2], L[1:-1, 2:], L[2:, 1:-1]
    dc, cb = lD - c, c - lB
    len_x = lo_rcp(torch.maximum(torch.abs(dc), torch.abs(cb)))
    dir_x = lD - lB
    len_x = sat((torch.abs(dir_x) * len_x).float())
    ec, ca = lE - c, c - lA
    len_y = lo_rcp(torch.maximum(torch.abs(ec), torch.abs(ca)))
    dir_y = lE - lA
    len_y = sat((torch.abs(dir_y) * len_y).float())
    return dir_x, dir_y, len_x * len_x, len_y * len_y


def _direction(terms, fxi, fyi, ppx, ppy, dt):
    """The four sums from the centres' terms, set by set f, g, j, k (at
    floor + 0 / + 1), in easu_from_terms's order."""
    ny, nx = 1.0 - ppy, 1.0 - ppx
    # terms index = unclamped position + PAD - 1
    cols = {d: torch.as_tensor(fxi + d + PAD - 1) for d in (0, 1)}
    rows = {d: torch.as_tensor(fyi + d + PAD - 1) for d in (0, 1)}
    z = torch.zeros((len(fyi), len(fxi)), dtype=dt)
    dir_x, dir_y, length = z, z, z
    for (dx, dy), w in (((0, 0), nx * ny), ((1, 0), ppx * ny),
                        ((0, 1), nx * ppy), ((1, 1), ppx * ppy)):
        tx, ty, lxx, lyy = (t.index_select(0, rows[dy]).index_select(
            1, cols[dx]) for t in terms)
        dir_x = dir_x + tx * w
        length = length + lxx * w
        dir_y = dir_y + ty * w
        length = length + lyy * w
    return dir_x, dir_y, length


def _maps_at(scale):
    ow, oh = Config(render_scale=scale).output_size(IN_W, IN_H)
    con = C.fsr_easu_con(IN_W, IN_H, IN_W, IN_H, ow, oh)
    return easu_index_maps(IN_W, IN_H, ow, oh, np.asarray(con[0], np.float32))


@pytest.mark.parametrize("dt", [torch.float32, HALF], ids=["f32", "bf16"])
@pytest.mark.parametrize("levels", [255, 1023])
@pytest.mark.parametrize("kind", ["random", "flat"])
@pytest.mark.parametrize("scale", [0.5, 0.75, 1.3])
def test_terms_sums_equal_easu_core(dt, levels, kind, scale):
    rgb = _plane(kind, levels, seed=levels + int(scale * 100))
    fxi, fyi, ppx, ppy = _maps_at(scale)
    # the quadrant centres reach past both edges of the plane: the
    # edge-clamped borders are covered
    assert fxi.min() == -1 and fxi.max() + 1 >= IN_W - 1
    assert fyi.min() == -1 and fyi.max() + 1 >= IN_H - 1
    taps = easu_gather(rgb, torch.from_numpy(fxi), torch.from_numpy(fyi))
    px = torch.from_numpy(ppx)[None, :]
    py = torch.from_numpy(ppy)[:, None]
    want = easu_core(taps, px, py, dt)
    px, py = px.to(dt), py.to(dt)
    direction = _direction(_terms(rgb, dt), fxi, fyi, px, py, dt)
    got = easu_resolve({o: t.to(dt) for o, t in taps.items()}, direction,
                       px, py, dt)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)) or \
        bool(torch.isnan(want).any())


@pytest.mark.parametrize("dt", [torch.float32, HALF], ids=["f32", "bf16"])
def test_a_flat_plane_has_zero_gradients_everywhere(dt):
    """A flat plane: every difference is 0, so lenX = aprx_lo_rcp(0) (a
    huge finite number) times 0; the terms are all 0 and the sums too, and
    the result is the plane's colour, as easu_core gives it."""
    rgb = torch.full((3, IN_H, IN_W), 77.0) * (np.float32(1.0) /
                                                np.float32(255.0))
    terms = _terms(rgb, dt)
    assert all(bool((t == 0).all()) for t in terms)
    fxi, fyi, ppx, ppy = _maps_at(0.75)
    taps = easu_gather(rgb, torch.from_numpy(fxi), torch.from_numpy(fyi))
    px, py = (torch.from_numpy(ppx)[None, :].to(dt),
              torch.from_numpy(ppy)[:, None].to(dt))
    got = easu_resolve({o: t.to(dt) for o, t in taps.items()},
                       _direction(terms, fxi, fyi, px, py, dt), px, py, dt)
    torch.testing.assert_close(got, easu_core(taps, px, py, dt), rtol=0,
                               atol=0, equal_nan=True)


def _brute_spans(m):
    """Per inside tile, the floors of its haloed outputs in the image,
    each + 0 and + 1: the (columns, rows) of the rectangle of their
    extents."""
    n_tx, n_ty = len(m.tile_x0), len(m.tile_y0)
    spans = []
    for tid in np.asarray(m.inside_tiles):
        ty, tx = (tid % (n_ty * n_tx)) // n_tx, tid % n_tx
        ox = np.arange(tx * 32 - 1, tx * 32 + 33)
        oy = np.arange(ty * 32 - 1, ty * 32 + 33)
        ox = ox[(ox >= 0) & (ox < m.out_w)]
        oy = oy[(oy >= 0) & (oy < m.out_h)]
        cx = np.concatenate([m.col_i[0][ox], m.col_i[0][ox] + 1])
        cy = np.concatenate([m.row_i[0][oy], m.row_i[0][oy] + 1])
        spans.append((cx.max() - cx.min() + 1, cy.max() - cy.min() + 1))
    return spans


def _build_work(monkeypatch, *args, **kw):
    """build_fsr_fused(*args, **kw)'s launch work, as it hands it to
    kernel_fn or band_fn."""
    seen = []
    for name in ("kernel_fn", "band_fn"):
        def spy(*a, _real=getattr(fsr, name), **k):
            seen.append(a[-1])
            return _real(*a, **k)
        monkeypatch.setattr(fsr, name, spy)
    fsr.build_fsr_fused(*args, **kw)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("scale,radius,band", [
    (0.75, 0.5, None), (0.75, 2.0, None), (0.5, 0.5, None),
    (1.3, 0.5, None), (0.75, 0.5, (1, 3)), (0.5, 2.0, (0, 1))])
def test_analysed_counts_each_inside_tiles_centre_span(monkeypatch, scale,
                                                       radius, band):
    h, w = 150, 130
    ow, oh = Config(render_scale=scale).output_size(w, h)
    cen = C.centres_payload(ow, oh, radius, ((0.3, 0.6), (0.7, 0.4)), (0, 1))
    kw = {} if band is None else dict(band_rows=32, band_range=band)
    work = _build_work(monkeypatch, 2, h, w, ow, oh, sharpness=0.5,
                       centres=cen, **kw)
    m = _maps.fsr_maps(2, h, w, ow, oh, cen)
    if band is not None:
        m = _maps.band_strip(m, (band[0] * 32, min(band[1] * 32, oh)),
                             _maps.IN_TILE, "clamp")[0]
    spans = _brute_spans(m)
    want = sum(int(a * b) for a, b in spans)
    assert 0 < want == work["analysed"] == _maps.analysed_texels(m)
    # every texel a tile analyses lies in the window's interior (the
    # kernel's 38x38 terms)
    assert max(max(a, b) for a, b in spans) <= _maps.IN_TILE - 2
