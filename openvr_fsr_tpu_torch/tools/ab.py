"""Same-process A/B of one redesigned kernel (B1 csrc/fsr_fused.cu, B3
csrc/nis_scaler.cu, B5 csrc/cas_upscale.cu, B4 csrc/nis_sharpen.cu, B6
csrc/cas_sharpen.cu, B2 csrc/rcas_sharpen.cu, the shared-memory and
tensor-core rate probes B8b csrc/vmem_rate.cu and B8c csrc/mxu_rate.cu, or
the DMA floor B7 csrc/dma_floor.cu) against an earlier source of it, or
against the current source with one part taken out, on one NVIDIA GPU.

    python3 -m openvr_fsr_tpu_torch.tools.ab --kernel KERNEL
        (--parent FILE | --ablate NAME) [--iters N] [--out FILE]

FILE is the kernel's source as the previous commit has it (`git show
HEAD~1:openvr_fsr_tpu_torch/csrc/<kernel>.cu`); a header of csrc/ that
source needs in its earlier form goes beside it (its own directory is
searched first: the earlier rcas_sharpen.cu needs the earlier rgba8.cuh,
which still held the circle test). It is driven through the entry point
that source was written for:
  fsr_fused    the two class kernels' fsr_fused_launch as it was before
               the row-band strips (CLASS_ARGTYPES: no strip base, no
               band rows), with the current tables;
  nis_scaler   one CTA per 32x24 block, nis_scaler_launch with 11 pointers
               and 40x32 luma windows;
  cas_upscale  where the source's cas_upscale_launch has the class kernels'
               prototype before the strips (CLASS_ARGTYPES), that entry
               point with the current tables, as fsr_fused's; otherwise
               one CTA per 16x16 tile, cas_upscale_launch with 9 pointers
               and 20x20 windows;
  nis_sharpen  one CTA per 32x32 block with its own circle test,
               nis_sharpen_launch(img, out, centres, consts, n_consts,
               batch, h, w, rows, pitch, hdr_mode, tint, stream);
  cas_sharpen  one CTA per 16x16 tile with its own circle test,
               cas_sharpen_launch(img, out, centres, batch, h, w, rows,
               pitch, sharp, mcd, tint, stream);
  rcas_sharpen one CTA per 16x16 tile with its own circle test,
               rcas_sharpen_launch(img, out, centres, batch, h, w, rows,
               pitch, sharp, tint, stream);
  vmem_rate    the current vmem_rate_launch, one 130-thread CTA per
               (column, share), driven with the shares its source was
               written for (PARENT_VMEM_SHARES);
  mxu_rate     the current mxu_rate_launch(x, w, partials, out, tile, k,
               steps, stream) (the earlier source: mma.sync, 8 warps per
               step);
  dma_floor    dma_floor_launch(img, out, tile_x0, tile_y0, tap_x, tap_y,
               quad_x, quad_y, staged, batch, in_h, in_w, rows, pitch,
               out_h, out_w, tile_w, tile_h, win_w, win_h, threads, stage,
               stage_quads, clamp, mask, stream): one CTA per tile in the
               compute kernel's launch shape, its windows loaded word by
               word (parent_floor builds its tables from the geometry).
A compute kernel's earlier source whose entry point has the current
prototype (NVScaler's from PR 7 on) runs through the current wrapper
instead. It is built with the port's nvcc flags into a temporary directory
and driven with the tables it was written for, made from the same sample
maps and centres as the current build's.

NAME is one of ABLATIONS[KERNEL]: the current source with one edit, built
the same way and driven through the current wrapper with its own entry
point swapped in. It answers what a part of the kernel costs:
  nis_scaler   noslide  the luma support and edge weights no longer slide
                        down a run: every new source row reloads them (the
                        same bits);
  nis_sharpen  noslide  every output of a run reloads its 5x5 lumas (the
                        same bits);
  cas_sharpen  noslide  every output of a run reloads its 3x3x3 taps (the
                        same bits);
               nostage  no window is staged (other bits: a time only);
  rcas_sharpen noslide  every output of a run reloads its 5 cross taps (the
                        same bits);
  vmem_rate    onegroup one step group per CTA, driven with the parent's
                        shares: its 130 threads hold a warp of 2 live lanes,
                        and 3 CTAs per SM 15 warps (the same bits);
               predicated  every plane goes through the predicated loop of
                        two loads per trip, not unrolled (the same bits);
               nounroll the loop of blocks of 8 planes not unrolled (the
                        same bits);
  dma_floor    nopersist one CTA per item, the box items too: no ring
                        holds a second box (the same words).
  cas_upscale  nostage  no window is staged: the filter reads a window
                        never written (other bits: a time only);
               noload   the window's texels are made from their index
                        instead of loaded; the decode and its shared stores
                        stay (other bits: a time only).

Cases, sharpness 0.9, centred eyes, at 2 x 1683x1869 -> 2 x 2244x2492 (rs
0.75; the sharpen-only kernels at 2 x 2244x2492, rs 1): radius 0.0, 0.5
and 2.0; then NVScaler at hdr_mode 1 and the other upscalers at the
supersample (2 x 2244x2492 -> 2 x 2917x3239, rs 1.3), radius 0.5;
NVSharpen at hdr_mode 1, radius 0.5; CAS sharpen at max_color_delta 0.05,
radius 2.0; RCAS sharpen at radius 0.3. In
each, both kernels' outputs must equal the plain version's on the first
frame (else it exits 1); then they are timed in turns, parent, current,
current, parent, each round the best of 3 rotations of `iters`
back-to-back calls over the bench's three ring frames (CUDA events). An
ablation that keeps the bits is held to the plain version too; one that
does not is only timed. Prints one JSON line: the card, each build's ptxas
registers, spills and shared memory per kernel, whether each of the
parent's functions compiled to the same SASS in the current build
(sass_same, by name less the anonymous namespace), the current class
kernels' CTAs per SM, and per case both rounds of each and parent /
current (the ablated build stands in the parent's place).

For vmem_rate and mxu_rate the case is the audit's full probe
(tools/vpu_audit.py PROBES: vmem k 16 and 112, 4,096 steps; mxu k 8 and
64, 264 steps): both builds' hi calls must equal the plain version (vmem:
bit for bit; mxu: within kernels/sol.py::MXU_TOLERANCE); then each one's
rate is measured as the audit measures it (paired slopes over the two k)
in turns, parent, current, current, parent, and given per second and as a
share of its bound (vmem: SMs x 128 B x the max SM clock; mxu: SMs x
2,048 dense bf16 MACs x the max SM clock); the line also holds the loops of both builds'
SASS (instructions, LDS, HMMA, HGMMA and LDSM per loop).

For dma_floor the cases are the seven bench paths' geometries
(tools/bench_paths.py PATHS) at their radius 0.5 and at radius 0.0 and
2.0: both floors must equal the plain version word for word on the first
ring frame; then the parent floor, the current floor and the path's
compute kernel are timed in turns (parent, current, kernel, kernel,
current, parent) over the bench's ring frames, and each case gives both
floors' ms, the kernel's, and vs_sol against each floor; then the same
turns again as device time alone (graph_ms: the calls replayed from one
CUDA graph, so the host's launch time is out of the loop), with vs_sol
from those. With --ablate the ablated floor takes the parent floor's place,
driven through the current wrapper.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

__all__ = ["main", "build_parent", "parent_launcher", "ablated_source",
           "class_parent", "CASES", "KERNELS", "PARENT_ARGTYPES",
           "CLASS_ARGTYPES", "ABLATIONS"]

KERNELS = ("fsr_fused", "nis_scaler", "cas_upscale", "nis_sharpen",
           "cas_sharpen", "rcas_sharpen", "vmem_rate", "mxu_rate",
           "dma_floor")
PROBE_KERNELS = ("vmem_rate", "mxu_rate")
SHARPEN_KERNELS = ("nis_sharpen", "cas_sharpen", "rcas_sharpen")
_MAIN = [(f"rs0.75 radius {r}", 1869, 1683, 0.75, r, 0, 1.0)
         for r in (0.0, 0.5, 2.0)]
_SHARPEN = [(f"rs1 radius {r}", 2492, 2244, 1.0, r, 0, 1.0)
            for r in (0.0, 0.5, 2.0)]
# kernel -> [(label, in_h, in_w, render_scale, radius, hdr_mode,
# max_color_delta)]
CASES = {
    "fsr_fused": _MAIN + [("rs1.3 radius 0.5", 2492, 2244, 1.3, 0.5, 0, 1.0)],
    "nis_scaler": _MAIN + [("rs0.75 radius 0.5 hdr 1", 1869, 1683, 0.75,
                            0.5, 1, 1.0)],
    "cas_upscale": _MAIN + [("rs1.3 radius 0.5", 2492, 2244, 1.3, 0.5, 0,
                             1.0)],
    "nis_sharpen": _SHARPEN + [("rs1 radius 0.5 hdr 1", 2492, 2244, 1.0,
                                0.5, 1, 1.0)],
    "cas_sharpen": _SHARPEN + [("rs1 radius 2.0 max_color_delta 0.05", 2492,
                                2244, 1.0, 2.0, 0, 0.05)],
    "rcas_sharpen": _SHARPEN + [("rs1 radius 0.3", 2492, 2244, 1.0, 0.3, 0,
                                 1.0)],
}
SHARPNESS = 0.9
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the upscalers' class-kernel entry point before the row-band strips
# (fsr_fused_launch, cas_upscale_launch): img, out, the four sample maps,
# the window origins, group_cls, the inside list and its length, the outside
# list and its length, batch, in_h, in_w, rows, pitch, out_h, out_w, sharp,
# tint, tile, window, stream
CLASS_ARGTYPES = [_P] * 10 + [_I, _P] + [_I] * 8 + [_F] * 2 + [_I] * 2 + [_P]
PARENT_ARGTYPES = {
    "fsr_fused": CLASS_ARGTYPES,
    "nis_scaler": [_P] * 11 + [_I] * 9 + [_F] + [_I] * 2 + [_P],
    "cas_upscale": [_P] * 9 + [_I] * 7 + [_F] * 2 + [_I, _P],
    "nis_sharpen": [_P] * 4 + [_I] * 7 + [_F, _P],
    "cas_sharpen": [_P] * 3 + [_I] * 5 + [_F] * 3 + [_P],
    "rcas_sharpen": [_P] * 3 + [_I] * 5 + [_F] * 2 + [_P],
    "vmem_rate": [_P] * 3 + [_I] * 5 + [_P],
    "mxu_rate": [_P] * 4 + [_I] * 3 + [_P],
    "dma_floor": [_P] * 9 + [_I] * 15 + [ctypes.c_uint, _P],
}
# the earlier vmem_rate source's shares at the audit's k and steps: as many
# 130-thread CTAs of one column (58 KB at k 112) as fit on 132 SMs at once
PARENT_VMEM_SHARES = 3
# the earlier sources' tile and window shapes, (width, height)
NIS_PARENT_TILE, NIS_PARENT_WINDOW = (32, 24), (40, 32)
CAS_PARENT_TILE, CAS_PARENT_WINDOW = 16, 20
# kernel -> ablation -> (keeps the bits, [(text of csrc/<kernel>.cu, what
# replaces it)]); each text occurs once in the source
ABLATIONS = {
    "nis_scaler": {
        "noslide": (True, [("if (pyi == cur + 1) {", "if (false) {")]),
    },
    "cas_upscale": {
        "nostage": (False, [("for (int i = tid; i < kWin * kWin; "
                             "i += kThreads) {",
                             "for (int i = tid; i < 0; i += kThreads) {")]),
        "noload": (False, [("? img[static_cast<size_t>(y) * p.pitch + x]",
                            "? Texel{static_cast<uint32_t>(i) * 2654435761u}"
                            )]),
    },
    "nis_sharpen": {
        "noslide": (True, [("i = (r == 0 ? 0 : 4)", "i = 0")]),
    },
    "cas_sharpen": {
        "noslide": (True, [("k = (r == 0 ? 0 : 2)", "k = 0")]),
        "nostage": (False, [("for (int i = tid; i < kWin * kWin; "
                             "i += kThreads) {",
                             "for (int i = tid; i < 0; i += kThreads) {")]),
    },
    "rcas_sharpen": {
        "noslide": (True, [("const bool load_top = r == 0;",
                            "const bool load_top = true;")]),
    },
    "vmem_rate": {
        "onegroup": (True, [("return kMaxThreads / th_e;", "return 1;")]),
        "predicated": (True, [("const int pairs = k / 8;",
                               "const int pairs = 0;")]),
        "nounroll": (True, [("#pragma unroll 4", "#pragma unroll 1")]),
    },
    "dma_floor": {
        "nopersist": (True, [("(boxes < ctas ? boxes : ctas)", "boxes")]),
    },
}
# kernel -> the name of its wrapper module's entry-point getter
_ENTRIES = {"fsr_fused": "_launch_fn", "nis_scaler": "_scaler_fn",
            "cas_upscale": "_upscale_launch_fn",
            "nis_sharpen": "_sharpen_fn", "cas_sharpen": "_sharpen_launch_fn",
            "rcas_sharpen": "_launch_fn", "vmem_rate": "_probe_launch",
            "mxu_rate": "_probe_launch", "dma_floor": "_launch_fn"}


def _wrapper_module(kernel):
    from ..kernels import cas, fsr, nis, rcas, sol
    return {"fsr_fused": fsr, "rcas_sharpen": rcas, "vmem_rate": sol,
            "mxu_rate": sol, "dma_floor": sol}.get(
        kernel, cas if kernel.startswith("cas") else nis)


def build_parent(kernel, source, argtypes=None):
    """(the parent's ctypes entry point, its ptxas usage, the library's
    path) from its source, built into a temporary directory with the port's
    flags and headers; bound with `argtypes` (default: the earlier
    source's, PARENT_ARGTYPES)."""
    from ..kernels import _build
    from . import sass

    lib = Path(tempfile.mkdtemp(prefix=f"{kernel}_parent_")) / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(lib), str(source)]
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=_build.NVCC_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc exited {r.returncode}:\n{r.stdout}{r.stderr}")
    f = getattr(ctypes.CDLL(str(lib)), f"{kernel}_launch")
    f.argtypes = PARENT_ARGTYPES[kernel] if argtypes is None else argtypes
    f.restype = ctypes.c_int
    return f, sass.ptxas_usage(r.stdout + r.stderr), lib


def entry_params(kernel, text):
    """The number of parameters of <kernel>_launch in the source `text`, or
    None where it has no such entry point."""
    m = re.search(rf'extern "C" int {kernel}_launch\((.*?)\)\s*\{{', text,
                  re.S)
    return None if m is None else len(m.group(1).split(","))


def class_parent(kernel, text):
    """Whether the earlier source `text` of an upscaler (fsr_fused,
    cas_upscale) exports <kernel>_launch with the class kernels' prototype
    before the strips (CLASS_ARGTYPES' parameter count): B1's always has
    it; B5's had it from the class kernels on, one CTA per 16x16 tile
    before."""
    if kernel == "fsr_fused":
        return True
    return kernel == "cas_upscale" and \
        entry_params(kernel, text) == len(CLASS_ARGTYPES)


def _current_entry(kernel):
    """The current wrapper's ctypes entry point of `kernel` (built)."""
    getter = getattr(_wrapper_module(kernel), _ENTRIES[kernel])
    return getter("vmem_rate", 3, 5) if kernel == "vmem_rate" else getter()


def same_sass(lib_a, lib_b):
    """{function: whether its SASS is the same instruction for instruction
    in both libraries (None where lib_b lacks it)} over lib_a's functions,
    matched by name less the anonymous namespace (whose name hashes the
    source's path); None without cuobjdump."""
    from ..kernels import _build
    from . import sass
    texts = [sass.disassemble(lib, _build._nvcc()) for lib in (lib_a, lib_b)]
    if None in texts:
        return None

    def key(fn):
        m = re.match(r"_ZN(\d+)(?=_GLOBAL__N_)", fn)
        return fn if m is None else fn[m.end() + int(m.group(1)):]
    a, b = ({key(fn): [t for _, t in ins]
             for fn, ins in sass._functions(t).items()} for t in texts)
    return {fn: None if fn not in b else ins == b[fn] for fn, ins in a.items()}


def ablated_source(kernel, name, text):
    """The source text of csrc/<kernel>.cu with ablation `name` applied;
    raises ValueError if an edit's text does not occur exactly once."""
    for old, new in ABLATIONS[kernel][name][1]:
        if text.count(old) != 1:
            raise ValueError(f"{kernel} {name}: {old!r} occurs "
                             f"{text.count(old)} times in the source")
        text = text.replace(old, new)
    return text


def _build_ablated(kernel, name):
    """(the ablated build's entry point bound like the current one, its
    ptxas usage, the library's path)."""
    from ..kernels import _build

    current = _current_entry(kernel)
    src = Path(tempfile.mkdtemp(prefix=f"{kernel}_{name}_")) / f"{kernel}.cu"
    src.write_text(ablated_source(kernel, name, (
        _build.CSRC / f"{kernel}.cu").read_text()))
    return build_parent(kernel, src, current.argtypes)


def _through_entry(kernel, entry, fn):
    """fn(*args) with the wrapper's entry point swapped for `entry` during
    the call."""
    module, getter = _wrapper_module(kernel), _ENTRIES[kernel]

    def run(*args):
        saved = getattr(module, getter)
        setattr(module, getter, lambda *_: entry)
        try:
            return fn(*args)
        finally:
            setattr(module, getter, saved)
    return run


def _build_current(kernel, batch, h, w, ow, oh, cen, hdr, mcd=1.0):
    """(the current kernel function, its host tables, the constants the
    parent takes)."""
    from ..core import constants as C
    from ..core.foveation import TILE_FSR, TILE_NIS_SHARPEN
    from ..kernels import cas, fsr, nis, rcas
    from ..kernels._maps import (cas_upscale_maps, fsr_maps, nvscaler_maps,
                                 sharpen_maps)

    if kernel == "cas_sharpen":
        fn = cas.build_cas_sharpen(batch, h, w, sharpness=SHARPNESS,
                                   centres=cen, max_color_delta=mcd)
        return fn, sharpen_maps(batch, h, w, cen, TILE_FSR), dict(
            sharp=cas.cas_setup(SHARPNESS), mcd=mcd)
    if kernel == "rcas_sharpen":
        fn = rcas.build_rcas_sharpen(batch, h, w, sharpness=SHARPNESS,
                                     centres=cen)
        return fn, sharpen_maps(batch, h, w, cen, TILE_FSR), dict(
            sharp=C.fsr_rcas_con(C.rcas_stops_from_slider(SHARPNESS)))
    if kernel == "nis_sharpen":
        cfg = C.nvsharpen_update_config(SHARPNESS, w, h, w, h, hdr_mode=hdr)
        fn = nis.build_nvsharpen(batch, h, w, nis_cfg=cfg, centres=cen)
        return fn, sharpen_maps(batch, h, w, cen, TILE_NIS_SHARPEN), dict(
            consts=nis._consts(cfg), hdr_mode=hdr)

    if kernel == "fsr_fused":
        fn = fsr.build_fsr_fused(batch, h, w, ow, oh, sharpness=SHARPNESS,
                                 centres=cen)
        return fn, fsr_maps(batch, h, w, ow, oh, cen), dict(
            sharp=C.fsr_rcas_con(C.rcas_stops_from_slider(SHARPNESS)))
    if kernel == "cas_upscale":
        fn = cas.build_cas_upscale(batch, h, w, ow, oh, sharpness=SHARPNESS,
                                   centres=cen)
        return fn, cas_upscale_maps(batch, h, w, ow, oh, cen), dict(
            sharp=cas.cas_setup(SHARPNESS))
    cfg = C.nvscaler_update_config(SHARPNESS, w, h, w, h, ow, oh, ow, oh,
                                   hdr_mode=hdr)
    fn = nis.build_nvscaler(batch, h, w, ow, oh, nis_cfg=cfg, centres=cen)
    return fn, nvscaler_maps(batch, h, w, ow, oh, cfg, cen), dict(
        consts=nis._consts(cfg), hdr_mode=hdr)


def _parent_origins(kernel, m):
    """Per-tile window origins (x, y) of the earlier source's shapes, from
    the current maps: NVScaler's 6x6 luma taps per 32x24 block, CAS's taps
    and clamped bilinear taps per 16x16 tile."""
    from ..kernels._maps import _footprint_origins

    axes = ((m.col_i, m.in_w), (m.row_i, m.in_h))
    if kernel == "nis_scaler":
        return [_footprint_origins(np.clip(i[0] - 2, 0, n - 1),
                                   np.clip(i[0] + 3, 0, n - 1), tile, 0, cap)
                for (i, n), tile, cap in zip(axes, NIS_PARENT_TILE,
                                             NIS_PARENT_WINDOW)]
    return [_footprint_origins(
        np.minimum(i[0] - 1, np.clip(i[1], 0, n - 1)),
        np.maximum(i[0] + 2, np.clip(i[1] + 1, 0, n - 1)),
        CAS_PARENT_TILE, 0, CAS_PARENT_WINDOW) for i, n in axes]


def parent_launcher(kernel, entry, maps, batch, device, sharp=None,
                    consts=None, hdr_mode=0, tint=1.0, mcd=1.0,
                    classes=None):
    """fn(img) running the parent kernel `entry` with the tables it was
    written for, made from `maps` (the current build's host tables).
    classes: an upscaler parent with the class kernels' entry point before
    the strips (CLASS_ARGTYPES; default: B1's parent only)."""
    from ..kernels._maps import CAS_IN_TILE, FSR_TILE, IN_TILE

    m = maps
    d = m.to(device)

    def stream():
        return torch.cuda.current_stream(device).cuda_stream

    if kernel in SHARPEN_KERNELS:   # the centres; each CTA tests its tile
        def run_sharpen(img):
            out = torch.empty((batch, m.h, m.w), dtype=torch.int32,
                              device=device)
            head = (img.data_ptr(), out.data_ptr(), d.centres.data_ptr())
            rows, pitch = img.shape[1:]
            if kernel == "cas_sharpen":
                err = entry(*head, batch, m.h, m.w, rows, pitch, float(sharp),
                            float(mcd), float(tint), stream())
            elif kernel == "rcas_sharpen":
                err = entry(*head, batch, m.h, m.w, rows, pitch, float(sharp),
                            float(tint), stream())
            else:
                err = entry(*head, consts.ctypes.data, consts.size, batch,
                            m.h, m.w, rows, pitch, int(hdr_mode), float(tint),
                            stream())
            if err != 0:
                raise RuntimeError(f"parent {kernel}_launch: cudaError {err}")
            return out
        return run_sharpen

    H, W, OH, OW = m.in_h, m.in_w, m.out_h, m.out_w
    classes = kernel == "fsr_fused" if classes is None else classes
    if not classes:
        x0, y0 = (torch.as_tensor(o, device=device)
                  for o in _parent_origins(kernel, m))

    def run(img):
        out = torch.empty((batch, OH, OW), dtype=torch.int32, device=device)
        maps_ptrs = (img.data_ptr(), out.data_ptr(), d.col_i.data_ptr(),
                     d.col_f.data_ptr(), d.row_i.data_ptr(),
                     d.row_f.data_ptr())
        rows, pitch = img.shape[1:]
        if classes:
            err = entry(*maps_ptrs, d.tile_x0.data_ptr(),
                        d.tile_y0.data_ptr(), d.group_cls.data_ptr(),
                        d.inside_tiles.data_ptr(), len(m.inside_tiles),
                        d.outside_tiles.data_ptr(), len(m.outside_tiles),
                        batch, H, W, rows, pitch, OH, OW, float(sharp),
                        float(tint), FSR_TILE,
                        IN_TILE if kernel == "fsr_fused" else CAS_IN_TILE,
                        stream())
        elif kernel == "nis_scaler":
            err = entry(*maps_ptrs, x0.data_ptr(), y0.data_ptr(),
                        d.centres.data_ptr(), d.coef.data_ptr(),
                        consts.ctypes.data, consts.size, batch, H, W, rows,
                        pitch, OH, OW, int(hdr_mode), float(tint),
                        *NIS_PARENT_WINDOW, stream())
        else:
            err = entry(*maps_ptrs, x0.data_ptr(), y0.data_ptr(),
                        d.centres.data_ptr(), batch, H, W, rows, pitch, OH,
                        OW, float(sharp), float(tint), CAS_PARENT_WINDOW,
                        stream())
        if err != 0:
            raise RuntimeError(f"parent {kernel}_launch: cudaError {err}")
        return out
    return run


def _best_ms(fn, inputs, iters):
    from ..utils.timing import rotation_ms
    rotation_ms(fn, inputs, 5)
    return min(rotation_ms(fn, inputs, iters) for _ in range(3))


def _graph_ms(fn, inputs, iters):
    """Device ms per call with no host in the loop: `iters` calls over the
    rotating inputs captured in one CUDA graph, the best of 5 replays."""
    from ..utils.timing import replay_ms, rotation_graph
    graph = rotation_graph(fn, inputs, iters)
    return min(replay_ms(graph, iters) for _ in range(5))


# the opcodes each probe's A/B line counts per loop of its SASS
_LOOP_OPS = {"vmem_rate": ("LDS",), "mxu_rate": ("HMMA", "HGMMA", "LDSM")}


def _sass_loops(lib, kernel):
    """[(instructions, {opcode: count})] of each loop of the probe kernel's
    function in a built library's SASS, shortest first, or None without
    cuobjdump."""
    from ..kernels import _build
    from . import sass
    text = sass.disassemble(lib, _build._nvcc())
    if text is None:
        return None
    return [(sum(ops.values()), {o: ops[o] for o in _LOOP_OPS[kernel]})
            for fn, found in sass.loops(text).items()
            if f"{kernel}_kernel" in fn for _, _, _, ops in found]


def _probe_rates(kernel, entry, dev, iters, shares=None):
    """A rate probe's A/B at the audit's full settings: {"parent": [records],
    "current": [records]}, each the audit's paired-slope record, timed in
    turns parent, current, current, parent; `entry` (the parent or ablated
    launch) runs through the current wrapper, for vmem_rate with `shares`.
    Exits 1 if either build's hi call disagrees with the plain version
    (vmem_rate: bit for bit; mxu_rate: within sol.MXU_TOLERANCE)."""
    from ..kernels import sol
    from . import vpu_audit

    rng = np.random.default_rng(0)
    if kernel == "vmem_rate":
        k_lo, k_hi, steps = vpu_audit.PROBES["vmem"][0]
        planes = torch.from_numpy(rng.random((k_hi, 130, 128),
                                             np.float32)).to(dev)
        args = {k_lo: (planes[:k_lo].contiguous(),), k_hi: (planes,)}

        def build(k, parent):
            return sol.build_vmem_rate(k, steps=steps,
                                       shares=shares if parent else None)

        def work(f):
            return f.bytes_per_step * f.steps
    else:
        k_lo, k_hi, steps = vpu_audit.PROBES["mxu"][0]
        x = torch.from_numpy(rng.random((128, 128), np.float32)).to(dev)
        w = torch.from_numpy(rng.random((128, 128), np.float32)
                             * 0.1).to(dev)
        args = {k_lo: (x, w), k_hi: (x, w)}

        def build(k, parent):
            return sol.build_mxu_rate(k, steps=steps)

        def work(f):
            return f.macs

    def through(fn):          # fn with its launch through `entry`
        run = _through_entry(kernel, entry, fn)
        run.k, run.steps, run.reference = fn.k, fn.steps, fn.reference
        run.bytes_per_step = getattr(fn, "bytes_per_step", None)
        run.macs = getattr(fn, "macs", None)
        return run

    builds = {"parent": [through(build(k, True)) for k in (k_lo, k_hi)],
              "current": [build(k, False) for k in (k_lo, k_hi)]}
    for name, (_, hi) in builds.items():
        got, want = hi(*args[k_hi]), hi.reference(*args[k_hi])
        if kernel == "vmem_rate":
            ne = int((got != want).sum())
            error = ne and f"{ne} of 1024 outputs unequal"
        else:
            err, top = float((got - want).abs().max()), float(want.abs().max())
            error = (err > sol.MXU_TOLERANCE * top
                     and f"max abs err {err} above {sol.MXU_TOLERANCE} x "
                         f"{top}")
        if error or not bool(torch.isfinite(got).all()):
            print(json.dumps({"metric": "ab", "kernel": kernel, "error":
                              f"{name} probe: {error or 'not finite'} "
                              "against the plain version"}))
            sys.exit(1)
    rounds = {"parent": [], "current": []}
    for name in ("parent", "current", "current", "parent"):
        rec = vpu_audit._measure_rate(builds[name], lambda f: args[f.k],
                                      work, iters=iters)
        rounds[name].append(rec)
    return rounds


def parent_floor(entry, geom, device):
    """fn(img) running the earlier DMA floor `entry` (one CTA per tile in
    the compute kernel's launch shape) with the tables it was written for,
    made from `geom`: window origins, taps (null where the identity), the
    four-tap floors (stage "list"), the staged table."""
    from ..kernels import sol

    g = geom
    B, H, W, OH, OW = g["batch"], g["in_h"], g["in_w"], g["out_h"], g["out_w"]
    (tw, th), (ww, wh) = g["tile"], g["window"]
    identity = sol._identity_taps(g)

    def table(a, dtype=np.int32):
        return (None if a is None else
                torch.as_tensor(np.ascontiguousarray(a, dtype), device=device))

    t = {name: table(g[name]) for name in ("tile_x0", "tile_y0")}
    t.update(tap_x=None if identity else table(g["tap_x"]),
             tap_y=None if identity else table(g["tap_y"]),
             quad_x=table(g["quad_x"]), quad_y=table(g["quad_y"]),
             staged=table(g["staged"], np.uint8))

    def ptr(name):
        return None if t[name] is None else t[name].data_ptr()

    def run(img):
        out = torch.empty((B, OH, OW), dtype=torch.int32, device=device)
        err = entry(img.data_ptr(), out.data_ptr(), ptr("tile_x0"),
                    ptr("tile_y0"), ptr("tap_x"), ptr("tap_y"), ptr("quad_x"),
                    ptr("quad_y"), ptr("staged"), B, H, W, img.shape[1],
                    img.shape[2], OH, OW, tw, th, ww, wh, g["threads"],
                    {"list": 0, "copy": 1}[g["stage"]], int(g["stage_quads"]),
                    int(g["oob"] == "clamp"), 0,
                    torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent dma_floor_launch: cudaError {err}")
        return out
    return run


def floor_cases():
    """[(label, config, in_h, in_w)]: the seven bench paths at their radius
    and at radius 0.0 and 2.0."""
    from .bench_paths import PATHS, path_config
    cases = []
    for name in PATHS:
        cfg, h, w = path_config(name)
        cases += [(f"{name} radius {r}", cfg.with_(radius=r), h, w)
                  for r in (cfg.radius, 0.0, 2.0)]
    return cases


def _floor_ab(entry, dev, iters, ablated=False):
    """The dma_floor A/B: one record per floor_cases() case; `entry` is
    the earlier floor's (parent_floor), or where `ablated` the ablated
    build's, run through the current wrapper. Exits 1 if either floor
    disagrees with the plain version."""
    from .. import bench
    from ..api.pipeline import Pipeline
    from ..kernels.sol import build_dma_floor

    out = []
    for label, cfg, h, w in floor_cases():
        kernel = Pipeline(cfg, device=dev)._build(2, h, w, (0, 1), True)
        floor = build_dma_floor(kernel.dma_geometry)
        old = (_through_entry("dma_floor", entry, floor) if ablated
               else parent_floor(entry, kernel.dma_geometry, dev))
        inputs = bench.ring_frames(h, w, kernel.pad_to, dev)
        want = floor.reference(inputs[0])
        for name, fn in (("parent", old), ("current", floor)):
            ne = int((fn(inputs[0]) != want).sum())
            if ne:
                print(json.dumps({"metric": "ab", "kernel": "dma_floor",
                                  "error": f"{label}: {name} floor {ne} "
                                  "words unequal to the plain version"}))
                sys.exit(1)
        turns = (("parent", old), ("current", floor), ("kernel", kernel),
                 ("kernel", kernel), ("current", floor), ("parent", old))
        rounds = {"parent": [], "current": [], "kernel": []}
        graphs = {"parent": [], "current": [], "kernel": []}
        for name, fn in turns:
            rounds[name].append(_best_ms(fn, inputs, iters))
        for name, fn in turns:
            graphs[name].append(_graph_ms(fn, inputs, iters))
        ms = {n: float(np.mean(v)) for n, v in rounds.items()}
        gms = {n: float(np.mean(v)) for n, v in graphs.items()}
        case = {"case": label, "parent_ms": rounds["parent"],
                "current_ms": rounds["current"],
                "kernel_ms": rounds["kernel"],
                "parent_over_current": ms["parent"] / ms["current"],
                "vs_sol_parent": ms["parent"] / ms["kernel"],
                "vs_sol_current": ms["current"] / ms["kernel"],
                "graph_ms": graphs,
                "graph_vs_sol_parent": gms["parent"] / gms["kernel"],
                "graph_vs_sol_current": gms["current"] / gms["kernel"],
                "hbm_bytes": floor.hbm_bytes, "read_bytes": floor.read_bytes,
                "current_gbps": floor.hbm_bytes / ms["current"] / 1e6,
                "current_graph_gbps": floor.hbm_bytes / gms["current"] / 1e6}
        out.append(case)
        print(f"[ab] dma_floor {label}: {case}", file=sys.stderr, flush=True)
    return out


def main(argv=None):
    """Run the A/B, print its JSON line and return the record."""
    from .. import bench
    from ..api.pipeline import Pipeline
    from ..core import constants as C
    from ..core.config import Config
    from ..kernels import _build
    from ..kernels._common import occupancy
    from . import sass

    ap = argparse.ArgumentParser(
        prog="python3 -m openvr_fsr_tpu_torch.tools.ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=KERNELS, default="fsr_fused")
    ap.add_argument("--parent", default=None,
                    help="the earlier csrc/<kernel>.cu to compare with")
    ap.add_argument("--ablate", default=None,
                    choices=sorted({n for a in ABLATIONS.values() for n in a}),
                    help="compare with the current source less one part")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    kernel = args.kernel
    if (args.parent is None) == (args.ablate is None):
        ap.error("give one of --parent FILE and --ablate NAME")
    if args.ablate and args.ablate not in ABLATIONS.get(kernel, {}):
        ap.error(f"{kernel} has no ablation {args.ablate!r}")
    bench.require_gpu(["ab"])
    dev = torch.device("cuda", torch.cuda.current_device())
    card = bench.card()
    _build.build([kernel])
    classes = through = None
    if args.ablate:
        entry, parent_usage, parent_lib = _build_ablated(kernel, args.ablate)
        exact = ABLATIONS[kernel][args.ablate][0]
        through = True
    else:
        text = Path(args.parent).read_text()
        # a compute kernel's parent with the current prototype runs through
        # the current wrapper, as an ablation does
        through = kernel in CASES and entry_params(kernel, text) == len(
            _current_entry(kernel).argtypes)
        classes = not through and class_parent(kernel, text)
        entry, parent_usage, parent_lib = build_parent(
            kernel, args.parent,
            _current_entry(kernel).argtypes if through
            else CLASS_ARGTYPES if classes else None)
        exact = True
    usage = sass.ptxas_usage(
        _build.library_path(kernel).with_suffix(".log").read_text())
    rec = {"metric": "ab", "kernel": kernel, "device": card,
           "iters": args.iters, "parent": str(args.parent or
                                              f"ablate {args.ablate}"),
           "ptxas_parent": parent_usage, "ptxas_current": usage,
           "sass_same": same_sass(parent_lib, _build.library_path(kernel)),
           "cases": []}
    if kernel in PROBE_KERNELS:
        from . import vpu_audit
        from ..kernels import sol
        shares = None
        if kernel == "vmem_rate":
            _, k_hi, steps = vpu_audit.PROBES["vmem"][0]
            shares = (sol.vmem_rate_shares(k_hi, steps=steps)
                      if args.ablate and args.ablate != "onegroup"
                      else PARENT_VMEM_SHARES)
        bound = (vpu_audit.smem_bytes_per_s if kernel == "vmem_rate"
                 else vpu_audit.tensor_macs_per_s)(
            torch.cuda.get_device_properties(dev).multi_processor_count,
            float(vpu_audit._smi("clocks.max.sm") or "nan") * 1e6)
        rounds = _probe_rates(kernel, entry, dev, iters=5, shares=shares)
        rate = {n: [r["rate"] for r in rs] for n, rs in rounds.items()}
        rec.update(
            parent_shares=shares, bound=bound,
            sass_loops_parent=_sass_loops(parent_lib, kernel),
            sass_loops_current=_sass_loops(_build.library_path(kernel),
                                           kernel),
            parent_rate=rate["parent"], current_rate=rate["current"],
            parent_share_of_bound=[r / bound for r in rate["parent"]],
            current_share_of_bound=[r / bound for r in rate["current"]],
            parent_hi_ms=[r["hi_ms"] for r in rounds["parent"]],
            current_hi_ms=[r["hi_ms"] for r in rounds["current"]],
            spreads={n: [r["spread"] for r in rs]
                     for n, rs in rounds.items()},
            current_over_parent=float(np.mean(rate["current"])
                                      / np.mean(rate["parent"])))
        rec.pop("cases")
        return _emit(rec, args.out)
    if kernel == "dma_floor":
        rec["cases"] = _floor_ab(entry, dev, args.iters, bool(args.ablate))
        return _emit(rec, args.out)
    rec["ctas_per_sm_current"] = occupancy(kernel)
    print(f"[ab] {kernel} on {card}; parent {parent_usage}; current {usage}, "
          f"CTAs per SM {rec['ctas_per_sm_current']}", file=sys.stderr,
          flush=True)
    for label, h, w, rs, radius, hdr, mcd in CASES[kernel]:
        ow, oh = Config(render_scale=rs).output_size(w, h)
        cen = C.centres_payload(ow, oh, radius, Pipeline(device="cpu")
                                .eye_centers, (0, 1))
        new, maps, kw = _build_current(kernel, 2, h, w, ow, oh, cen, hdr,
                                       mcd)
        old = (_through_entry(kernel, entry, new) if through else
               parent_launcher(kernel, entry, maps, 2, dev, classes=classes,
                               **kw))
        inputs = bench.ring_frames(h, w, new.pad_to, dev)
        want = new.reference(inputs[0])
        for name, fn in (("parent", old), ("current", new)):
            if name == "parent" and not exact:
                continue
            ne = int((fn(inputs[0]) != want).sum())
            if ne:
                print(json.dumps({"metric": "ab", "kernel": kernel, "error":
                                  f"{label}: {name} kernel {ne} texels "
                                  "unequal to the plain version"}))
                sys.exit(1)
        rounds = {"parent": [], "current": []}
        for name, fn in (("parent", old), ("current", new),
                         ("current", new), ("parent", old)):
            rounds[name].append(_best_ms(fn, inputs, args.iters))
        case = {"case": label, "parent_ms": rounds["parent"],
                "current_ms": rounds["current"],
                "parent_over_current": float(np.mean(rounds["parent"])
                                             / np.mean(rounds["current"]))}
        rec["cases"].append(case)
        print(f"[ab] {kernel} {label}: {case}", file=sys.stderr, flush=True)
    return _emit(rec, args.out)


def _emit(rec, out):
    """Print the record's JSON line, also write it to `out`, return it."""
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
