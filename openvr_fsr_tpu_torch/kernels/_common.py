"""What every kernel wrapper of the port shares: the texel codecs of the
plain versions, the foveation circle test, the launch wrapper and the
class kernels' launch binder.

A frame is, at color_bits=8, a (B, H, W) int32 plane of packed RGBA8
texels (little-endian, R in the low byte); at color_bits=10 (R10G10B10A2,
the reference's other output format, PostProcessor.cpp:63-74) a
(B, H, W, 4) uint16 tensor, RGB in [0, 1023] and alpha in [0, 3]. The
plain versions decode either to f32 planes exactly as the CUDA kernels do
(csrc/codec.cuh: u * f32(1/255); RGB u * f32(1/1023), alpha a * f32(1/3),
the whole 16-bit value) and encode with clamp, scale and round half to
even, as the reference's UNORM store does.
"""

import ctypes

import numpy as np
import torch

from ..ops.common import HALF
from ..utils import trace
from . import _build

__all__ = ["unpack", "pack", "circle_mask", "debug_tint", "tint_vector",
           "DeviceTables", "kernel_fn", "band_fn", "class_launch",
           "UPSCALE_TABLES", "pointers", "tile_lists", "occupancy",
           "band_occupancy", "entry_name", "texel_words", "working_type", "PRECISIONS"]

F32 = np.float32
_INV255 = float(F32(1.0) / F32(255.0))
_INV1023 = float(F32(1.0) / F32(1023.0))
_INV3 = float(F32(1.0) / F32(3.0))


def unpack(img, channels=4, color_bits=8):
    """A frame -> (B, channels, H, W) f32 texels; channels 3 drops alpha.
    color_bits 8: (B, H, W) int32 packed RGBA8, decoded as u * f32(1/255);
    10: (B, H, W, 4) uint16, RGB decoded as u * f32(1/1023) and alpha as
    a * f32(1/3) (utils/frames.py::to_planar)."""
    if color_bits == 10:
        x = img[..., :channels].to(torch.int32).to(torch.float32)
        x = x.permute(0, 3, 1, 2)
        if channels == 4:
            return torch.cat([x[:, :3] * _INV1023, x[:, 3:] * _INV3], dim=1)
        return x * _INV1023
    return torch.stack([((img >> (8 * c)) & 255).to(torch.float32)
                        for c in range(channels)], dim=-3) * _INV255


def _unorm(x, scale):
    return torch.round(torch.clamp(x, 0.0, 1.0) * scale).to(torch.int64)


def pack(rgb, alpha=None, color_bits=8):
    """(B, 3, H, W) f32 RGB and (B, H, W) f32 alpha (None: 1) -> a frame:
    clamp, scale, round half to even per channel. color_bits 8: (B, H, W)
    int32 packed RGBA8; 10: (B, H, W, 4) uint16, RGB * 1023 and alpha * 3
    (utils/frames.py::from_planar)."""
    if color_bits == 10:
        q = _unorm(rgb, 1023.0)
        a = torch.full_like(q[:, 0], 3) if alpha is None else _unorm(alpha,
                                                                      3.0)
        return torch.stack([q[:, 0], q[:, 1], q[:, 2], a], dim=-1).to(
            torch.int32).to(torch.uint16)
    q = _unorm(rgb, 255.0)
    a = 255 if alpha is None else _unorm(alpha, 255.0)
    v = q[:, 0] + (q[:, 1] << 8) + (q[:, 2] << 16) + (a << 24)
    return (v - ((v >> 31) << 32)).to(torch.int32)   # u32 bits as int32


def circle_mask(centres, out_h, out_w, tile=(16, 16)):
    """(B, out_h, out_w) bool: the reference's per-workgroup circle test
    (fsr_easu.hlsl:41-45, NIS_Upscale.hlsl:95-107; core/foveation.py::
    tile_mask) for (width, height) tiles, from (B, 5) int64 centres rows,
    in int64 on the centres' device."""
    tw, th = tile
    dev = centres.device
    gx = torch.div(torch.arange(out_w, device=dev), tw,
                   rounding_mode="floor") * tw + tw // 2
    gy = torch.div(torch.arange(out_h, device=dev), th,
                   rounding_mode="floor") * th + th // 2
    c = centres[:, :, None, None]
    d1 = (c[:, 0] - gx) ** 2 + (c[:, 1] - gy[:, None]) ** 2
    d2 = (c[:, 2] - gx) ** 2 + (c[:, 3] - gy[:, None]) ** 2
    return (d1 <= c[:, 4]) | (d2 <= c[:, 4])


def debug_tint(debug):
    """The out-of-circle G/B multiplier: 0.7 in debug mode, else 1."""
    return F32(0.7) if debug else F32(1.0)


def tint_vector(tint, device):
    """(3, 1, 1) f32 out-of-circle multiplier 1 - debug*(0, .3, .3)
    (fsr_rcas.hlsl:46, NIS DirectCopy) from the G/B factor."""
    return torch.tensor([1.0, float(tint), float(tint)], dtype=torch.float32,
                        device=device)[:, None, None]


class DeviceTables:
    """A build's host tables (a numpy array, or an object with
    .to(device)), moved to each device once."""

    def __init__(self, tables):
        self.host = tables
        self._on = {}

    def on(self, device):
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = (
                torch.as_tensor(self.host, device=device)
                if isinstance(self.host, np.ndarray) else self.host.to(device))
        return t


def kernel_fn(name, batch, shape, pad_to, reference, launch, geometry=None,
              color_bits=8, precision="full", work=None):
    """The function a kernel build returns.

    fn(img) takes a contiguous (batch, *shape) int32 tensor of packed RGBA8
    (color_bits 8) or (batch, *shape, 4) uint16 tensor of R10G10B10A2
    texels (color_bits 10), or one pre-padded to the ring pitch `pad_to`
    (read in place). A CPU tensor runs `reference(img)`, the plain torch
    version; a CUDA tensor runs `launch(img)`, which returns (out,
    cudaError), and raises if the error is not 0. Nothing falls back.
    Each launch is a `launch` span (utils/trace.py), cold on the first;
    one that returned 0 puts `name` (`fn`) and `work` in its record's info
    and counts them (utils/trace.py::count_launch). work
    (kernels/_maps.py::launch_work) is what one call computes: the CUDA
    kernels it enqueues (`kernels`) and its outputs inside and outside
    the circle (`inside`, `outside`). fn.launches counts CUDA launches;
    fn.launch, fn.reference, fn.pad_to, fn.color_bits and fn.precision
    are published, and fn.dma_geometry when `geometry` (kernels/_maps.py::
    dma_geometry, in 4-byte words: word_geometry at 10 bits) is given: that
    dict with batch, in_h, in_w and the ring pitch hp, wp added, in words,
    which kernels/sol.py::build_dma_floor consumes."""
    B, (H, W), pad_to = int(batch), tuple(shape), tuple(pad_to)
    ten = texel_words(color_bits) == 2
    dtype, texel = ((torch.uint16, (4,)) if ten else (torch.int32, ()))

    def fn(img):
        if not isinstance(img, torch.Tensor) or img.dtype != dtype:
            raise TypeError(
                f"{name} takes a {dtype} tensor of "
                f"{'R10G10B10A2' if ten else 'packed RGBA8'} texels, got "
                f"{type(img).__name__} {getattr(img, 'dtype', '')}")
        if img.ndim != 3 + len(texel) or img.shape[0] != B or \
                tuple(img.shape[3:]) != texel or \
                tuple(img.shape[1:3]) not in ((H, W), pad_to):
            raise ValueError(
                f"frame shape {tuple(img.shape)} matches neither the build "
                f"shape {(B, H, W, *texel)} nor the pre-padded pitch "
                f"{(B, *pad_to, *texel)}")
        if not img.is_contiguous():
            raise ValueError(f"{name} takes a contiguous frame tensor")
        dev = img.device
        if dev.type == "cpu":
            return reference(img)
        if dev.type != "cuda":
            raise ValueError(f"{name} has no path for device {dev}")
        nonlocal first
        sp = trace.span("launch", cold=first)
        if sp is None:
            out, err = _on_device(launch, img, dev)
        else:
            with sp:
                out, err = _on_device(launch, img, dev)
        first = False
        if err != 0:
            raise RuntimeError(f"{name}_launch failed: cudaError {err}")
        fn.launches += 1
        if sp is not None:
            sp.info.update(info)
            trace.count_launch(info)
        return out

    info = dict(work or {}, fn=name)
    first = True     # the first launch binds, uploads and loads: a cold span
    fn.launches = 0
    fn.launch = launch
    fn.pad_to = pad_to
    fn.reference = reference
    fn.color_bits = color_bits
    fn.precision = precision
    if geometry is not None:
        n = geometry.get("texel_words", 1)
        fn.dma_geometry = dict(geometry, batch=B, in_h=H, in_w=W * n,
                               hp=pad_to[0], wp=pad_to[1] * n)
    return fn


def _on_device(launch, img, dev):
    """launch(img) with img's device the current CUDA device."""
    if dev.index == torch.cuda.current_device():
        return launch(img)
    with torch.cuda.device(dev):
        return launch(img)


def class_launch(library, tables, out_shape, head, tail, color_bits,
                 precision="full"):
    """launch(img) -> (out, cudaError) of a class-kernel build (B1-B6): one
    call of the entry point <library>_launch of color_bits and precision
    (entry_name), entry(img, out, *head(m), rows, pitch, *tail, stream).

    out is a new tensor of out_shape (a trailing 4 at color_bits 10) in
    img's dtype on its device; rows and pitch are img.shape[1:3]; stream is
    the device's current one. head(m) is the build's table pointers and
    ints, from its DeviceTables `tables` on img's device m, taken once per
    device at the first launch there; tail is its scalars, already in the
    kernel's types. The entry point is looked up through
    _build.entry_point (cached) at each call."""
    entry = entry_name(f"{library}_launch", color_bits, precision)
    shape = (*out_shape, 4) if color_bits == 10 else tuple(out_shape)
    tail = tuple(tail)
    heads = {}    # device -> head(m)

    def launch(img):
        dev = img.device
        h = heads.get(dev)
        if h is None:
            h = heads[dev] = tuple(head(tables.on(dev)))
        out = torch.empty(shape, dtype=img.dtype, device=dev)
        return out, _build.entry_point(library, entry)(
            img.data_ptr(), out.data_ptr(), *h, img.shape[1], img.shape[2],
            *tail, torch.cuda.current_stream(dev).cuda_stream)
    return launch


# the tables an upscaler's class entry point (fsr_fused_launch,
# cas_upscale_launch) takes before its tile lists: the four sample maps, the
# window origins, group_cls
UPSCALE_TABLES = ("col_i", "col_f", "row_i", "row_f", "tile_x0", "tile_y0",
                  "group_cls")


def pointers(m, *names):
    """The device pointers of the tables `names` of m."""
    return tuple(getattr(m, n).data_ptr() for n in names)


def tile_lists(m):
    """The inside tile list and its length, then the outside list and its
    length: the arguments every class entry point takes for its lists."""
    return (m.inside_tiles.data_ptr(), len(m.inside_tiles),
            m.outside_tiles.data_ptr(), len(m.outside_tiles))


def band_fn(name, batch, strip, pad_to, reference, launch, geometry,
            color_bits, precision, band_range, in_row_base, out_rows,
            work=None):
    """kernel_fn of a row-band build (B1, B5 with band_range): fn(img)
    takes the input strip, (batch, *strip) with strip = (in_rows, in_w),
    or its width padded to the ring pitch pad_to's; publishes band_range,
    in_row_base, in_rows and out_rows (the JAX builders' meaning),
    precision, and the strip's DMA geometry (kernels/_maps.py::
    band_geometry, in words), whose in_h is the strip's rows; work is
    kernel_fn's, over the band's output rows."""
    rows, w = strip
    fn = kernel_fn(name, batch, (rows, w), (rows, pad_to[1]), reference,
                   launch, geometry, color_bits, precision, work)
    fn.band_range = tuple(int(g) for g in band_range)
    fn.in_row_base, fn.in_rows, fn.out_rows = (int(in_row_base), int(rows),
                                               int(out_rows))
    return fn


def texel_words(color_bits):
    """4-byte words per texel: 1 for RGBA8 (color_bits 8), 2 for
    R10G10B10A2 (10); any other color_bits raises ValueError."""
    if color_bits not in (8, 10):
        raise ValueError(f"color_bits={color_bits!r}: 8 (RGBA8) or 10 "
                         "(R10G10B10A2)")
    return 1 if color_bits == 8 else 2


# precision -> the working type of the inside kernels' math: "full" f32,
# "half" bf16 (the JAX package's dt=bfloat16 cores, op by op)
PRECISIONS = {"full": torch.float32, "half": HALF}


def working_type(precision):
    """The torch dtype of `precision` ("full" f32, "half" bf16); any other
    value raises ValueError."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: 'full' (f32) or 'half' "
                         "(bf16)")
    return PRECISIONS[precision]


def entry_name(entry, color_bits, precision="full"):
    """The C entry point of `color_bits` and `precision`: `entry` (RGBA8),
    entry + "10" (R10G10B10A2), and "_h" after either for the half
    instantiation, e.g. fsr_fused_launch10_h."""
    name = entry if color_bits == 8 else f"{entry}{color_bits}"
    return name + ("_h" if precision == "half" else "")


def occupancy(name, color_bits=8, precision="full"):
    """{"outside": n, "inside": n, "inside_smem": bytes} of the class
    kernels `name` (fsr_fused, nis_scaler, cas_upscale, nis_sharpen,
    cas_sharpen, rcas_sharpen) for `color_bits` and `precision` (the half
    instantiations of fsr_fused, cas_upscale, cas_sharpen and
    rcas_sharpen): the CTAs per SM of its two class kernels on the current
    CUDA device (cudaOccupancyMaxActiveBlocksPerMultiprocessor at 256
    threads) and the inside kernel's shared memory per CTA, from its
    <name>_occupancy entry point (entry_name)."""
    f = getattr(_build.load_library(name),
                entry_name(f"{name}_occupancy", color_bits, precision))
    f.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    f.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(3)]
    err = f(*map(ctypes.byref, vals))
    if err != 0:
        raise RuntimeError(f"{name}_occupancy failed: cudaError {err}")
    return dict(zip(("outside", "inside", "inside_smem"),
                    (v.value for v in vals)))


def band_occupancy(name, color_bits=8, precision="full"):
    """CTAs per SM of the band inside kernel of `name` (fsr_fused,
    cas_upscale: the row-band strips' instantiation) for `color_bits` and
    `precision` on the current CUDA device, from its <name>_band_occupancy
    entry point."""
    texel_words(color_bits)
    working_type(precision)
    f = getattr(_build.load_library(name), f"{name}_band_occupancy")
    f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    f.restype = ctypes.c_int
    ctas = ctypes.c_int()
    err = f(int(color_bits), int(precision == "half"), ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"{name}_band_occupancy failed: cudaError {err}")
    return ctas.value
