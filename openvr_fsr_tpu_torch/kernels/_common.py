"""What every kernel wrapper of the port shares: the packed-RGBA8 codec of
the plain versions, the foveation circle test, and the launch wrapper.

A frame is a (B, H, W) int32 plane of packed RGBA8 texels (little-endian,
R in the low byte). The plain versions decode it to f32 planes exactly as
the CUDA kernels do (u * f32(1/255)) and encode with clamp, *255 and round
half to even, as the reference's UNORM store does.
"""

import numpy as np
import torch

__all__ = ["unpack", "pack", "circle_mask", "debug_tint", "tint_vector",
           "DeviceTables", "centres_table", "kernel_fn"]

F32 = np.float32
_INV255 = float(F32(1.0) / F32(255.0))


def unpack(img, channels=4):
    """(B, H, W) int32 packed RGBA8 -> (B, channels, H, W) f32 texels
    decoded as u * f32(1/255); channels 3 drops alpha."""
    return torch.stack([((img >> (8 * c)) & 255).to(torch.float32)
                        for c in range(channels)], dim=-3) * _INV255


def _unorm8(x):
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.int64)


def pack(rgb, alpha=None):
    """(B, 3, H, W) f32 RGB and (B, H, W) f32 alpha (None: 1) -> (B, H, W)
    int32 packed RGBA8: clamp, *255, round half to even per channel."""
    q = _unorm8(rgb)
    a = 255 if alpha is None else _unorm8(alpha)
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


def centres_table(batch, centres):
    """The (batch, 5) int64 foveation rows of a build, per device."""
    return DeviceTables(np.ascontiguousarray(
        np.asarray(centres, np.int64).reshape(int(batch), 5)))


def kernel_fn(name, batch, shape, pad_to, reference, launch):
    """The function a kernel build returns.

    fn(img) takes a contiguous (batch, *shape) int32 tensor, or one
    pre-padded to the ring pitch `pad_to` (read in place). A CPU tensor
    runs `reference(img)`, the plain torch version; a CUDA tensor runs
    `launch(img)`, which returns (out, cudaError), and raises if the error
    is not 0. Nothing falls back. fn.launches counts CUDA launches;
    fn.reference and fn.pad_to are published."""
    B, (H, W), pad_to = int(batch), tuple(shape), tuple(pad_to)

    def fn(img):
        if not isinstance(img, torch.Tensor) or img.dtype != torch.int32:
            raise TypeError(f"{name} takes an int32 tensor of packed RGBA8 "
                            f"texels, got {type(img).__name__} "
                            f"{getattr(img, 'dtype', '')}")
        if img.ndim != 3 or img.shape[0] != B or \
                tuple(img.shape[1:]) not in ((H, W), pad_to):
            raise ValueError(
                f"frame shape {tuple(img.shape)} matches neither the build "
                f"shape {(B, H, W)} nor the pre-padded pitch {(B, *pad_to)}")
        if not img.is_contiguous():
            raise ValueError(f"{name} takes a contiguous frame tensor")
        dev = img.device
        if dev.type == "cpu":
            return reference(img)
        if dev.type != "cuda":
            raise ValueError(f"{name} has no path for device {dev}")
        with torch.cuda.device(dev):
            out, err = launch(img)
        if err != 0:
            raise RuntimeError(f"{name}_launch failed: cudaError {err}")
        fn.launches += 1
        return out

    fn.launches = 0
    fn.pad_to = pad_to
    fn.reference = reference
    return fn
