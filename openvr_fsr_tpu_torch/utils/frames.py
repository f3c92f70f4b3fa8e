"""Frame layout conversion and synthetic test frames.

External layout: (B, H, W, 4) RGBA (uint8, or uint16 for 10-bit, or float).
Internal layout: planar (B, 4, H, W) float32 torch tensors, the layout the
plain ops in ops/ take. The synthetic frames are numpy copies of
openvr_fsr_tpu/utils/frames.py, so both packages see the same inputs.
"""

import numpy as np
import torch

__all__ = [
    "to_planar",
    "from_planar",
    "gradient_frame",
    "checkerboard_frame",
    "zone_plate_frame",
    "noise_frame",
]


def to_planar(frames, color_bits=8, alpha_bits=None):
    """(B?, H, W, C) uint/float tensor -> (B, 4, H, W) float32 in [0,1].

    uint8 decodes as UNORM8 (u * f32(1/255)); uint16 as UNORM with
    `color_bits` for RGB (default 10) and the matching narrow alpha
    (R10G10B10A2: a/3). Missing alpha -> 1. Same f32 ops as the JAX
    package's to_planar.
    """
    x = torch.as_tensor(frames)
    if x.ndim == 3:
        x = x[None]
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) * float(np.float32(1.0 / 255.0))
    elif x.dtype == torch.uint16:
        cb = color_bits if color_bits else 10
        ab = alpha_bits if alpha_bits is not None else (8 if cb == 8 else 2)
        cscale = float(np.float32(1.0 / ((1 << cb) - 1)))
        ascale = float(np.float32(1.0 / ((1 << ab) - 1)))
        xf = x.to(torch.float32)
        if xf.shape[-1] == 4:
            x = torch.cat([xf[..., :3] * cscale, xf[..., 3:] * ascale], dim=-1)
        else:
            x = xf * cscale
    else:
        x = x.to(torch.float32)
    if x.shape[-1] == 3:
        x = torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                                     device=x.device)], dim=-1)
    return x.permute(0, 3, 1, 2).contiguous()


def from_planar(planar, color_bits=8, alpha_bits=None):
    """(B, 4, H, W) float32 -> (B, H, W, 4) integer frame.

    color_bits=8 -> uint8 RGBA8; color_bits=10 -> uint16 R10G10B10 with
    alpha_bits (default 2, R10G10B10A2). Round-to-nearest-even like the D3D11
    UNORM conversion."""
    if alpha_bits is None:
        alpha_bits = 8 if color_bits == 8 else 2
    cscale = float((1 << color_bits) - 1)
    ascale = float((1 << alpha_bits) - 1)
    x = planar.permute(0, 2, 3, 1)
    col = torch.round(torch.clamp(x[..., :3], 0.0, 1.0) * cscale)
    alp = torch.round(torch.clamp(x[..., 3:], 0.0, 1.0) * ascale)
    out = torch.cat([col, alp], dim=-1)
    return out.to(torch.uint8 if color_bits == 8 else torch.uint16)


# --- synthetic frames (uint8 RGBA) ------------------------------------------

def gradient_frame(h, w, seed=0):
    y = np.linspace(0, 255, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 255, w, dtype=np.float32)[None, :]
    r = np.broadcast_to(x, (h, w))
    g = np.broadcast_to(y, (h, w))
    b = (x + y) * 0.5
    a = np.full((h, w), 255.0, np.float32)
    return np.clip(np.stack([r, g, np.broadcast_to(b, (h, w)), a], -1), 0, 255).astype(np.uint8)


def checkerboard_frame(h, w, cell=4, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    c = (((yy // cell) + (xx // cell)) % 2 * 255).astype(np.uint8)
    rgba = np.stack([c, 255 - c, c, np.full((h, w), 255, np.uint8)], -1)
    return rgba


def zone_plate_frame(h, w, k=0.08, seed=0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2.0, w / 2.0
    r2 = (yy - cy) ** 2 + (xx - cx) ** 2
    v = (127.5 + 127.5 * np.cos(k * r2 * np.pi / max(h, w))).astype(np.uint8)
    return np.stack([v, v, v, np.full((h, w), 255, np.uint8)], -1)


def noise_frame(h, w, seed=0):
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint16).astype(np.uint8)
    rgba[..., 3] = 255
    return rgba
