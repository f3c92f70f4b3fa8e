"""The run's inputs, made from --seed.

A run rotates through a few stereo pairs (traffic `inputs`, three in every
mix so far: 75 MB at 2 x 1683x1869, more than the H100's 50 MB L2, so no
call finds its input in L2). Each eye is 8x8 blocks of random colour, with
seeded noise of +-24 on every texel and a random alpha: hard edges, flat
runs and texture side by side, so both EASU's edge paths and RCAS's limits
are exercised. They are made on the card from a torch.Generator, in a few
large calls, as packed words of the configuration's texel format
(texels.py): one (2, H, W) int32 plane per pair, the port's zero-copy
serving input. At color_bits 10 the content is the same at the format's
scale: blocks in [0, 1023], noise of +-96 (24 x 1023 / 255, rounded) and an
alpha in [0, 3]. The stream's pairs are copied to host memory, where its
producer pushes them from.
"""

import numpy as np
import torch

from .texels import texel_format

__all__ = ["make_pairs", "seed_rng", "BLOCK", "NOISE"]

BLOCK = 8
NOISE = 24        # at RGBA8's scale


def _torch_seed(seed):
    return int(seed) % (1 << 63)


def seed_rng(seed, stream):
    """A numpy Generator for one use of the seed (`stream` names the use),
    so the draws of different uses are independent."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def make_pairs(seed, n, w, h, device, color_bits=8):
    """n packed stereo pairs of the texel format of `color_bits`, each a
    contiguous (2, h, w) int32 tensor on `device`, from one
    torch.Generator on that device."""
    if color_bits != 8:
        return _make_pairs_words(seed, n, w, h, device,
                                 texel_format(color_bits))
    g = torch.Generator(device=device)
    g.manual_seed(_torch_seed(seed))
    hb, wb = -(-h // BLOCK), -(-w // BLOCK)
    blocks = torch.randint(0, 256, (n, 2, hb, wb, 3), generator=g,
                           device=device, dtype=torch.uint8)
    base = blocks.repeat_interleave(BLOCK, dim=2).repeat_interleave(
        BLOCK, dim=3)[:, :, :h, :w].to(torch.int16)
    noise = torch.randint(-NOISE, NOISE + 1, (n, 2, h, w, 3), generator=g,
                          device=device, dtype=torch.int16)
    rgba = torch.empty((n, 2, h, w, 4), dtype=torch.uint8, device=device)
    rgba[..., :3] = (base + noise).clamp_(0, 255).to(torch.uint8)
    rgba[..., 3] = torch.randint(0, 256, (n, 2, h, w), generator=g,
                                 device=device, dtype=torch.uint8)
    packed = rgba.view(torch.int32)[..., 0]
    return [packed[i].contiguous() for i in range(n)]


def _make_pairs_words(seed, n, w, h, device, fmt):
    """make_pairs' content at the scale of `fmt`, packed by `fmt`."""
    top, amax = fmt.channel_max[0], fmt.channel_max[3]
    noise_max = round(NOISE * top / 255)      # 96 at 10 bits
    g = torch.Generator(device=device)
    g.manual_seed(_torch_seed(seed))
    hb, wb = -(-h // BLOCK), -(-w // BLOCK)
    blocks = torch.randint(0, top + 1, (n, 2, hb, wb, 3), generator=g,
                           device=device, dtype=torch.int16)
    base = blocks.repeat_interleave(BLOCK, dim=2).repeat_interleave(
        BLOCK, dim=3)[:, :, :h, :w]
    noise = torch.randint(-noise_max, noise_max + 1, (n, 2, h, w, 3),
                          generator=g, device=device, dtype=torch.int16)
    rgba = torch.empty((n, 2, h, w, 4), dtype=torch.int16, device=device)
    rgba[..., :3] = (base + noise).clamp_(0, top)
    rgba[..., 3] = torch.randint(0, amax + 1, (n, 2, h, w), generator=g,
                                 device=device, dtype=torch.int16)
    packed = fmt.to_words(rgba)
    return [packed[i].contiguous() for i in range(n)]
