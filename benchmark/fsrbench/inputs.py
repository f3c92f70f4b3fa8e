"""The run's inputs, made from --seed.

A run rotates through a few stereo pairs (traffic `inputs`, three in every
mix so far: 75 MB at 2 x 1683x1869, more than the H100's 50 MB L2, so no
call finds its input in L2). Each eye is 8x8 blocks of random colour, with
seeded noise of +-24 on every texel and a random alpha: hard edges, flat
runs and texture side by side, so both EASU's edge paths and RCAS's limits
are exercised. They are made on the card from a torch.Generator, in a few
large calls, as packed RGBA8: one (2, H, W) int32 plane per pair, the
port's zero-copy serving input. The stream's pairs are copied to host
memory, where its producer pushes them from.
"""

import numpy as np
import torch

__all__ = ["make_pairs", "seed_rng", "BLOCK", "NOISE"]

BLOCK = 8
NOISE = 24


def _torch_seed(seed):
    return int(seed) % (1 << 63)


def seed_rng(seed, stream):
    """A numpy Generator for one use of the seed (`stream` names the use),
    so the draws of different uses are independent."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def make_pairs(seed, n, w, h, device):
    """n packed RGBA8 stereo pairs, each a contiguous (2, h, w) int32
    tensor on `device`, from one torch.Generator on that device."""
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
