"""The texel words of a configuration: its `color_bits` chooses the format.

Every format packs one texel into one 4-byte word, so a stereo pair is one
(2, H, W) int32 plane in either (the port's zero-copy serving input), and
work.py's 4 bytes a texel hold for both:

  color_bits 8: RGBA8 (DXGI_FORMAT_R8G8B8A8_UNORM), R in bits 0-7, G in
    8-15, B in 16-23, A in 24-31: the word's bytes in memory order.
  color_bits 10: R10G10B10A2 (DXGI_FORMAT_R10G10B10A2_UNORM), R in bits
    0-9, G in 10-19, B in 20-29, A in 30-31. The reference mod keeps the
    game's texture format through every stage, R10G10B10A2 passed through
    (fholger/openvr_fsr src/postprocess/PostProcessor.cpp:63-74, 527), so a
    game that submits 10-bit eyes gets 10:10:10:2 in and out.

Channels are (..., 4) arrays of the format's dtype (uint8, uint16): R, G,
B, A, each in [0, its max]. `to_words` and `from_words` take numpy arrays
or torch tensors and return the same kind. Both go through the word's four
little-endian bytes, so no shift leaves int32 and a word is packed alike on
every device; torch is imported only for a tensor, so the reference's
worker loads numpy alone.
"""

from dataclasses import dataclass

import numpy as np

__all__ = ["TexelFormat", "RGBA8", "RGB10A2", "texel_format",
           "BYTES_PER_TEXEL"]

BYTES_PER_TEXEL = 4


class _Numpy:
    int32, uint8 = np.int32, np.uint8

    @staticmethod
    def cast(x, dtype):
        return x.astype(dtype)

    @staticmethod
    def stack(xs):
        return np.stack(xs, axis=-1)

    @staticmethod
    def as_bytes(words):
        w = np.ascontiguousarray(words)
        return w.view(np.uint8).reshape(w.shape + (BYTES_PER_TEXEL,))


class _Torch:
    def __init__(self):
        import torch
        self.int32, self.uint8 = torch.int32, torch.uint8
        self.torch = torch

    @staticmethod
    def cast(x, dtype):
        return x.to(dtype)

    def stack(self, xs):
        return self.torch.stack(xs, dim=-1)

    def as_bytes(self, words):
        w = words.contiguous()
        return w.view(self.torch.uint8).reshape(*w.shape, BYTES_PER_TEXEL)


def _lib(x):
    return _Numpy if isinstance(x, np.ndarray) else _Torch()


@dataclass(frozen=True)
class TexelFormat:
    color_bits: int
    dtype: type            # the numpy dtype of a channel
    channel_max: tuple     # R, G, B, A
    shifts: tuple          # each channel's lowest bit in the word

    @property
    def torch_dtype(self):
        import torch
        return {np.uint8: torch.uint8, np.uint16: torch.uint16}[self.dtype]

    def _spans(self):
        """(channel, byte, shift) for every byte that holds bits of a
        channel: the channel's bits sit in the byte shifted left by
        `shift`, or right where it is negative."""
        for i, (s, m) in enumerate(zip(self.shifts, self.channel_max)):
            for k in range(BYTES_PER_TEXEL):
                if s < 8 * k + 8 and s + m.bit_length() > 8 * k:
                    yield i, k, s - 8 * k

    def to_words(self, channels):
        """(..., 4) channels -> (...) int32 words."""
        lib = _lib(channels)
        c = [lib.cast(channels[..., i], lib.int32) for i in range(4)]
        out = [0] * BYTES_PER_TEXEL
        for i, k, d in self._spans():
            out[k] = out[k] | (c[i] << d if d >= 0 else c[i] >> -d)
        out = lib.cast(lib.stack([b & 0xFF for b in out]), lib.uint8)
        return out.view(lib.int32)[..., 0]

    def from_words(self, words):
        """(...) int32 (or uint32) words -> (..., 4) channels. Where the
        channels are the word's bytes (RGBA8), the bytes' view."""
        lib = _lib(words)
        b = lib.as_bytes(words)
        if self.dtype is np.uint8 and self.shifts == (0, 8, 16, 24):
            return b
        c = [0] * 4
        for i, k, d in self._spans():
            v = lib.cast(b[..., k], lib.int32)
            c[i] = c[i] | (v >> d if d >= 0 else v << -d)
        out = lib.stack([x & m for x, m in zip(c, self.channel_max)])
        return lib.cast(out, self.dtype if lib is _Numpy
                        else self.torch_dtype)


RGBA8 = TexelFormat(8, np.uint8, (255, 255, 255, 255), (0, 8, 16, 24))
RGB10A2 = TexelFormat(10, np.uint16, (1023, 1023, 1023, 3), (0, 10, 20, 30))
_FORMATS = {8: RGBA8, 10: RGB10A2}


def texel_format(color_bits):
    """The format of a configuration's `color_bits` (8 or 10)."""
    try:
        return _FORMATS[int(color_bits)]
    except KeyError:
        raise ValueError(f"color_bits={color_bits!r}: 8 (RGBA8) or 10 "
                         f"(R10G10B10A2)") from None
