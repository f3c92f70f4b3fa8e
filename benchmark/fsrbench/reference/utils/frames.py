"""UNORM quantize and decode, copied from openvr_fsr_tpu_torch/utils/frames.py
(commit 28546975116d8068293ff5b32b22b8593be022b5) without its torch helpers."""

import numpy as np

__all__ = ["quantize_unorm", "decode_unorm"]


def quantize_unorm(x, bits=8):
    """NumPy UNORM quantize-and-decode (round-half-even), for oracle pipelines."""
    scale = np.float32((1 << bits) - 1)
    q = np.rint(np.clip(np.asarray(x, np.float32), 0.0, 1.0) * scale).astype(np.float32)
    return q * np.float32(1.0 / scale)


def decode_unorm(u, bits=8):
    return np.asarray(u, np.float32) * np.float32(1.0 / ((1 << bits) - 1))
