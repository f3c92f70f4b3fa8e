"""Minimal float32 helpers shared by core/ (constants) and oracle/ without
package-level import cycles. A copy of openvr_fsr_tpu/f32util.py."""

import numpy as np

F32 = np.float32


def f32(x):
    return np.asarray(x, dtype=np.float32) if np.ndim(x) else np.float32(x)


def rcp(a):
    """Exact IEEE f32 reciprocal (ARcpF1, ffx_a.h:326)."""
    return np.divide(F32(1.0), np.asarray(a, np.float32), dtype=np.float32)


def exp2f(a):
    return np.exp2(np.asarray(a, np.float32), dtype=np.float32)


def u32_from_f32(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)
