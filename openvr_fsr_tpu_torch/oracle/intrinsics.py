"""Bit-exact NumPy ports of the ffx_a.h portability intrinsics.

These approximation functions are *part of the algorithm's numerics* — EASU
and RCAS outputs depend on their exact bit patterns, so they are ported at
the uint32-bitcast level (reference: src/fsr/ffx_a.h:141, 1842-1845).

All inputs/outputs are np.float32 (scalars or arrays). Helpers enforce f32 so
accidental float64 promotion cannot silently change results.
"""

import numpy as np

F32 = np.float32
U32 = np.uint32


def f32(x):
    """Cast to float32 (array-safe)."""
    return np.asarray(x, dtype=np.float32) if np.ndim(x) else np.float32(x)


def u32_from_f32(a):
    """AU1_AF1 — bitcast float32 -> uint32 (ffx_a.h:141)."""
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def f32_from_u32(u):
    """AF1_AU1 — bitcast uint32 -> float32 (ffx_a.h:608/1079)."""
    return np.asarray(u, dtype=np.uint32).view(np.float32)


def rcp(a):
    """ARcpF1 — reciprocal. GPU HLSL maps this to the `rcp` instruction; the
    CPU build and this oracle use exact IEEE division (ffx_a.h:326, 1196)."""
    return np.divide(F32(1.0), np.asarray(a, np.float32), dtype=np.float32)


def rsq(a):
    """ARsqF1 — 1/sqrt (ffx_a.h:362, 1201)."""
    a = np.asarray(a, np.float32)
    return np.divide(F32(1.0), np.sqrt(a, dtype=np.float32), dtype=np.float32)


def sat(a):
    """ASatF1 — clamp to [0,1] (ffx_a.h:365, 1206)."""
    a = np.asarray(a, np.float32)
    return np.minimum(F32(1.0), np.maximum(F32(0.0), a))


def clamp(x, lo, hi):
    """AClampF1 (ffx_a.h CPU section)."""
    x = np.asarray(x, np.float32)
    return np.maximum(F32(lo), np.minimum(x, F32(hi)))


def exp2f(a):
    """AExp2F1 (ffx_a.h:283)."""
    return np.exp2(np.asarray(a, np.float32), dtype=np.float32)


def min3(x, y, z):
    """AMin3F1/AMin3F3 (ffx_a.h:703/705)."""
    return np.minimum(x, np.minimum(y, z))


def max3(x, y, z):
    """AMax3F1/AMax3F3 (ffx_a.h:675/677)."""
    return np.maximum(x, np.maximum(y, z))


def lerp(a, b, c):
    """ALerpF1 / HLSL lerp: b*c + (-a*c + a)  (ffx_a.h CPU section).

    Note the exact op order: one mul, one negated-mul-add, one add — matches
    `lerp(a,b,c) = a + c*(b-a)` only approximately in f32, so keep this form.
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    c = np.asarray(c, np.float32)
    return (b * c + (-(a * c) + a)).astype(np.float32, copy=False)


# --- Magic-constant approximations (ffx_a.h:1842-1845, A_GPU section) -------

def aprx_lo_sqrt(a):
    """APrxLoSqrtF1: bitcast((bits(a)>>1) + 0x1fbc4639)."""
    u = u32_from_f32(a)
    return f32_from_u32((u >> U32(1)) + U32(0x1FBC4639))


def aprx_lo_rcp(a):
    """APrxLoRcpF1: bitcast(0x7ef07ebb - bits(a))."""
    u = u32_from_f32(a)
    return f32_from_u32(U32(0x7EF07EBB) - u)


def aprx_med_rcp(a):
    """APrxMedRcpF1: one Newton step on the low approximation.

    b = bitcast(0x7ef19fff - bits(a)); return b*(-b*a + 2.0)
    """
    a = np.asarray(a, np.float32)
    b = f32_from_u32(U32(0x7EF19FFF) - u32_from_f32(a))
    return (b * (-(b * a) + F32(2.0))).astype(np.float32, copy=False)


def aprx_lo_rsq(a):
    """APrxLoRsqF1: bitcast(0x5f347d74 - (bits(a)>>1)) — fast inverse sqrt."""
    u = u32_from_f32(a)
    return f32_from_u32(U32(0x5F347D74) - (u >> U32(1)))


# --- HLSL comparison semantics ----------------------------------------------
# D3D min(x,y) = x < y ? x : y ; max(x,y) = x > y ? x : y.
# With NaN in x the comparison is false and y is returned; np.minimum/np.maximum
# instead propagate NaN. RCAS relies on this (flat-region division by zero
# produces NaN limiters that the min/max chain must swallow, ffx_fsr1.h:750-759).

def hlsl_min(x, y):
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    return np.where(x < y, x, y)


def hlsl_max(x, y):
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    return np.where(x > y, x, y)


def hlsl_lerp(a, b, s):
    """HLSL lerp intrinsic: a + s*(b-a), evaluated in f32 (used by NIS)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    s = np.asarray(s, np.float32)
    return (a + s * (b - a)).astype(np.float32, copy=False)
