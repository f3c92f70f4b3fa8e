"""Shared torch building blocks: the ffx_a.h approximation intrinsics
(bit-exact through int32 views, reference src/fsr/ffx_a.h:1842-1845), HLSL
min/max semantics and UNORM quantization.

Eager PyTorch runs one op per kernel, so no multiply is ever fused with an
add: every f32 op rounds once, in the order written, as in the NumPy oracle.
f32 division on the CPU and on CUDA is correctly rounded, so the JAX
package's `rcp_ieee` correction (written for the TPU's division) has no
counterpart here.

The half-precision cores (precision="half", the JAX package's dt=bfloat16)
keep their working values as bf16 tensors: a torch op on two bf16 tensors
is the f32 op rounded once to bf16 (round to nearest even), which is what
the JAX package computes op by op. Torch promotes mixed operands like JAX
does for two arrays, but a Python float or a 0-d tensor never lifts a bf16
tensor to f32, while the JAX package's np.float32 literals do: the cores
name each such step with an explicit `.float()`. Their literals are dt
values (`lit`), as the JAX package's dt(...) are.
"""

import numpy as np
import torch

F32 = np.float32

__all__ = [
    "F32",
    "aprx_lo_rcp",
    "aprx_med_rcp",
    "aprx_lo_rsq",
    "aprx_lo_sqrt",
    "rcp",
    "sat",
    "hlsl_min",
    "hlsl_max",
    "min3",
    "max3",
    "hlsl_lerp",
    "unorm_quantize",
    "strip_rows",
    "HALF",
    "lit",
    "via_f32",
]

HALF = torch.bfloat16     # the working type of precision="half"


def lit(v, dt=torch.float32):
    """The literal v as a Python float in the core's working type dt: its
    f32 value, rounded to bf16 for dt=bf16 (the JAX package's dt(v))."""
    return torch.tensor(float(v), dtype=torch.float32).to(dt).item()


def via_f32(fn, dt=torch.float32):
    """fn evaluated on the f32 value of its operand, the result rounded to
    dt: how the half cores run the ffx_a.h bit approximations and rcp (the
    JAX package's `_via_f32`). For dt=f32 it is fn itself."""
    if dt == torch.float32:
        return fn
    return lambda a: fn(a.float()).to(dt)


def _bits(a):
    """The f32 bit pattern as an int32 view (torch has few uint32 ops;
    int32 add/sub wrap exactly like uint32)."""
    return a.contiguous().view(torch.int32)


def _f32(bits):
    return bits.view(torch.float32)


def aprx_lo_rcp(a):
    """APrxLoRcpF1: bitcast(0x7ef07ebb - bits(a))."""
    return _f32(0x7EF07EBB - _bits(a))


def aprx_med_rcp(a):
    """APrxMedRcpF1: b = bitcast(0x7ef19fff - bits(a)); b*(-b*a + 2)."""
    b = _f32(0x7EF19FFF - _bits(a))
    return b * (-(b * a) + 2.0)


def aprx_lo_rsq(a):
    """APrxLoRsqF1: bitcast(0x5f347d74 - (bits(a)>>1)). The shift is
    logical: the int32 arithmetic shift is masked back to 31 bits."""
    return _f32(0x5F347D74 - ((_bits(a) >> 1) & 0x7FFFFFFF))


def aprx_lo_sqrt(a):
    """APrxLoSqrtF1: bitcast((bits(a)>>1) + 0x1fbc4639) (ffx_a.h:1455). The
    shift is logical, as in aprx_lo_rsq."""
    return _f32(((_bits(a) >> 1) & 0x7FFFFFFF) + 0x1FBC4639)


def rcp(a):
    """ARcpF1 — exact IEEE f32 reciprocal (see oracle.intrinsics.rcp)."""
    return torch.reciprocal(a)


def sat(a):
    """ASatF1; NaN propagates (torch.minimum/maximum, like jnp)."""
    return torch.clamp(a, 0.0, 1.0)


def hlsl_min(x, y):
    """D3D min: x < y ? x : y (NaN in x selects y). On bf16 operands the
    compare is exact, as the JAX half cores' f32 compares (ops/rcas.py
    _hmin, _hmax)."""
    return torch.where(x < y, x, y)


def hlsl_max(x, y):
    """D3D max: x > y ? x : y (NaN in x selects y)."""
    return torch.where(x > y, x, y)


def min3(x, y, z):
    return torch.minimum(x, torch.minimum(y, z))


def max3(x, y, z):
    return torch.maximum(x, torch.maximum(y, z))


def hlsl_lerp(a, b, s):
    """HLSL lerp intrinsic in its exact form a + s*(b-a) (two roundings;
    torch.lerp is another formula and is not used)."""
    return a + s * (b - a)


def unorm_quantize(x, bits=8):
    """The D3D11 float->UNORM store (clamp to [0,1], scale, round half to
    even) and the multiply-by-reciprocal decode back to float
    (PostProcessor.cpp:527, 63-74)."""
    scale = F32((1 << bits) - 1)
    return torch.round(sat(x) * float(scale)) * float(F32(1.0) / scale)


def strip_rows(rows, h, row_base=0, in_h=None):
    """Global input rows (an int64 tensor), clamped into an image of in_h
    rows (default h), as strip indices: rebased by row_base, the image's
    first row in a strip of h rows, and clamped into the strip. A row-band
    build's outputs read only rows its strip holds (kernels/_maps.py::
    band_strip); the second clamp serves the positions a plain version
    computes and the band discards. For the whole image it does nothing."""
    in_h = h if in_h is None else int(in_h)
    return (rows.clamp(0, in_h - 1) - row_base).clamp(0, h - 1)
