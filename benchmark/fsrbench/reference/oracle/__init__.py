"""NumPy golden reference (scalar-faithful, vectorized over pixels).

Every function here is a literal float32 port of the reference HLSL/C math
(reference: src/fsr/ffx_fsr1.h, ffx_a.h, src/nis/NIS_Scaler.h).
All elementwise arithmetic is IEEE float32 — identical bit patterns whether
evaluated per-scalar or vectorized — so this module is the judge for the JAX
ops and the Pallas kernels.
"""

from . import intrinsics
from .easu import easu_oracle
from .rcas import rcas_oracle
from .bilinear import bilinear_sample, bilinear_fallback_fsr
from .nis import nvscaler_oracle, nvsharpen_oracle

__all__ = [
    "intrinsics",
    "easu_oracle",
    "rcas_oracle",
    "bilinear_sample",
    "bilinear_fallback_fsr",
    "nvscaler_oracle",
    "nvsharpen_oracle",
]
