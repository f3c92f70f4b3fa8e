"""Hand-written CUDA kernels for Hopper (csrc/), their ctypes build and
launch wrappers, and the plain torch version of each. Nothing here builds
or loads a kernel when imported: the first launch on a CUDA tensor does."""

from .fsr import build_fsr_fused, fsr_fused_reference  # noqa: F401
