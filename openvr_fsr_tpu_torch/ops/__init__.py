"""Plain torch ops: the FSR, NIS and CAS math in eager PyTorch, op for op the
NumPy oracle's f32 order. They run on any device and are the plain versions
the CUDA kernels in ../kernels are held against."""

from . import bilinear, cas, common, easu, nis, rcas

__all__ = ["bilinear", "cas", "common", "easu", "nis", "rcas"]
