"""Plain torch ops: the FSR math in eager PyTorch, op for op the NumPy
oracle's f32 order. They run on any device and are the plain versions the
CUDA kernel in ../kernels is held against."""

from . import bilinear, common, easu, rcas

__all__ = ["bilinear", "common", "easu", "rcas"]
