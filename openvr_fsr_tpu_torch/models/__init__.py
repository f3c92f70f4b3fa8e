"""Upscaler model families — one class per algorithm family, over the
port's Pipeline and kernels (the JAX package's models/):

  FsrModel — AMD FidelityFX Super Resolution 1 (EASU + RCAS), the default
  NisModel — NVIDIA Image Scaling (NVScaler / NVSharpen)
  CasModel — FFX Contrast-Adaptive Sharpening (sharpen-only or
             sharpen-and-upscale, ffx_cas.h)

`get_model(name)` resolves by the names users know from the cfg/README.
"""

from .families import FsrModel, NisModel, CasModel, get_model, MODELS

__all__ = ["FsrModel", "NisModel", "CasModel", "get_model", "MODELS"]
