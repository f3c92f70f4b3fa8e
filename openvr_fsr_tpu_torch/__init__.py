"""openvr_fsr_tpu_torch — the PyTorch + CUDA port of openvr_fsr_tpu.

Runs every stage plan of the JAX package on stereo RGBA8 frames with
foveated-radius blending: FSR1 (EASU upscale + UNORM8 intermediate + RCAS
sharpen, or RCAS alone at renderScale 1), NVIDIA Image Scaling (NVScaler /
NVSharpen) and FFX CAS (sharpen-and-upscale or sharpen-only), each on an
NVIDIA Hopper GPU through a hand-written CUDA kernel, and on the CPU through
the same computation in plain torch. The JAX package openvr_fsr_tpu is the
reference it is held against; this package imports torch and numpy, never
jax.

Layers (bottom up), mirroring openvr_fsr_tpu:
  core/     — config & constant derivation (numpy copies of the JAX package's)
  ops/      — plain torch ops, f32 op for op the NumPy oracle
  csrc/     — the CUDA C++ kernel sources (built with nvcc at first use)
  kernels/  — build, launch wrappers and plain versions of the kernels
  models/   — upscaler model families (FSR, NIS, CAS)
  api/      — `upscale()` + stateful `Pipeline`
  utils/    — frames, timing, tracing (spans and counters), logging
"""

from .version import __version__
from .core.config import Config, load_config
from .api.pipeline import Pipeline, upscale
from .models import get_model, FsrModel, NisModel, CasModel

__all__ = ["__version__", "Config", "load_config", "Pipeline", "upscale",
           "get_model", "FsrModel", "NisModel", "CasModel"]
