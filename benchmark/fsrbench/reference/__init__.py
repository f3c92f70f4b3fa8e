"""The benchmark's plain reference: a frozen copy of the port's NumPy oracle.

`oracle/` is openvr_fsr_tpu_torch/oracle/ and `core/` the modules it needs
(constants, nis_tables, foveation, projection), with `f32util.py`, copied
unchanged from commit 28546975116d8068293ff5b32b22b8593be022b5; `utils/frames.py`
holds that commit's `quantize_unorm` and `decode_unorm` alone (the port's
module also imports torch). The copy imports numpy only: neither jax, the
JAX package nor the port. A later change to the program does not reach it,
so it stays the yardstick `correct` is judged by.
"""

from .oracle.pipeline import pipeline_oracle

__all__ = ["pipeline_oracle"]
