"""Hand-written CUDA kernels for Hopper (csrc/), their ctypes build and
launch wrappers, and the plain torch version of each:

  fsr.py   build_fsr_fused     FSR upscale: EASU + UNORM8 + RCAS (fsr_fused.cu)
  rcas.py  build_rcas_sharpen  FSR at renderScale 1: RCAS (rcas_sharpen.cu)
  nis.py   build_nvscaler      NIS upscale: NVScaler (nis_scaler.cu)
           build_nvsharpen     NIS at renderScale 1: NVSharpen (nis_sharpen.cu)
  cas.py   build_cas_upscale   CAS upscale: CasFilter scaling (cas_upscale.cu)
           build_cas_sharpen   CAS at renderScale 1: noScaling (cas_sharpen.cu)
  sol.py   build_dma_floor     the DMA floor of any of them: its loads and
                               stores, no compute (dma_floor.cu)

Nothing here builds or loads a kernel when imported: the first launch on a
CUDA tensor does (or kernels._build.build(), which builds them all at
once)."""

from .cas import (build_cas_sharpen, build_cas_upscale,  # noqa: F401
                  cas_sharpen_reference, cas_upscale_reference)
from .fsr import build_fsr_fused, fsr_fused_reference  # noqa: F401
from .nis import (build_nvscaler, build_nvsharpen,  # noqa: F401
                  nvscaler_reference, nvsharpen_reference)
from .rcas import build_rcas_sharpen, rcas_sharpen_reference  # noqa: F401
from .sol import build_dma_floor, dma_floor_reference  # noqa: F401
