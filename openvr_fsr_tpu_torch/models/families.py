"""Model-family wrappers over the pipeline and kernels (the JAX package's
models/families.py, with its defaults).

Each family is a thin, stateful facade with the family's own knobs; the
work (build cache, kernel selection, foveation, formats) stays in
api.Pipeline, CAS included (`Config.use_cas`). A family runs on the card
unless it is given device="cpu" (Pipeline's `device`).
"""

from ..api.pipeline import Pipeline
from ..core.config import Config
from ..parallel.sharding import ShardedPipeline

__all__ = ["FsrModel", "NisModel", "CasModel", "get_model", "MODELS"]


class _PipelineModel:
    _use_nis = False
    _use_cas = False

    def __init__(self, render_scale=0.77, sharpness=0.9, radius=0.5,
                 debug=False, eye_centers=None, color_bits=None,
                 backend="auto", **pipeline_kw):
        cfg = Config(enabled=True, use_nis=self._use_nis,
                     use_cas=self._use_cas,
                     render_scale=float(render_scale),
                     sharpness=float(sharpness), radius=float(radius),
                     debug_mode=bool(debug))
        self.pipeline = Pipeline(cfg, eye_centers=eye_centers,
                                 color_bits=color_bits, backend=backend,
                                 **pipeline_kw)

    @property
    def config(self):
        return self.pipeline.config

    def __call__(self, frames, eyes=None):
        return self.pipeline.process(frames, eyes=eyes)

    def sharded(self, mesh=None):
        """The family's pipeline split over a batch mesh (a list of torch
        devices; default every CUDA device): parallel.ShardedPipeline."""
        return ShardedPipeline(self.pipeline, mesh)


class FsrModel(_PipelineModel):
    """AMD FidelityFX Super Resolution 1: EASU upscale + RCAS sharpen
    (renderScale != 1), RCAS only at renderScale == 1."""


class NisModel(_PipelineModel):
    """NVIDIA Image Scaling: NVScaler upscale (renderScale != 1) or
    NVSharpen (renderScale == 1)."""

    _use_nis = True


class CasModel(_PipelineModel):
    """AMD FidelityFX CAS: one CasFilter pass — contrast-adaptive sharpen
    at renderScale == 1 (noScaling, ffx_cas.h:430-552, with the
    maxColorDelta clamp), sharpen-and-upscale otherwise (:552-892,
    <= 4x area)."""

    _use_cas = True

    def __init__(self, render_scale=1.0, sharpness=0.8, radius=2.0,
                 max_color_delta=1.0, **kw):
        super().__init__(render_scale=render_scale, sharpness=sharpness,
                         radius=radius,
                         cas_max_color_delta=max_color_delta, **kw)


MODELS = {"fsr": FsrModel, "nis": NisModel, "cas": CasModel}


def get_model(name, **kw):
    """Resolve a model family by name ('fsr', 'nis', 'cas')."""
    return MODELS[name.lower()](**kw)
