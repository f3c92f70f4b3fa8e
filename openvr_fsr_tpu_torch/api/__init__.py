from .pipeline import Pipeline, upscale

__all__ = ["Pipeline", "upscale"]
