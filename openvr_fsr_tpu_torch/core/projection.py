"""Canted-display projection-centre math.

Port of PostProcessor::CalculateProjectionCenter (PostProcessor.cpp:104-121):
given the raw projection extents (l, r, t, b) of each eye and the eye-to-head
transforms' forward vectors, compute where the optical centre lands in
normalized texture coordinates. The foveated radius is centred there.

A copy of projection_center and default_centers from
openvr_fsr_tpu/core/projection.py (the port cannot import that package: its
__init__ imports jax); tests/test_torch_core.py holds the two equal. The
cant angle and the MIP bias come with the slices that use them.
"""

import math

import numpy as np

__all__ = ["projection_center", "default_centers"]


def projection_center(left, right, top, bottom, cant_rad=0.0):
    """Normalized (x, y) optical centre (PostProcessor.cpp:117-119):

      x = 0.5 * (1 + (r + l - 2*tan(cant)) / (l - r))
      y = 0.5 * (1 + (b + t) / (t - b))
    """
    canted = math.tan(cant_rad)
    x = 0.5 * (1.0 + (right + left - 2 * canted) / (left - right))
    y = 0.5 * (1.0 + (bottom + top) / (top - bottom))
    return float(np.float32(x)), float(np.float32(y))


def default_centers():
    """Symmetric projection (l=-1, r=1, t=-1, b=1, no cant) -> centre (0.5, 0.5)
    for both eyes. Used when the caller has no HMD geometry."""
    c = projection_center(-1.0, 1.0, -1.0, 1.0, 0.0)
    return c, c
