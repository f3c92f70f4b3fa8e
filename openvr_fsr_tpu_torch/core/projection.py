"""Canted-display projection-centre math.

Port of PostProcessor::CalculateProjectionCenter (PostProcessor.cpp:104-121):
given the raw projection extents (l, r, t, b) of each eye and the eye-to-head
transforms' forward vectors, compute where the optical centre lands in
normalized texture coordinates. The foveated radius is centred there.

A copy of openvr_fsr_tpu/core/projection.py (the port cannot import that
package: its __init__ imports jax); tests/test_torch_core.py holds each
function equal to its original.
"""

import math

import numpy as np

__all__ = ["canted_angle", "projection_center", "default_centers",
           "mip_lod_bias"]


def canted_angle(forward_left, forward_right, eye):
    """Half the angle between the two eyes' forward (-z) axes, signed per eye
    (negative for the right eye) — PostProcessor.cpp:111-114."""
    fl = np.asarray(forward_left, np.float64)
    fr = np.asarray(forward_right, np.float64)
    dot = float(np.dot(fl, fr))
    dot = max(-1.0, min(1.0, dot))
    return abs(math.acos(dot) / 2) * (-1.0 if eye == 1 else 1.0)


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


def mip_lod_bias(in_w, out_w):
    """The negative texture-LOD bias the reference injects into the game's
    anisotropic samplers so textures mip-select for the *output* resolution
    (VrHooks.cpp:94-136: MipLODBias += -log2(outW/inW), applied only to
    samplers with bias == 0 and anisotropy > 1). The library has no sampler
    to patch — `applyMIPBias` is the caller's texture-sampling concern; this
    returns the value a renderer should add to its own samplers."""
    return float(np.float32(-math.log2(float(out_w) / float(in_w))))
