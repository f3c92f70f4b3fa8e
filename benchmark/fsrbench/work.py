"""The work one stereo pair needs, from shapes alone, and the least time the
card could take for it.

Outputs inside and outside the foveation circle are counted with the
reference's own test (the frozen core/foveation.py: a tile is inside when
its centre lies within the radius of the eye's projection centre; the
configuration names the tile, FSR 16x16, NVScaler 32x24), per eye with
that eye's centre. Operations are those outputs times the configuration's
frozen `ops_per_output` (the algorithm's f32 ops per output of each
class, from the port's op meter); bytes are
each input word read once and each output word written once (packed RGBA8:
4 bytes a texel). The least time is the larger of operations over the
published FP32 peak and bytes over the published memory bandwidth of one
NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).
"""

from .reference.core import constants as C
from .reference.core import foveation as fov
from .reference.core.projection import projection_center

__all__ = ["PEAK_FP32_FLOPS", "PEAK_HBM_BYTES_S", "eye_centers", "pair_work",
           "least_ms", "inside_masks"]

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12


def eye_centers(config):
    """The normalised projection centre of each eye, from the config's raw
    projection extents (PostProcessor.cpp:117-119, no cant)."""
    raw = config["eye_projection_raw"]
    return tuple(projection_center(*raw[e]) for e in ("left", "right"))


def inside_masks(config):
    """Per eye, the (out_h, out_w) boolean mask of outputs the inside kernel
    computes."""
    ow, oh = config["eye_out_wh"]
    pl, pr = eye_centers(config)
    masks = []
    for eye in (0, 1):
        fc = C.foveation_constants(ow, oh, config["radius"], pl, pr, True, eye)
        masks.append(fov.pixel_mask(ow, oh, tuple(config["foveation_tile_wh"]),
                                    (fc.centre_left, fc.centre_right),
                                    fc.radius_sq))
    return masks


def pair_work(config):
    """Outputs by class, operations and unique bytes of one stereo pair."""
    (iw, ih), (ow, oh) = config["eye_in_wh"], config["eye_out_wh"]
    inside = sum(int(m.sum()) for m in inside_masks(config))
    outside = 2 * ow * oh - inside
    t = config["ops_per_output"]
    per_inside = t["inside"] + t["per_input_inside"] * (iw * ih) / (ow * oh)
    ops = inside * per_inside + outside * t["outside"]
    nbytes = 2 * iw * ih * 4 + 2 * ow * oh * 4
    return {"inside": inside, "outside": outside, "ops": ops,
            "bytes": nbytes}


def least_ms(work):
    """(least ms, 'operations' or 'bytes'): which bound applies."""
    t_ops = work["ops"] / PEAK_FP32_FLOPS * 1e3
    t_bytes = work["bytes"] / PEAK_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
