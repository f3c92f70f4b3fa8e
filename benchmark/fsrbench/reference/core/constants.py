"""CPU-side constant derivation, float32-faithful.

A copy of the FSR, foveation and NIS parts of
openvr_fsr_tpu/core/constants.py (the port cannot import that package: its
__init__ imports jax). tests/test_torch_core.py holds every table here
equal to the original.

Ports (with exact f32 op ordering):
  - FsrEasuCon            (reference src/fsr/ffx_fsr1.h:156-202)
  - FsrRcasCon            (reference src/fsr/ffx_fsr1.h:662-672)
  - the foveation centre/radius constant packing
                          (reference src/postprocess/PostProcessor.cpp:293-310,
                           416-430)
  - NVScalerUpdateConfig / NVSharpenUpdateConfig
                          (reference src/nis/NIS_Config.h:144-255)

Constants are returned as float32 numpy arrays (the bitcast-to-uint32 storage
of the reference cbuffers is an ABI detail; the *values* are what the kernels
consume).
"""

from dataclasses import dataclass

import numpy as np

from ..f32util import F32, f32, rcp, exp2f

__all__ = [
    "fsr_easu_con",
    "fsr_rcas_con",
    "FoveationConstants",
    "foveation_constants",
    "centres_payload",
    "RCAS_LIMIT",
    "NIS_PHASE_COUNT",
    "NIS_FILTER_SIZE",
    "NisConfig",
    "nvscaler_update_config",
    "nvsharpen_update_config",
]

# FSR_RCAS_LIMIT (ffx_fsr1.h:654): set at the limit of unnatural sharpening.
RCAS_LIMIT = np.float32(0.25 - 1.0 / 16.0)


def fsr_easu_con(in_view_w, in_view_h, in_size_w, in_size_h, out_w, out_h):
    """FsrEasuCon (ffx_fsr1.h:156-202).

    Returns (con0, con1, con2, con3) as float32 arrays of shape (4,).
    con3[2:] are zeros (stored as 0 bits — 0.0f).
    """
    ivw, ivh = f32(in_view_w), f32(in_view_h)
    isw, ish = f32(in_size_w), f32(in_size_h)
    ow, oh = f32(out_w), f32(out_h)
    con0 = np.array(
        [
            ivw * rcp(ow),
            ivh * rcp(oh),
            F32(0.5) * ivw * rcp(ow) - F32(0.5),
            F32(0.5) * ivh * rcp(oh) - F32(0.5),
        ],
        dtype=np.float32,
    )
    con1 = np.array(
        [rcp(isw), rcp(ish), F32(1.0) * rcp(isw), F32(-1.0) * rcp(ish)],
        dtype=np.float32,
    )
    con2 = np.array(
        [F32(-1.0) * rcp(isw), F32(2.0) * rcp(ish), F32(1.0) * rcp(isw), F32(2.0) * rcp(ish)],
        dtype=np.float32,
    )
    con3 = np.array([F32(0.0) * rcp(isw), F32(4.0) * rcp(ish), 0.0, 0.0], dtype=np.float32)
    return con0, con1, con2, con3


def fsr_rcas_con(sharpness_stops):
    """FsrRcasCon (ffx_fsr1.h:662-672).

    `sharpness_stops`: 0.0 = maximum sharpness; N>0 halves sharpness N times.
    Returns the linear sharpness value exp2(-stops) as float32.

    The caller derives stops from the user-facing [0,1] slider as
    `2 - 2*sharpness` (PostProcessor.cpp:420-421).
    """
    return exp2f(-f32(sharpness_stops))


def rcas_stops_from_slider(sharpness):
    """PostProcessor.cpp:420-421: slider in [0,1] -> stops, slider clamped."""
    s = min(max(float(sharpness), 0.0), 1.0)
    return F32(2.0) - F32(2.0) * F32(s)


@dataclass(frozen=True)
class FoveationConstants:
    """The `imageCentre` / `radius` uint4 pair of the reference cbuffers.

    centre_left:  (cx, cy) for eye-0 test (uint, truncated from float)
    centre_right: (cx, cy) for eye-1 test
    radius_sq:    floor(r_px^2) where r_px = 0.5*radius*outH (uint semantics)
    out_w, out_h: output size (Radius.zw — the bilinear fallback divisor)
    """

    centre_left: tuple
    centre_right: tuple
    radius_sq: int
    out_w: int
    out_h: int


def foveation_constants(out_w, out_h, radius, proj_left, proj_right,
                        single_eye_per_frame=True, eye=0):
    """Packs the per-eye centre constants (PostProcessor.cpp:298-305, 331-337).

    proj_left/proj_right: normalized projection centres (x, y) per eye.
    single_eye_per_frame: True = one eye per texture ("textureContainsOnlyOneEye");
      False = double-wide shared texture, both centres packed in one cbuffer.
    eye: which eye's constants (only relevant when single_eye_per_frame).

    Reference packing (all float->uint32 assignments truncate toward zero):
      single-eye buffer0 (left):  c[0]=outW*projL.x  c[1]=outH*projL.y
                                  c[2]=outW*projL.x  c[3]=outH*projL.y
      single-eye buffer1 (right): all four from projR
      double-wide:                c[0]=outW/2*projL.x          c[1]=outH*projL.y
                                  c[2]=outW/2*(1+projR.x)      c[3]=outH*projR.y
      (integer division outW/2 happens in uint before the float multiply)
    """
    plx, ply = F32(proj_left[0]), F32(proj_left[1])
    prx, pry = F32(proj_right[0]), F32(proj_right[1])
    ow, oh = int(out_w), int(out_h)
    if single_eye_per_frame:
        if eye == 0:
            cl = (int(F32(ow) * plx), int(F32(oh) * ply))
            cr = cl
        else:
            cl = (int(F32(ow) * prx), int(F32(oh) * pry))
            cr = cl
    else:
        half = ow // 2
        cl = (int(F32(half) * plx), int(F32(oh) * ply))
        cr = (int(F32(half) * (F32(1.0) + prx)), int(F32(oh) * pry))
    r0 = F32(0.5) * F32(radius) * F32(oh)
    radius_sq = int(r0 * r0)  # float->uint truncation (PostProcessor.cpp:303)
    return FoveationConstants(cl, cr, radius_sq, ow, oh)


def centres_payload(out_w, out_h, radius, eye_centers, eyes,
                    single_eye_per_frame=True):
    """Per-batch-entry (cx1, cy1, cx2, cy2, radius_sq) int64 rows — the
    imageCentre/radius cbuffer payload the kernel builders take
    (PostProcessor.cpp:298-305). eye_centers: ((lx,ly),(rx,ry)); eyes: one
    eye id per batch entry (ignored beyond len() when double-wide)."""
    pl_, pr_ = eye_centers
    if single_eye_per_frame:
        per_eye = {}
        for e in set(eyes):
            fc = foveation_constants(out_w, out_h, radius, pl_, pr_, True, e)
            per_eye[e] = [*fc.centre_left, *fc.centre_right, fc.radius_sq]
        rows = [per_eye[e] for e in eyes]
    else:
        fc = foveation_constants(out_w, out_h, radius, pl_, pr_, False)
        rows = [[*fc.centre_left, *fc.centre_right,
                 fc.radius_sq]] * len(eyes)
    return np.asarray(rows, np.int64)


# ----------------------------------------------------------------------------
# NVIDIA Image Scaling config (NIS_Config.h:144-255)
# ----------------------------------------------------------------------------

NIS_PHASE_COUNT = 64
NIS_FILTER_SIZE = 8


@dataclass
class NisConfig:
    """Mirror of struct NISConfig (NIS_Config.h:37-77), float32 values."""

    kDetectRatio: np.float32 = F32(0.0)
    kDetectThres: np.float32 = F32(0.0)
    kMinContrastRatio: np.float32 = F32(0.0)
    kRatioNorm: np.float32 = F32(0.0)
    kContrastBoost: np.float32 = F32(0.0)
    kEps: np.float32 = F32(0.0)
    kSharpStartY: np.float32 = F32(0.0)
    kSharpScaleY: np.float32 = F32(0.0)
    kSharpStrengthMin: np.float32 = F32(0.0)
    kSharpStrengthScale: np.float32 = F32(0.0)
    kSharpLimitMin: np.float32 = F32(0.0)
    kSharpLimitScale: np.float32 = F32(0.0)
    kScaleX: np.float32 = F32(0.0)
    kScaleY: np.float32 = F32(0.0)
    kDstNormX: np.float32 = F32(0.0)
    kDstNormY: np.float32 = F32(0.0)
    kSrcNormX: np.float32 = F32(0.0)
    kSrcNormY: np.float32 = F32(0.0)
    kInputViewportOriginX: int = 0
    kInputViewportOriginY: int = 0
    kInputViewportWidth: int = 0
    kInputViewportHeight: int = 0
    kOutputViewportOriginX: int = 0
    kOutputViewportOriginY: int = 0
    kOutputViewportWidth: int = 0
    kOutputViewportHeight: int = 0
    reserved0: np.float32 = F32(0.0)
    reserved1: np.float32 = F32(0.0)  # debug-tint flag in the fork
    valid: bool = True  # return value of NVScalerUpdateConfig
    hdr_mode: int = 0   # NIS_HDR_MODE: 0 none, 1 linear, 2 PQ (NIS_Scaler.h:112-116)


def nvscaler_update_config(sharpness,
                           input_viewport_w, input_viewport_h,
                           input_texture_w, input_texture_h,
                           output_viewport_w, output_viewport_h,
                           output_texture_w, output_texture_h,
                           hdr_mode=0):
    """NVScalerUpdateConfig (NIS_Config.h:144-241), origins fixed at 0.

    The scale-validity window (0.5 <= scale <= 1.0 per dim) sets .valid=False
    instead of raising — the reference caller ignores the return value
    (PostProcessor.cpp:308).
    """
    c = NisConfig()
    c.hdr_mode = int(hdr_mode)
    sharpness = max(min(1.0, float(sharpness)), 0.0)
    slider = F32(sharpness) - F32(0.5)  # map 0..1 -> -0.5..+0.5

    max_scale = F32(1.25) if slider >= 0.0 else F32(1.75)
    min_scale = F32(1.25) if slider >= 0.0 else F32(1.0)
    limit_scale = F32(1.25) if slider >= 0.0 else F32(1.0)

    k_detect_ratio = F32(1127.0 / 1024.0)
    k_detect_thres = F32(64.0 / 1024.0)
    k_min_contrast_ratio = F32(2.0)
    k_max_contrast_ratio = F32(10.0)
    k_sharp_start_y = F32(0.45)
    k_sharp_end_y = F32(0.9)
    k_sharp_strength_min = max(F32(0.0), F32(0.4) + slider * min_scale * F32(1.2))
    k_sharp_strength_max = F32(1.6) + slider * F32(1.8)
    k_sharp_limit_min = max(F32(0.1), F32(0.14) + slider * limit_scale * F32(0.32))
    k_sharp_limit_max = F32(0.5) + slider * limit_scale * F32(0.6)

    if hdr_mode in (1, 2):  # Linear / PQ
        k_detect_thres = F32(32.0 / 1024.0)
        k_min_contrast_ratio = F32(1.5)
        k_max_contrast_ratio = F32(5.0)
        k_sharp_strength_min = max(F32(0.0), F32(0.4) + slider * min_scale * F32(1.1))
        k_sharp_strength_max = F32(2.2) + slider * max_scale * F32(1.8)
        k_sharp_limit_min = max(F32(0.06), F32(0.10) + slider * limit_scale * F32(0.28))
        k_sharp_limit_max = F32(0.6) + slider * limit_scale * F32(0.6)
        if hdr_mode == 2:
            k_sharp_start_y, k_sharp_end_y = F32(0.35), F32(0.55)
        else:
            k_sharp_start_y, k_sharp_end_y = F32(0.3), F32(0.5)

    c.kInputViewportWidth = int(input_viewport_w) or int(input_texture_w)
    c.kInputViewportHeight = int(input_viewport_h) or int(input_texture_h)
    c.kOutputViewportWidth = int(output_viewport_w) or int(output_texture_w)
    c.kOutputViewportHeight = int(output_viewport_h) or int(output_texture_h)
    if not all((c.kInputViewportWidth, c.kInputViewportHeight,
                c.kOutputViewportWidth, c.kOutputViewportHeight)):
        c.valid = False
        return c

    c.kSrcNormX = rcp(F32(input_texture_w))
    c.kSrcNormY = rcp(F32(input_texture_h))
    c.kDstNormX = rcp(F32(output_texture_w))
    c.kDstNormY = rcp(F32(output_texture_h))
    c.kScaleX = np.divide(F32(c.kInputViewportWidth), F32(c.kOutputViewportWidth),
                          dtype=np.float32)
    c.kScaleY = np.divide(F32(c.kInputViewportHeight), F32(c.kOutputViewportHeight),
                          dtype=np.float32)
    if not (0.5 <= c.kScaleX <= 1.0 and 0.5 <= c.kScaleY <= 1.0):
        c.valid = False  # NIS_Config.h:226 — caller ignores this
    c.kDetectRatio = k_detect_ratio
    c.kDetectThres = k_detect_thres
    c.kMinContrastRatio = k_min_contrast_ratio
    c.kRatioNorm = rcp(k_max_contrast_ratio - k_min_contrast_ratio)
    c.kContrastBoost = F32(1.0)
    c.kEps = F32(1.0)
    c.kSharpStartY = k_sharp_start_y
    c.kSharpScaleY = rcp(k_sharp_end_y - k_sharp_start_y)
    c.kSharpStrengthMin = F32(k_sharp_strength_min)
    c.kSharpStrengthScale = k_sharp_strength_max - k_sharp_strength_min
    c.kSharpLimitMin = F32(k_sharp_limit_min)
    c.kSharpLimitScale = k_sharp_limit_max - k_sharp_limit_min
    return c


def nvsharpen_update_config(sharpness, input_viewport_w, input_viewport_h,
                            input_texture_w, input_texture_h, hdr_mode=0):
    """NVSharpenUpdateConfig (NIS_Config.h:244-255) — scaler config with
    output == input."""
    return nvscaler_update_config(
        sharpness,
        input_viewport_w, input_viewport_h, input_texture_w, input_texture_h,
        input_viewport_w, input_viewport_h, input_texture_w, input_texture_h,
        hdr_mode=hdr_mode,
    )
