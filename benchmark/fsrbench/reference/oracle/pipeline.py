"""NumPy full-pipeline oracle — the canonical parity judge.

Composes the scalar-faithful kernel oracles (easu/rcas/nis/cas) with the
orchestration semantics of the reference PostProcessor
(src/postprocess/PostProcessor.cpp:530-535, 586-638): per-stage foveation
masks at workgroup granularity, bilinear/DirectCopy fallbacks with the
debug tint, the intermediate UNORM texture round-trip between the upscale
and sharpen dispatches (:527), and the final UNORM store. Pure NumPy, no
JAX — every f32 op is IEEE round-to-nearest (numpy scalar semantics), so
this is the "CPU scalar reference" named by BASELINE target row 1.

Note the XLA pipeline on x86 is NOT a substitute judge at full resolution:
XLA:CPU fuses a*b+c into FMAs inside the bilinear/lerp chains, which
diverges from the two-rounding reference semantics by 1 ulp on ~25% of
lerps (measured by /tmp-probes for VERDICT r2 item 2; the TPU VPU does not
contract). This module is the ground truth both backends are judged
against.
"""

import numpy as np

from ..core import constants as C
from ..core import foveation as fov
from ..utils.frames import quantize_unorm
from .bilinear import bilinear_fallback_fsr, debug_tint_mul
from .easu import easu_oracle
from .rcas import rcas_oracle
from .nis import nvscaler_oracle, nvsharpen_oracle
from .cas import cas_upscale_oracle, cas_sharpen_oracle

__all__ = ["pipeline_oracle"]

F32 = np.float32


def _round_unorm(x, bits):
    scale = F32((1 << bits) - 1)
    return np.rint(np.clip(x, 0.0, 1.0) * scale).astype(np.float32)


def pipeline_oracle(frame, render_scale, sharpness, *, use_nis=False,
                    use_cas=False, radius=0.5, debug=False, hdr_mode=0,
                    eye_centers=((0.5, 0.5), (0.5, 0.5)), color_bits=8,
                    cas_max_color_delta=1.0, single_eye=True, eye=0):
    """One frame through the full reference pipeline, NumPy scalar f32.

    frame: (H, W, 4) uint8 (or uint16 when color_bits=10).
    single_eye/eye: the Pipeline's single_eye_per_frame layout and which
    eye this frame is (selects the centre-constant packing,
    PostProcessor.cpp:298-305).
    Returns the output frame with the same dtype/channel convention as
    Pipeline.process (single-wide layout; alpha semantics per stage).
    """
    cbits = color_bits
    abits = 8 if cbits == 8 else 2
    cscale = F32((1 << cbits) - 1)
    ascale = F32((1 << abits) - 1)
    h, w = frame.shape[:2]
    rs = float(render_scale)
    if rs < 1.0:
        out_w, out_h = int(w / rs), int(h / rs)
    else:
        out_w, out_h = int(w * rs), int(h * rs)
    do_up = rs != 1.0
    if use_cas:
        do_sh = not do_up
    elif use_nis:
        do_sh = not do_up
    else:
        do_sh = True

    dec = np.asarray(frame, np.float32)
    rgba = np.empty(frame.shape[:2] + (4,), np.float32)
    rgba[..., :3] = dec[..., :3] * (F32(1.0) / cscale)
    rgba[..., 3] = (dec[..., 3] * (F32(1.0) / ascale)
                    if frame.shape[-1] > 3 else F32(1.0))

    tint = debug_tint_mul(debug)
    pl_, pr_ = eye_centers

    def mask(tile):
        fc = C.foveation_constants(out_w, out_h, radius, pl_, pr_,
                                   single_eye, eye)
        return fov.pixel_mask(out_w, out_h, tile,
                              (fc.centre_left, fc.centre_right),
                              fc.radius_sq)

    stages = []
    if do_up:
        if use_cas:
            def cas_up(x):
                up = cas_upscale_oracle(x[..., :3], sharpness, out_w, out_h)
                fb = bilinear_fallback_fsr(x[..., :3], out_w, out_h)
                fb = fb * tint[:3]
                m = mask(fov.TILE_FSR)[..., None]
                rgb = np.where(m, up, fb)
                return np.concatenate(
                    [rgb, np.ones(rgb.shape[:2] + (1,), np.float32)], axis=-1)
            stages.append(cas_up)
        elif use_nis:
            nis_cfg = C.nvscaler_update_config(
                sharpness, w, h, w, h, out_w, out_h, out_w, out_h,
                hdr_mode=hdr_mode)

            def nis_up(x):
                up = nvscaler_oracle(x, out_w, out_h, nis_cfg)
                fb_rgb = bilinear_fallback_fsr(x[..., :3], out_w, out_h)
                fb = np.concatenate(
                    [fb_rgb, np.ones(fb_rgb.shape[:2] + (1,), np.float32)],
                    axis=-1) * tint
                m = mask(fov.TILE_NIS_SCALER)[..., None]
                return np.where(m, up, fb)
            stages.append(nis_up)
        else:
            def fsr_up(x):
                up = easu_oracle(x[..., :3], out_w, out_h)
                fb = bilinear_fallback_fsr(x[..., :3], out_w, out_h)
                m = mask(fov.TILE_FSR)[..., None]
                rgb = np.where(m, up, fb)
                return np.concatenate(
                    [rgb, np.ones(rgb.shape[:2] + (1,), np.float32)], axis=-1)
            stages.append(fsr_up)

    if do_sh:
        if use_cas:
            def cas_sh(x):
                sh = cas_sharpen_oracle(x[..., :3], sharpness,
                                        cas_max_color_delta)
                fb = x * tint
                m = mask(fov.TILE_FSR)[..., None]
                rgb = np.where(m, sh, fb[..., :3])
                alpha = np.where(m[..., 0], F32(1.0), fb[..., 3])
                return np.concatenate([rgb, alpha[..., None]], axis=-1)
            stages.append(cas_sh)
        elif use_nis:
            nis_cfg_sh = C.nvsharpen_update_config(
                sharpness, out_w, out_h, out_w, out_h, hdr_mode=hdr_mode)

            def nis_sh(x):
                sh = nvsharpen_oracle(x, nis_cfg_sh)
                fb = np.concatenate(
                    [x[..., :3],
                     np.ones(x.shape[:2] + (1,), np.float32)], axis=-1) * tint
                m = mask(fov.TILE_NIS_SHARPEN)[..., None]
                return np.where(m, sh, fb)
            stages.append(nis_sh)
        else:
            sharp_lin = C.fsr_rcas_con(C.rcas_stops_from_slider(sharpness))

            def fsr_sh(x):
                sh = rcas_oracle(x[..., :3], sharp_lin)
                fb = x * tint
                m = mask(fov.TILE_FSR)[..., None]
                rgb = np.where(m, sh, fb[..., :3])
                alpha = np.where(m[..., 0], F32(1.0), fb[..., 3])
                return np.concatenate([rgb, alpha[..., None]], axis=-1)
            stages.append(fsr_sh)

    x = rgba
    for idx, stage in enumerate(stages):
        x = stage(x)
        if idx < len(stages) - 1:
            # UNORM texture round-trip between dispatches (quantize + the
            # framework's multiply-by-reciprocal decode)
            col = quantize_unorm(x[..., :3], cbits)
            alp = quantize_unorm(x[..., 3:], abits)
            x = np.concatenate([col, alp], axis=-1)

    out = np.empty(x.shape[:2] + (4,), np.uint16 if cbits > 8 else np.uint8)
    out[..., :3] = _round_unorm(x[..., :3], cbits)
    out[..., 3] = _round_unorm(x[..., 3], abits)
    return out
