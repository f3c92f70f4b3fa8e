"""The post-processing pipeline — the PyTorch port of vr::PostProcessor.

Reference orchestration being reproduced (src/postprocess/PostProcessor.cpp):
  - output sizing: rs<1 -> out=in/rs, rs>=1 -> out=in*rs  (:512-518)
  - per-eye constant buffers with projection-centred foveation circles
    (:293-310, 416-430)
  - the EASU->RCAS handoff through a UNORM8 texture (:527)
  - lazy per-(shape, config) resource creation = a build cache keyed the
    same way (:136-153); `Reset()` = dropping the cache

This port covers every stage plan of the JAX package on RGBA8 frames, each
one kernel launch per batch: FSR with an upscale (renderScale != 1,
kernels/fsr.py), FSR sharpen-only at renderScale 1 (kernels/rcas.py), NIS
upscale (NVScaler) and NIS at renderScale 1 (NVSharpen, both kernels/nis.py,
HDR modes 0/1/2), and CAS, one CasFilter pass: sharpen-and-upscale at
renderScale != 1, sharpen-only with the maxColorDelta clamp at renderScale 1
(kernels/cas.py). A CUDA tensor runs the CUDA kernel, a CPU tensor its plain
torch version. The signatures are the JAX package's (openvr_fsr_tpu/api/
pipeline.py), plus `device`: the card unless the caller asks for the CPU
(device="cpu"). The options not ported yet raise NotImplementedError naming
the ROADMAP.md entry that ports them. arm_capture saves the next processed
left-eye frame (api/capture.py), as the reference's capture hotkey does.
"""

import numpy as np
import torch

from ..core.config import Config
from ..core import constants as C
from ..core.projection import default_centers
from .capture import save_frame
from ..kernels.cas import build_cas_sharpen, build_cas_upscale
from ..kernels.fsr import build_fsr_fused
from ..kernels.nis import build_nvscaler, build_nvsharpen
from ..kernels.rcas import build_rcas_sharpen
from ..ops.cas import cas_support_scaling
from ..utils.log import get_logger
from ..utils.timing import GpuTimer

__all__ = ["Pipeline", "upscale"]

F32 = np.float32
_PACKED = (torch.uint32, torch.int32)   # packed RGBA8 plane dtypes


def _resolve_device(device):
    """torch.device for a device argument; None is the current CUDA device
    (the card unless the caller asks for the CPU). A CUDA device without a
    usable GPU raises here, never later."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} requested"
                               f"{' by default' if device is None else ''} "
                               "but torch finds no CUDA GPU: pass "
                               "device='cpu' for the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Pipeline:
    """Stateful stereo post-processing pipeline.

    Args:
      config: Config (render_scale / sharpness / use_nis / use_cas /
        radius / debug_mode).
      eye_centers: ((lx,ly),(rx,ry)) normalized projection centres; defaults to
        image centres (symmetric projection, no cant).
      single_eye_per_frame: True = each batch entry is one eye (the reference's
        textureContainsOnlyOneEye); False = double-wide frames holding both.
      color_bits: None or 8 (RGBA8).
      backend, precision, hdr_mode, cas_max_color_delta: the JAX signature;
        only "auto" / "full" run here. hdr_mode is NIS_HDR_MODE (0 none,
        the mod's shipped build; 1 linear; 2 PQ, NIS_Scaler.h:112-116) and
        acts on the NIS paths only; cas_max_color_delta is CasSetup's
        maxColorDelta (ffx_cas.h:379, 1 = unlimited) and clamps the CAS
        sharpen-only path only (the scaling path ends at ASat,
        ffx_cas.h:876-878).
      device: where frames are processed; None = the current CUDA device
        (raises at construction without a GPU), "cpu" = the plain torch
        versions on the CPU. Numpy frames are moved there; a tensor on
        another device raises.
    """

    def __init__(self, config: Config = None, eye_centers=None,
                 single_eye_per_frame=True, color_bits=None, backend="auto",
                 precision="full", hdr_mode=0, cas_max_color_delta=1.0,
                 device=None):
        if backend != "auto":
            raise ValueError(f"backend={backend!r}: the port has one backend, "
                             "'auto' (CUDA kernel for CUDA tensors, plain "
                             "torch for CPU tensors)")
        self.color_bits = int(color_bits or 8)
        if self.color_bits != 8:
            raise NotImplementedError(
                "color_bits=10 is not ported yet: ROADMAP.md Queue A item 5 "
                "(the 10-bit planar path)")
        if precision != "full":
            raise NotImplementedError(
                f"precision={precision!r} is not ported yet: ROADMAP.md "
                "Queue A item 9 (precision='half')")
        self.config = config or Config(enabled=True)
        self.hdr_mode = int(hdr_mode)
        if self.hdr_mode not in (0, 1, 2):
            raise ValueError(f"hdr_mode={hdr_mode!r}: NIS_HDR_MODE is 0 "
                             "(none), 1 (linear) or 2 (PQ)")
        self.cas_max_color_delta = float(cas_max_color_delta)
        self.eye_centers = eye_centers or default_centers()
        self.single_eye_per_frame = single_eye_per_frame
        self.device = _resolve_device(device)
        self._cache = {}
        self.timer = GpuTimer(scale_for_stereo=single_eye_per_frame)
        self._log = get_logger()
        self._capture_armed = None   # (directory, formats) when armed
        self.last_capture_paths = []

    # --- reference hotkey actions (PostProcessor.cpp:659-716) ---------------
    def reset(self):
        """Drop built resources (PostProcessor::Reset analog)."""
        self._cache.clear()

    def toggle_nis(self):
        self.config = self.config.with_(use_nis=not self.config.use_nis)
        self._log.info("Now using %s", "NIS" if self.config.use_nis else "FSR")
        self.reset()

    def toggle_debug(self):
        self.config = self.config.with_(debug_mode=not self.config.debug_mode)
        self._log.info("Debug mode is now %s",
                       "enabled" if self.config.debug_mode else "disabled")
        self.reset()

    def adjust_sharpness(self, delta):
        s = max(self.config.sharpness + delta, 0.0)
        self.config = self.config.with_(sharpness=s)
        self._log.info("Sharpness is now at %g", s)
        self.reset()

    def adjust_radius(self, delta):
        r = max(self.config.radius + delta, 0.0)
        self.config = self.config.with_(radius=r)
        self._log.info("Sharpening radius is now at %g", r)
        self.reset()

    # -------------------------------------------------------------------------
    def output_size(self, in_w, in_h):
        return self.config.output_size(in_w, in_h)

    @property
    def kernels(self):
        """The kernel functions built so far (fsr_fused, rcas_sharpen,
        nvscaler, nvsharpen, cas_upscale or cas_sharpen builds). Each
        counts its CUDA launches in `.launches` and publishes `.reference`
        (its plain torch version), `.pad_to` (the ring pitch) and
        `.dma_geometry` (what it loads and stores, for
        kernels/sol.py::build_dma_floor)."""
        return [fn.kernel for fn in self._cache.values()]

    def _centres_array(self, out_w, out_h, eyes):
        """Per-batch-entry imageCentre/radius cbuffer rows
        (core.constants.centres_payload, PostProcessor.cpp:298-305)."""
        return C.centres_payload(out_w, out_h, self.config.radius,
                                 self.eye_centers, eyes,
                                 self.single_eye_per_frame)

    def _build_kernel(self, b, h, w, eyes):
        """The kernel of the config's stage plan (the JAX package's
        Pipeline._build_impl dispatch, PostProcessor.cpp:530-535, 586-594),
        built for (b, h, w)."""
        cfg = self.config
        if cfg.use_nis and cfg.use_cas:
            raise ValueError("use_nis and use_cas are mutually exclusive")
        do_up, _ = cfg.stage_plan()
        out_w, out_h = cfg.output_size(w, h)
        centres = self._centres_array(out_w, out_h, eyes)
        if cfg.use_cas and do_up:           # CAS: one CasFilter scaling pass
            if not cas_support_scaling(out_w, out_h, w, h):
                self._log.info(
                    "CAS scale factor above the 4x area limit "
                    "(ffx_cas.h:368-372) — output follows the filter anyway")
            return build_cas_upscale(b, h, w, out_w, out_h,
                                     sharpness=cfg.sharpness, centres=centres,
                                     debug=cfg.debug_mode)
        if cfg.use_cas:                     # CAS at renderScale 1: noScaling
            return build_cas_sharpen(
                b, h, w, sharpness=cfg.sharpness, centres=centres,
                debug=cfg.debug_mode,
                max_color_delta=self.cas_max_color_delta)
        if cfg.use_nis and do_up:           # NIS upscale: NVScaler
            nis_cfg = C.nvscaler_update_config(
                cfg.sharpness, w, h, w, h, out_w, out_h, out_w, out_h,
                hdr_mode=self.hdr_mode)
            if not nis_cfg.valid:
                self._log.info(
                    "NIS scale factor outside the supported 0.5..1.0 window "
                    "(NIS_Config.h:226) — output follows the reference anyway")
            return build_nvscaler(b, h, w, out_w, out_h, nis_cfg=nis_cfg,
                                  centres=centres, debug=cfg.debug_mode)
        if cfg.use_nis:                     # NIS at renderScale 1: NVSharpen
            nis_cfg = C.nvsharpen_update_config(cfg.sharpness, w, h, w, h,
                                                hdr_mode=self.hdr_mode)
            return build_nvsharpen(b, h, w, nis_cfg=nis_cfg, centres=centres,
                                   debug=cfg.debug_mode)
        if do_up:                           # FSR: EASU + RCAS, fused
            return build_fsr_fused(b, h, w, out_w, out_h,
                                   sharpness=cfg.sharpness, centres=centres,
                                   debug=cfg.debug_mode)
        # FSR at renderScale 1: sharpen only (PostProcessor.cpp:530)
        return build_rcas_sharpen(b, h, w, sharpness=cfg.sharpness,
                                  centres=centres, debug=cfg.debug_mode)

    def _build(self, b, h, w, eyes, packed):
        kern = self._build_kernel(b, h, w, eyes)

        if packed:
            # zero-copy packed plane: (B, H, W) uint32/int32 RGBA8 texels,
            # carried through the kernel as an int32 view
            def run(x):
                return kern(x.view(torch.int32)).view(x.dtype)
        else:
            def run(x):
                if x.shape[-1] == 3:                 # RGB input: opaque alpha
                    x = torch.cat([x, torch.full(x.shape[:-1] + (1,), 255,
                                                 dtype=x.dtype,
                                                 device=x.device)], dim=-1)
                plane = x.contiguous().view(torch.int32)[..., 0]
                return kern(plane)[..., None].view(torch.uint8)

        # the kernel's ring pitch and DMA geometry, as the JAX package's
        # _packed_run / _jit_io carry them (bench.py reads both)
        run.kernel = kern
        run.pad_to = kern.pad_to
        run.dma_geometry = kern.dma_geometry
        return run

    def _as_tensor(self, frames):
        """Frames as a tensor on the pipeline's device. A tensor elsewhere
        raises: nothing moves between devices behind the caller's back."""
        if isinstance(frames, torch.Tensor):
            if frames.device != self.device:
                raise ValueError(f"frames are on {frames.device}, the "
                                 f"pipeline's device is {self.device}")
            return frames
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def _apply_bounds_layout(self, bounds):
        """The reference's per-Submit layout detection (PostProcessor.cpp:
        136-146): the first entry's VRTextureBounds_t decides single- vs
        double-wide packing; a switch recreates resources (Reset analog) and
        the timer's stereo scaling. Returns the first bounds (or None)."""
        if bounds is None:
            return None
        first_bounds = (bounds[0] if hasattr(bounds[0], "__len__")
                        else bounds)
        one_eye = self.bounds_contain_one_eye(first_bounds)
        if one_eye != self.single_eye_per_frame:
            self._log.info(
                "Texture bounds imply %s layout, recreating resources",
                "single-eye" if one_eye else "double-wide")
            self.single_eye_per_frame = one_eye
            self.timer = GpuTimer(scale_for_stereo=one_eye)
            self.reset()
        return first_bounds

    @staticmethod
    def bounds_contain_one_eye(bounds):
        """The reference's textureContainsOnlyOneEye detection
        (PostProcessor.cpp:146): |uMax - uMin| > 0.5 means the submitted
        bounds cover more than half the texture width, i.e. the texture
        holds a single eye; half-width bounds mean a double-wide shared
        texture. Evaluated in f32 like the C++."""
        u_min, _v_min, u_max, _v_max = (float(x) for x in bounds)
        return bool(abs(F32(u_max) - F32(u_min)) > F32(0.5))

    def crop_output(self, out, bounds):
        """Crop processed frames to the VRTextureBounds_t rectangle
        (headers/openvr.h:609-613), mapped to output pixels. The reference
        never crops — the compositor samples the submitted bounds from the
        full processed texture (VrHooks.cpp:54) — so this is the library-API
        equivalent of that sampling region. Flipped bounds (vMin > vMax,
        used by OpenGL-convention games) select the same rectangle."""
        u0, v0, u1, v1 = (float(x) for x in bounds)
        # packed outputs have no trailing channel dim: (..., H, W)
        packed = out.dtype in _PACKED
        hax, wax = (-2, -1) if packed else (-3, -2)
        h, w = int(out.shape[hax]), int(out.shape[wax])
        x0, x1 = sorted((int(round(u0 * w)), int(round(u1 * w))))
        y0, y1 = sorted((int(round(v0 * h)), int(round(v1 * h))))
        x0, x1 = max(x0, 0), min(x1, w)
        y0, y1 = max(y0, 0), min(y1, h)
        if packed:
            return out[..., y0:y1, x0:x1]
        return out[..., y0:y1, x0:x1, :]

    def process(self, frames, eyes=None, bounds=None, crop=False):
        """frames: (B, H, W, 4|3) or (H, W, 4|3) uint8, or — zero-copy
          packed mode — (B, H, W) / (H, W) uint32 (or int32) holding packed
          RGBA8 texels (little-endian, R in the low byte); the result is
          then packed in the same dtype. A numpy array or a torch tensor.
        eyes: per-entry eye index (default alternating 0,1,...).
        bounds: optional VRTextureBounds_t (uMin, vMin, uMax, vMax), or a
          per-entry sequence of them. Like the reference (PostProcessor.cpp:
          146), the first entry's bounds decide the eye layout: half-width
          bounds switch the pipeline to double-wide packing (sticky until
          the next bounds say otherwise; switching drops built resources,
          the Reset() analog).
        crop: with bounds, return only the bounded region of the output
          (the compositor's sampling rectangle).
        Returns a tensor of the processed frames at output resolution, same
        dtype, on the frames' device."""
        if not self.config.enabled:
            return frames
        first_bounds = self._apply_bounds_layout(bounds)
        x = self._as_tensor(frames)
        packed = x.dtype in _PACKED
        if not packed and x.dtype != torch.uint8:
            raise TypeError(f"frames of dtype {x.dtype}: the port takes "
                            "uint8 RGBA8 or a packed uint32/int32 plane")
        squeeze = x.ndim == (2 if packed else 3)
        if squeeze:
            x = x[None]
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        if eyes is None:
            eyes = tuple(i % 2 for i in range(b))
        else:
            eyes = tuple(int(e) for e in eyes)
        key = (b, h, w, str(x.dtype), eyes, self.config,
               self.single_eye_per_frame, self.hdr_mode,
               self.cas_max_color_delta, x.device)
        fn = self._cache.get(key)
        if fn is None:
            self._log.info(
                "Creating post-processing resources: %dx%d -> %s (%s, %s)",
                w, h, self.config.output_size(w, h),
                "CAS" if self.config.use_cas
                else "NIS" if self.config.use_nis else "FSR", x.device)
            fn = self._build(b, h, w, eyes, packed)
            self._cache[key] = fn
        if self.config.debug_mode:
            # per-stereo-pair time: a batch of B single-eye frames covers
            # B/2 pairs (double-wide frames: one pair each)
            pairs = b / 2.0 if self.single_eye_per_frame else float(b)
            out = self.timer.measure(fn, x, pairs=pairs)
        else:
            out = fn(x)
        if self._capture_armed is not None:
            # Deferred capture (PostProcessor.cpp:634-637): the armed flag
            # saves the *next processed left-eye frame* and clears itself.
            # Double-wide frames contain the left eye, so any frame counts.
            idx = (0 if not self.single_eye_per_frame
                   else next((i for i, e in enumerate(eyes) if e == 0), None))
            if idx is not None:
                directory, formats = self._capture_armed
                self._capture_armed = None
                self.last_capture_paths = save_frame(
                    out[idx], directory=directory,
                    use_nis=self.config.use_nis,
                    sharpness=self.config.sharpness,
                    radius=self.config.radius, formats=formats)
                self._log.info("Captured frame to %s",
                               [str(p) for p in self.last_capture_paths])
        if crop and first_bounds is not None:
            out = self.crop_output(out, first_bounds)
        return out[0] if squeeze else out

    def arm_capture(self, directory=".", formats=("dds",)):
        """Arm a deferred capture: the next `process` call that includes a
        left-eye (eye 0) frame saves its processed output with the
        reference filename scheme, then the flag clears — the semantics of
        the reference's takeCapture hotkey (PostProcessor.cpp:707 sets the
        flag, :634-637 saves on the next Eye_Left submit). The frame leaves
        the card once. Written paths land in `self.last_capture_paths`."""
        self._capture_armed = (directory, tuple(formats))


def upscale(frame, render_scale=None, sharpness=0.9, use_nis=False, radius=0.5,
            eye_centers=None, debug=False, eyes=None, color_bits=None,
            single_eye_per_frame=True, backend="auto", precision="full",
            bounds=None, crop=False, use_cas=False, device=None):
    """One-shot functional API.

    frame: (H, W, 4) or (B, H, W, 4) uint8 RGBA, or a packed uint32/int32
    plane, as a numpy array or a torch tensor. render_scale: <1 upscales by
    1/rs; >1 supersamples by rs; 1/None = sharpen only. use_nis selects
    NVIDIA Image Scaling (NVScaler / NVSharpen) instead of FSR.
    bounds: optional VRTextureBounds_t (uMin, vMin, uMax, vMax) — half-width
    bounds select double-wide eye packing (PostProcessor.cpp:146); with
    crop=True only the bounded output region is returned. use_cas selects
    FFX CAS (one CasFilter pass, ffx_cas.h). device: as Pipeline's. Other
    args mirror openvr_mod.cfg keys. Returns processed frame(s) as a
    tensor.
    """
    cfg = Config(enabled=True, use_nis=use_nis, use_cas=use_cas,
                 render_scale=1.0 if render_scale is None else float(render_scale),
                 sharpness=float(sharpness), radius=float(radius),
                 debug_mode=bool(debug))
    pipe = Pipeline(cfg, eye_centers=eye_centers,
                    single_eye_per_frame=single_eye_per_frame,
                    color_bits=color_bits, backend=backend,
                    precision=precision, device=device)
    return pipe.process(frame, eyes=eyes, bounds=bounds, crop=crop)
