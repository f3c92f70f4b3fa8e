"""Config system — same schema and semantics as openvr_mod.cfg.

Mirrors struct Config (reference src/postprocess/Config.h:10-69): the JSON
file uses comment-tolerant JSON under the root key "fsr" (the reference parses
it with jsoncpp, which accepts // comments). Defaults and clamping match
Config::Load exactly (sharpness floored at 0, Config.h:40).

Hotkey key-codes are retained for config-file compatibility; the interactive
demo maps them to terminal keys (there is no Win32 GetAsyncKeyState here).

A copy of openvr_fsr_tpu/core/config.py (the port cannot import that
package: its __init__ imports jax). Two differences: the cfg text is parsed
by Python's json on a comment-stripped source only (the JAX package first
tries its native C++ scanner, with the same silent-fallback contract), and
`Config.config_from_dict` rebuilds a Config from `dataclasses.asdict`.
"""

import json
import re
from dataclasses import dataclass, field, replace
from pathlib import Path

__all__ = ["Config", "Hotkeys", "load_config", "strip_json_comments",
           "AMD_PRESETS"]

# The AMD FSR1 quality presets documented in the reference cfg
# (src/openvr_mod.cfg:17-21): preset name -> renderScale.
AMD_PRESETS = {
    "ultra_quality": 0.77,
    "quality": 0.67,
    "balanced": 0.59,
    "performance": 0.50,
}

# Win32 virtual-key defaults (F1..F7), kept for cfg-file parity.
VK_F1, VK_F2, VK_F3, VK_F4, VK_F5, VK_F6, VK_F7 = 112, 113, 114, 115, 116, 117, 118


@dataclass(frozen=True)
class Hotkeys:
    enabled: bool = True
    require_ctrl: bool = False
    require_alt: bool = False
    require_shift: bool = False
    toggle_use_nis: int = VK_F1
    toggle_debug_mode: int = VK_F2
    decrease_sharpness: int = VK_F3
    increase_sharpness: int = VK_F4
    decrease_radius: int = VK_F5
    increase_radius: int = VK_F6
    capture_output: int = VK_F7


@dataclass(frozen=True)
class Config:
    """Pipeline configuration (defaults = Config.h defaults for a missing or
    empty cfg file; note the *file* defaults differ slightly — sharpness 1.0
    when the key is absent from a present file, per Config.h:39)."""

    enabled: bool = False          # "fsrEnabled"
    use_nis: bool = False          # use NVIDIA Image Scaling instead of FSR
    # Framework extension (not in the reference cfg schema): select FFX CAS
    # (src/cas/ffx_cas.h) — the upscaler the mod shipped before FSR1 and
    # keeps in-tree but out of the build (absent from src/CMakeLists.txt:
    # 58-90). CasFilter sharpens and upscales in ONE pass: rs != 1 runs the
    # scaling path (noScaling=false), rs == 1 the sharpen-only path.
    use_cas: bool = False          # "useCAS" (extension key)
    render_scale: float = 1.0      # <1: out=in/rs ; >1: out=in*rs ; =1: sharpen only
    sharpness: float = 0.75        # [0,1] slider
    radius: float = 0.5            # foveation radius as fraction of outH (2.0 = off)
    apply_mip_bias: bool = True    # documented caller-side concern on TPU
    debug_mode: bool = False       # visualize radius + log timings
    hotkeys: Hotkeys = field(default_factory=Hotkeys)

    def with_(self, **kw):
        return replace(self, **kw)

    @classmethod
    def config_from_dict(cls, d):
        """Config from `dataclasses.asdict(cfg)` of this Config or of the JAX
        package's (same field names, hotkeys as a nested dict)."""
        d = dict(d)
        hk = d.pop("hotkeys", None)
        return cls(**d, hotkeys=Hotkeys(**hk) if hk is not None else Hotkeys())

    @classmethod
    def from_preset(cls, preset, **kw):
        """Config at an AMD quality preset ('ultra_quality', 'quality',
        'balanced', 'performance' — src/openvr_mod.cfg:17-21), enabled,
        with the cfg-file defaults otherwise; kw overrides any field
        (including render_scale)."""
        kw.setdefault("enabled", True)
        kw.setdefault("render_scale", AMD_PRESETS[preset.lower()])
        return cls(**kw)

    def output_size(self, in_w, in_h):
        """PostProcessor::PrepareResources sizing (PostProcessor.cpp:512-518).

        renderScale < 1 *divides* (the game rendered small; we upscale back);
        renderScale >= 1 multiplies. Uses C uint truncation.
        """
        rs = float(self.render_scale)
        if rs < 1.0:
            return int(in_w / rs), int(in_h / rs)
        return int(in_w * rs), int(in_h * rs)

    def stage_plan(self):
        """The upscale/sharpen truth table (PostProcessor.cpp:530-535, 586-594).

        Returns (do_upscale, do_sharpen):
          FSR:  upscale iff rs != 1; sharpen always.
          NIS:  rs != 1 -> NVScaler only; rs == 1 -> NVSharpen only.
          CAS:  one CasFilter pass — scaling (which also sharpens) iff
                rs != 1, else sharpen-only (noScaling).
        """
        rs = float(self.render_scale)
        do_upscale = rs != 1.0
        if self.use_cas:
            return do_upscale, not do_upscale
        do_sharpen = (not self.use_nis) or rs == 1.0
        return do_upscale, do_sharpen


_LINE_COMMENT = re.compile(r'("(?:[^"\\]|\\.)*")|//[^\n]*|/\*.*?\*/', re.S)


def strip_json_comments(text):
    """Remove // and /* */ comments outside of string literals (jsoncpp
    compatibility for openvr_mod.cfg)."""
    return _LINE_COMMENT.sub(lambda m: m.group(1) or "", text)


def _parse_fsr_object(text):
    """The 'fsr' object + nested hotkeys as plain dicts."""
    root = json.loads(strip_json_comments(text))
    return root.get("fsr", {})


def load_config(path=None, text=None):
    """Load an openvr_mod.cfg-style JSON config. Missing file or parse error
    -> defaults (Config.h:59-61: silent fallback)."""
    if text is None:
        if path is None:
            return Config()
        try:
            text = Path(path).read_text()
        except OSError:
            return Config()
    try:
        return _config_from_fsr(_parse_fsr_object(text))
    except (json.JSONDecodeError, ValueError, TypeError):
        return Config()


def _config_from_fsr(fsr):
    hk = fsr.get("hotkeys", {})
    sharpness = float(fsr.get("sharpness", 1.0))
    if sharpness < 0:
        sharpness = 0.0  # Config.h:40
    return Config(
        enabled=bool(fsr.get("enabled", False)),
        sharpness=sharpness,
        render_scale=float(fsr.get("renderScale", 1.0)),
        apply_mip_bias=bool(fsr.get("applyMIPBias", True)),
        radius=float(fsr.get("radius", 0.5)),
        debug_mode=bool(fsr.get("debugMode", False)),
        use_nis=bool(fsr.get("useNIS", False)),
        use_cas=bool(fsr.get("useCAS", False)),
        hotkeys=Hotkeys(
            enabled=bool(hk.get("enabled", True)),
            require_ctrl=bool(hk.get("requireCtrl", False)),
            require_alt=bool(hk.get("requireAlt", False)),
            require_shift=bool(hk.get("requireShift", False)),
            toggle_use_nis=int(hk.get("toggleUseNIS", VK_F1)),
            toggle_debug_mode=int(hk.get("toggleDebugMode", VK_F2)),
            decrease_sharpness=int(hk.get("decreaseSharpness", VK_F3)),
            increase_sharpness=int(hk.get("increaseSharpness", VK_F4)),
            decrease_radius=int(hk.get("decreaseRadius", VK_F5)),
            increase_radius=int(hk.get("increaseRadius", VK_F6)),
            capture_output=int(hk.get("captureOutput", VK_F7)),
        ),
    )
