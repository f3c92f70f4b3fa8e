"""Config system — same schema and semantics as openvr_mod.cfg.

Mirrors struct Config (reference src/postprocess/Config.h:10-69): the JSON
file uses comment-tolerant JSON under the root key "fsr" (the reference parses
it with jsoncpp, which accepts // comments). Defaults and clamping match
Config::Load exactly (sharpness floored at 0, Config.h:40).

Hotkey key-codes are retained for config-file compatibility; the interactive
demo maps them to terminal keys (there is no Win32 GetAsyncKeyState here).

A copy of openvr_fsr_tpu/core/config.py (the port cannot import that
package: its __init__ imports jax). The cfg text is read as the JAX package
reads it when its native library is built: first by the scanner of
native/src/ovrfsr_native.cc:47-164, whose flat key=value lines go through
the JAX converter, where any value left as a string is a parse error; if
the scanner fails, by Python's json on the comment-stripped text. The port
scans in pure Python (`scan_cfg`), its one path; its native runtime
library (csrc/ovrfsr_native.cc, native_rt.parse_cfg_native) holds the same
scanner, and tests/test_torch_native.py holds the two equal. One addition:
`Config.config_from_dict` rebuilds a Config from `dataclasses.asdict`.
"""

import json
import re
from dataclasses import dataclass, field, replace
from pathlib import Path

__all__ = ["Config", "Hotkeys", "load_config", "scan_cfg",
           "strip_json_comments", "AMD_PRESETS"]

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


_WS = " \t\r\n,"          # skip_ws: commas count as whitespace (:73)
_BARE_END = ",}\n\r\t "    # a bare value runs up to one of these (:111)
_CFG_CAP = 1 << 16        # native_rt.parse_cfg_native's output buffer


def _strip_comments_scanner(src):
    """strip_comments (ovrfsr_native.cc:47-71): // and /* */ removed outside
    string literals; a // comment keeps its newline."""
    out, in_str, esc, i, n = [], False, False, 0, len(src)
    while i < n:
        ch = src[i]
        if in_str:
            out.append(ch)
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
            out.append(ch)
        elif src.startswith("//", i):
            while i < n and src[i] != "\n":
                i += 1
            if i == n:
                break
            out.append("\n")
        elif src.startswith("/*", i):
            i += 2
            while i < n and not src.startswith("*/", i):
                i += 1
            if i == n:
                break
            i += 1
        else:
            out.append(ch)
        i += 1
    return "".join(out)


class _Scanner:
    """The scanner's cursor over the comment-stripped text; `at` is '' at
    the end, as *p is NUL there."""

    def __init__(self, text):
        self.s, self.p = text, 0

    @property
    def at(self):
        return self.s[self.p] if self.p < len(self.s) else ""

    def skip_ws(self):
        while self.at and self.at in _WS:
            self.p += 1

    def bare(self, stops):
        start = self.p
        while self.at and self.at not in stops:
            self.p += 1
        return self.s[start:self.p]

    def string(self):
        """parse_string (:75-84): backslash takes the next char as is.
        None where the C function returns false."""
        if self.at != '"':
            return None
        out = []
        self.p += 1
        while self.at and self.at != '"':
            if self.at == "\\" and self.p + 1 < len(self.s):
                self.p += 1
            out.append(self.at)
            self.p += 1
        if self.at != '"':
            return None
        self.p += 1
        return "".join(out)

    def emit_object(self, prefix, out):
        """emit_object (:88-115): scalar members as prefix+key=value lines,
        nested objects flattened, arrays skipped."""
        if self.at != "{":
            return False
        self.p += 1
        while True:
            self.skip_ws()
            if self.at == "}":
                self.p += 1
                return True
            key = self.string()
            if key is None:
                return False
            self.skip_ws()
            if self.at != ":":
                return False
            self.p += 1
            self.skip_ws()
            if self.at == "{":
                if not self.emit_object(prefix + key + ".", out):
                    return False
            elif self.at == "[":
                if not self.skip_value():
                    return False
            elif self.at == '"':
                v = self.string()
                if v is None:
                    return False
                out.append(f"{prefix}{key}={v}\n")
            else:
                out.append(f"{prefix}{key}={self.bare(_BARE_END)}\n")

    def skip_value(self):
        """skip_value (:117-137)."""
        self.skip_ws()
        if self.at in ("{", "["):
            open_, close = self.at, "}" if self.at == "{" else "]"
            depth, in_str, esc = 0, False, False
            while self.at:
                ch = self.at
                self.p += 1
                if in_str:
                    if esc:
                        esc = False
                    elif ch == "\\":
                        esc = True
                    elif ch == '"':
                        in_str = False
                elif ch == '"':
                    in_str = True
                elif ch == open_:
                    depth += 1
                elif ch == close:
                    depth -= 1
                    if depth == 0:
                        return True
            return False
        if self.at == '"':
            return self.string() is not None
        self.bare(",}]\n\r\t ")
        return True


def scan_cfg(text):
    """ovrfsr_parse_cfg (ovrfsr_native.cc:139-164) and the line split of
    native_rt.parse_cfg_native: the root object's "fsr" members as a dict
    of key -> raw string ("hotkeys.<key>" for the nested object), or None
    where the scanner fails (returns -1)."""
    try:
        text.encode()                      # what the native call is given
    except UnicodeError:
        return None
    text = text.split("\0", 1)[0]          # the C string ends at a NUL
    sc = _Scanner(_strip_comments_scanner(text))
    sc.skip_ws()
    if sc.at != "{":
        return None
    sc.p += 1
    out = []
    while True:
        sc.skip_ws()
        if sc.at in ("}", ""):
            break
        key = sc.string()
        if key is None:
            return None
        sc.skip_ws()
        if sc.at != ":":
            return None
        sc.p += 1
        sc.skip_ws()
        if key == "fsr" and sc.at == "{":
            if not sc.emit_object("", out):
                return None
        elif not sc.skip_value():
            return None
    result = "".join(out)
    if len(result.encode()) >= _CFG_CAP:
        return None
    flat = {}
    for line in result.splitlines():
        k, _, v = line.partition("=")
        flat[k] = v
    return flat


def _conv(v):
    """The JAX converter of one raw value (core/config.py:129-138)."""
    if v in ("true", "false"):
        return v == "true"
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def _parse_fsr_object(text):
    """The 'fsr' object + nested hotkeys as plain dicts: the scanner's flat
    values through the JAX converter; Python json on the comment-stripped
    source where the scanner fails."""
    flat = scan_cfg(text)
    if flat is not None:
        fsr = {k: _conv(v) for k, v in flat.items() if "." not in k}
        fsr["hotkeys"] = {k.split(".", 1)[1]: _conv(v)
                          for k, v in flat.items() if k.startswith("hotkeys.")}
        # jsoncpp rejects bare non-JSON tokens ("renderScale": abc); the
        # scanner passes them through as raw strings and the cfg schema has
        # no string-typed keys, so a surviving string is a parse error
        # (the JAX package's core/config.py:142-150)
        if any(isinstance(v, str)
               for v in [*fsr.values(), *fsr["hotkeys"].values()]
               if not isinstance(v, dict)):
            raise ValueError("malformed scalar in cfg")
        return fsr
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
