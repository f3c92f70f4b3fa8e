"""The port's cfg loader (openvr_fsr_tpu_torch/core/config.py) against the
JAX package's, which reads openvr_mod.cfg text with its native scanner
(native/src/ovrfsr_native.cc) and falls back to json where that fails.

Each text of the corpus is held against its expected Config, written out
from the JAX loader with the native library built, and, where the native
library is available, against that loader itself and its scanner's flat
key=value output.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu.core import config as JCFG  # noqa: E402
from openvr_fsr_tpu import native_rt  # noqa: E402

from openvr_fsr_tpu_torch.core import config as TCFG  # noqa: E402

_SHIPPED = """{
  "fsr": {
    // enable FSR
    "enabled": true,
    "useNIS": false,
    "renderScale": 0.77,
    "sharpness": 0.9,
    "radius": 0.5,
    "applyMIPBias": true,
    "debugMode": false,
    "hotkeys": {
      "enabled": true, "requireCtrl": false, "requireAlt": false,
      "requireShift": false, "toggleUseNIS": 112, "toggleDebugMode": 113,
      "decreaseSharpness": 114, "increaseSharpness": 115,
      "decreaseRadius": 116, "increaseRadius": 117, "captureOutput": 118
    }
  }
}
"""

# name -> (cfg text, the fields that differ from Config(), the hotkeys that
# differ from Hotkeys()), as the JAX loader reads them with the native
# scanner
CORPUS = {
    "trailing_comma": (
        '{"fsr": {"enabled": true, "renderScale": 0.75,}}',
        {"enabled": True, "render_scale": 0.75, "sharpness": 1.0}, {}),
    "false_as_string": (
        '{"fsr": {"enabled": "false", "renderScale": 0.75}}',
        {"render_scale": 0.75, "sharpness": 1.0}, {}),
    "true_as_string": (
        '{"fsr": {"enabled": "true", "useNIS": "true"}}',
        {"enabled": True, "use_nis": True, "sharpness": 1.0}, {}),
    "comments": (
        '{ "fsr": { // line\n "enabled": true, /* block, "radius": 0.1 */ '
        '"radius": 0.3,\n "sharpness": 0.4 // "x"\n } }',
        {"enabled": True, "sharpness": 0.4, "radius": 0.3}, {}),
    "quoted_number": (
        '{"fsr": {"enabled": true, "renderScale": "0.67", "sharpness": "0.5"}}',
        {"enabled": True, "render_scale": 0.67, "sharpness": 0.5}, {}),
    "int_bool": (
        '{"fsr": {"enabled": 1, "debugMode": 0, "applyMIPBias": 0}}',
        {"enabled": True, "sharpness": 1.0, "apply_mip_bias": False}, {}),
    "quoted_hotkey_bool": (
        '{"fsr": {"enabled": true, "hotkeys": {"enabled": "false", '
        '"requireCtrl": "true", "toggleUseNIS": "120"}}}',
        {"enabled": True, "sharpness": 1.0},
        {"enabled": False, "require_ctrl": True, "toggle_use_nis": 120}),
    # a bare token the converter leaves as a string: a parse error
    "null": ('{"fsr": {"enabled": true, "radius": null}}', {}, {}),
    "no_root_key": ('{"enabled": true, "renderScale": 0.5}',
                    {"sharpness": 1.0}, {}),
    "duplicate_key": (
        '{"fsr": {"renderScale": 0.5, "enabled": true, "renderScale": 0.59}}',
        {"enabled": True, "render_scale": 0.59, "sharpness": 1.0}, {}),
    "nested_object": (
        '{"fsr": {"enabled": true, "extra": {"radius": 0.1, "deep": {"x": 1}},'
        ' "radius": 0.25, "hotkeys": {"captureOutput": 90, "sub": {"a": 2}}}}',
        {"enabled": True, "sharpness": 1.0, "radius": 0.25},
        {"capture_output": 90}),
    "negative_sharpness": ('{"fsr": {"enabled": true, "sharpness": -0.5}}',
                           {"enabled": True, "sharpness": 0.0}, {}),
    "bare_token": ('{"fsr": {"enabled": true, "renderScale": abc}}', {}, {}),
    "array_value": (
        '{"fsr": {"enabled": true, "list": [1, {"radius": 0.1}, "]"], '
        '"radius": 0.2}}',
        {"enabled": True, "sharpness": 1.0, "radius": 0.2}, {}),
    "other_root_key": (
        '{"other": {"enabled": false, "fsr": {"radius": 0.1}}, "fsr": '
        '{"enabled": true, "useCAS": true, "renderScale": 1.3}}',
        {"enabled": True, "use_cas": True, "render_scale": 1.3,
         "sharpness": 1.0}, {}),
    "shipped_cfg": (_SHIPPED, {"enabled": True, "render_scale": 0.77,
                               "sharpness": 0.9}, {}),
    # the scanner fails and so does json: the defaults
    "scanner_fails": ('{"fsr": {"enabled" true}}', {}, {}),
    "escaped_quote_key": ('{"fsr": {"ena\\"bled": true, "radius": 0.1}}',
                          {"sharpness": 1.0, "radius": 0.1}, {}),
    # the scanner's output overflows its 64 KiB buffer: json reads it and
    # ignores the unknown string member
    "scanner_overflow": (
        '{"fsr": {"enabled": true, "radius": 0.4, "pad": "' + "x" * 70000
        + '"}}', {"enabled": True, "sharpness": 1.0, "radius": 0.4}, {}),
}
KINDS = ["expected", "jax_native"]


def _expected(fields, hotkeys):
    want = dataclasses.asdict(TCFG.Config())
    want.update(fields)
    want["hotkeys"].update(hotkeys)
    return want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(CORPUS))
def test_load_config_reads_as_the_jax_package(name, kind):
    text, fields, hotkeys = CORPUS[name]
    got = dataclasses.asdict(TCFG.load_config(text=text))
    if kind == "expected":
        assert got == _expected(fields, hotkeys)
        return
    if not native_rt.available():
        pytest.skip("the JAX package's native library is not built")
    assert got == dataclasses.asdict(JCFG.load_config(text=text))
    try:
        native = native_rt.parse_cfg_native(text)
    except ValueError:            # the scanner returned -1
        native = None
    assert TCFG.scan_cfg(text) == native


def test_repaired_texts():
    """The two texts the port used to read otherwise."""
    cfg = TCFG.load_config(text=CORPUS["trailing_comma"][0])
    assert cfg.enabled and cfg.render_scale == 0.75
    assert not TCFG.load_config(text=CORPUS["false_as_string"][0]).enabled


def test_load_config_from_a_file(tmp_path):
    path = tmp_path / "openvr_mod.cfg"
    path.write_text(_SHIPPED)
    assert TCFG.load_config(path=path) == TCFG.Config.config_from_dict(
        _expected(*CORPUS["shipped_cfg"][1:]))
