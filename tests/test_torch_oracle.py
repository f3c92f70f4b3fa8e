"""The port's copy of the NumPy oracle (openvr_fsr_tpu_torch/oracle/) is the
JAX package's judge: each module byte-identical to its original, its
relative imports resolved to the port's own core/ and utils/frames.py, and
pipeline_oracle bit-equal to the JAX package's over every kwarg at small
sizes, color_bits=10 included. tools/parity.py judges the card with it.
"""

import inspect
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from openvr_fsr_tpu.oracle.pipeline import pipeline_oracle as j_oracle  # noqa: E402
from openvr_fsr_tpu.utils import frames as JFR  # noqa: E402

import openvr_fsr_tpu_torch.oracle.pipeline as TOP  # noqa: E402
from openvr_fsr_tpu_torch.oracle.pipeline import pipeline_oracle as t_oracle  # noqa: E402
from openvr_fsr_tpu_torch.utils import frames as TFR  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MODULES = ["__init__", "intrinsics", "bilinear", "easu", "rcas", "nis", "cas",
           "pipeline"]
# the one edit, in __init__'s docstring: the path of the reference sources
# on the machine the oracle was written on becomes their path in the
# reference repository; no code changes
DOC_LINE = 3
SOURCES = "src/fsr/ffx_fsr1.h, ffx_a.h, src/nis/NIS_Scaler.h)."
OFF_CENTRE = ((0.3, 0.6), (0.7, 0.4))


@pytest.mark.parametrize("name", MODULES)
def test_module_is_a_copy(name):
    want = (REPO / "openvr_fsr_tpu" / "oracle" / f"{name}.py").read_bytes()
    got = (REPO / "openvr_fsr_tpu_torch" / "oracle" / f"{name}.py").read_bytes()
    if name == "__init__":
        got = got.decode().splitlines(True)
        want = want.decode().splitlines(True)
        assert len(got) == len(want)
        assert got[DOC_LINE] == f"(reference: {SOURCES}\n"
        head, path = want[DOC_LINE].split(" ", 1)
        path, tail = path.split("src/fsr/", 1)
        assert head == "(reference:" and "src/fsr/" + tail == SOURCES + "\n"
        assert path.startswith("/") and path.endswith("/")
        del got[DOC_LINE], want[DOC_LINE]
    assert got == want


def test_the_package_holds_only_the_copies():
    files = sorted(p.stem for p in
                   (REPO / "openvr_fsr_tpu_torch" / "oracle").glob("*.py"))
    assert files == sorted(MODULES)


def test_relative_imports_resolve_to_the_port():
    assert TOP.C.__name__ == "openvr_fsr_tpu_torch.core.constants"
    assert TOP.fov.__name__ == "openvr_fsr_tpu_torch.core.foveation"
    assert TOP.quantize_unorm is TFR.quantize_unorm
    import openvr_fsr_tpu_torch.oracle.nis as TN
    assert TN.COEF_SCALE.__class__ is np.ndarray
    assert TN.NisConfig.__module__ == "openvr_fsr_tpu_torch.core.constants"


@pytest.mark.parametrize("name", ["quantize_unorm", "decode_unorm"])
def test_frame_helpers_are_copies(name):
    assert inspect.getsource(getattr(TFR, name)) == \
        inspect.getsource(getattr(JFR, name))
    assert name in TFR.__all__
    rng = np.random.default_rng(2)
    for bits in (8, 10):
        x = np.concatenate([rng.random(500, np.float32) * 1.2 - 0.1,
                            np.float32([0.0, 1.0, 0.5 / 255, 1.5 / 255])])
        if name == "decode_unorm":
            x = rng.integers(0, 1 << bits, 500)
        got = getattr(TFR, name)(x, bits)
        want = getattr(JFR, name)(x, bits)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _frame(h, w, bits, seed):
    if bits == 8:
        f = JFR.noise_frame(h, w, seed=seed)
        f[: h // 2] = JFR.zone_plate_frame(h, w)[: h // 2]
        return f
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 1024, (h, w, 4)).astype(np.uint16)
    f[..., 3] = rng.integers(0, 4, (h, w))
    return f


CASES = [
    # (render_scale, sharpness, kwargs)
    (0.75, 0.9, dict(radius=0.5)),
    (1.0, 0.9, dict(radius=0.4)),
    (1.3, 0.9, dict(radius=0.5)),
    (0.75, 0.9, dict(radius=0.2, debug=True)),
    (1.0, 0.9, dict(radius=0.3, debug=True)),
    (0.75, 0.9, dict(radius=0.0, debug=True)),
    (0.75, 0.7, dict(use_nis=True, radius=0.5)),
    (0.75, 0.7, dict(use_nis=True, radius=2.0, hdr_mode=1)),
    (0.75, 0.7, dict(use_nis=True, radius=0.5, hdr_mode=2)),
    (1.0, 0.7, dict(use_nis=True, radius=0.4)),
    (1.0, 0.7, dict(use_nis=True, radius=2.0, hdr_mode=1)),
    (1.0, 0.7, dict(use_nis=True, radius=0.4, hdr_mode=2, debug=True)),
    (1.3, 0.7, dict(use_nis=True, radius=0.5)),
    (0.75, 0.8, dict(use_cas=True, radius=0.5)),
    (1.0, 0.8, dict(use_cas=True, radius=0.4)),
    (1.0, 0.8, dict(use_cas=True, radius=2.0, cas_max_color_delta=0.05)),
    (1.3, 0.8, dict(use_cas=True, radius=0.5, debug=True)),
    (0.75, 0.9, dict(radius=0.5, single_eye=False)),
    (1.0, 0.7, dict(use_nis=True, radius=0.5, single_eye=False)),
    (0.75, 0.9, dict(radius=0.3, eye=1, eye_centers=OFF_CENTRE)),
    (0.75, 0.7, dict(use_nis=True, radius=0.3, eye=1,
                     eye_centers=OFF_CENTRE)),
    (1.0, 0.8, dict(use_cas=True, radius=0.3, eye=1,
                    eye_centers=OFF_CENTRE)),
    (0.75, 0.9, dict(radius=0.5, color_bits=10)),
    (1.0, 0.9, dict(radius=0.4, color_bits=10, debug=True)),
    (0.75, 0.7, dict(use_nis=True, radius=0.5, color_bits=10)),
    (1.0, 0.8, dict(use_cas=True, radius=0.4, color_bits=10)),
]


@pytest.mark.parametrize("rs,sharpness,kw", CASES)
def test_pipeline_oracle_bit_equal(rs, sharpness, kw):
    h, w = (24, 64) if kw.get("single_eye", True) is False else (24, 32)
    frame = _frame(h, w, kw.get("color_bits", 8), seed=len(kw) + int(rs * 4))
    got = t_oracle(frame, rs, sharpness, **kw)
    want = j_oracle(frame, rs, sharpness, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
