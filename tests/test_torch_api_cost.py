"""The host's cost of a call: tools/api_cost.py (the [api] measurement of
chip_smoke.py) and the launches' scalar arguments, converted once per
build (a call converts none), on the CPU. The measurement itself needs the
card: `python3 -m openvr_fsr_tpu_torch.tools.api_cost` runs there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import openvr_fsr_tpu_torch as T  # noqa: E402
from openvr_fsr_tpu_torch.core import constants as C  # noqa: E402
from openvr_fsr_tpu_torch.kernels import cas as KCAS  # noqa: E402
from openvr_fsr_tpu_torch.kernels import fsr as KFSR  # noqa: E402
from openvr_fsr_tpu_torch.kernels import rcas as KRCAS  # noqa: E402
from openvr_fsr_tpu_torch.kernels._common import debug_tint  # noqa: E402
from openvr_fsr_tpu_torch.ops.cas import cas_setup  # noqa: E402
from openvr_fsr_tpu_torch.ops.common import HALF, lit  # noqa: E402
from openvr_fsr_tpu_torch.tools import api_cost  # noqa: E402
from openvr_fsr_tpu_torch.utils import frames as FR  # noqa: E402

from torch_entry_calls import entry_calls  # noqa: E402,F401

# kernel: (its module, the plan's config)
KERNELS = {
    "fsr_fused": (KFSR, dict(render_scale=0.75)),
    "rcas_sharpen": (KRCAS, dict(render_scale=1.0)),
    "cas_upscale": (KCAS, dict(render_scale=0.75, use_cas=True)),
    "cas_sharpen": (KCAS, dict(render_scale=1.0, use_cas=True)),
}


@pytest.mark.parametrize("precision", ["full", "half"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_launch_converts_no_scalar(kernel, precision, monkeypatch,
                                  entry_calls):
    """Each launch passes the sharpness (and CAS sharpen's max colour
    delta) in the kernel's working type, the same values on every call,
    with lit() taken out after the build: the conversion is the build's,
    not the call's. The tables' pointers are taken at the first launch
    on a device, not again."""
    module, plan = KERNELS[kernel]
    pipe = T.Pipeline(T.Config(enabled=True, sharpness=0.9, **plan),
                      precision=precision, cas_max_color_delta=0.05,
                      device="cpu")
    fn = pipe._build(2, 45, 61, (0, 1), False).kernel

    def no_lit(*a):
        raise AssertionError("lit() called by a launch")
    monkeypatch.setattr(module, "lit", no_lit)
    x = torch.zeros((2, 45, 61), dtype=torch.int32)
    out, err = fn.launch(x)
    assert err == 0
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: 7)
    out, err = fn.launch(x)
    assert err == 0
    seen = [args for _, _, args in entry_calls]
    assert seen[1][:2] == (7, 7) and seen[0][2:] == seen[1][2:]
    dt = HALF if precision == "half" else torch.float32
    sharp = (cas_setup(0.9) if kernel.startswith("cas")
             else C.fsr_rcas_con(C.rcas_stops_from_slider(0.9)))
    floats = [[a for a in args if isinstance(a, float)] for args in seen]
    assert floats[0] == floats[1]
    assert floats[0][0] == lit(sharp, dt)
    if kernel == "cas_sharpen":
        assert floats[0][1] == lit(np.float32(0.05), dt)
    assert floats[0][-1] == float(debug_tint(False))      # the tint


def test_main_needs_a_gpu():
    """With no CUDA GPU the tool exits 1; an unknown path is a usage
    error."""
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as e:
        api_cost.main(["--paths", "rcas_only"])
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        api_cost.main(["--paths", "no_such_path"])
    assert e.value.code == 2


def test_frame_is_the_packed_zone_and_noise_pair():
    """frame(h, w, device): the (2, h, w) int32 packed stereo pair of zone
    plate and noise, alpha from a generator seeded 0 (chip_smoke.py's
    zone+noise set)."""
    h, w = 9, 13
    x = api_cost.frame(h, w, "cpu")
    assert x.shape == (2, h, w) and x.dtype == torch.int32
    u8 = x.numpy().view(np.uint8).reshape(2, h, w, 4)
    np.testing.assert_array_equal(u8[0, ..., :3],
                                  FR.zone_plate_frame(h, w)[..., :3])
    np.testing.assert_array_equal(u8[1, ..., :3],
                                  FR.noise_frame(h, w, seed=1)[..., :3])
    np.testing.assert_array_equal(u8[..., 3], np.random.default_rng(
        0).integers(0, 256, (2, h, w), dtype=np.uint8))


def test_api_cost_is_a_bench_paths_view():
    """The tool measures the bench paths, at their configs."""
    assert set(api_cost.PATHS) == {"fsr_fused", "fsr_supersample",
                                   "rcas_only", "nvscaler", "nvsharpen",
                                   "cas_upscale", "cas_sharpen"}
    assert (api_cost.ROUNDS, api_cost.CALLS) == (5, 40)
