"""The port's full-size parity tool (openvr_fsr_tpu_torch/tools/parity.py) on
the CPU: its cases against the root tools/parity.py's eleven plus the
fourteen the TPU record lacks (six of them the 10-bit path's), its cache key and oracle fingerprint, a --device cpu
--small run (every case, 0 unequal values), the oracle's process pool and
cache, and its refusals. The tool itself judges the card: `python3 -m
openvr_fsr_tpu_torch.tools.parity` (and chip_smoke.py runs two cases).
"""

import ast
import hashlib
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openvr_fsr_tpu_torch.tools import parity as P  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ROOT_FRAMES = {"frames['zone_plate']": "zone_plate",
               "frames['noise']": "noise",
               "big['zone_plate']": "big_zone_plate"}
NEW = {
    "nvscaler_zone_r0.5_hdr1": ("zone_plate", dict(
        render_scale=0.75, sharpness=0.7, radius=0.5, use_nis=True,
        hdr_mode=1)),
    "nvscaler_zone_r0.5_hdr2": ("zone_plate", dict(
        render_scale=0.75, sharpness=0.7, radius=0.5, use_nis=True,
        hdr_mode=2)),
    "nvsharpen_zone_hdr1": ("big_zone_plate", dict(
        render_scale=1.0, sharpness=0.7, radius=2.0, use_nis=True,
        hdr_mode=1)),
    "nvsharpen_zone_hdr2": ("big_zone_plate", dict(
        render_scale=1.0, sharpness=0.7, radius=2.0, use_nis=True,
        hdr_mode=2)),
    "fsr_fused_zone_r0.0_debug": ("zone_plate", dict(
        render_scale=0.75, sharpness=0.9, radius=0.0, debug=True)),
    "cas_sharpen_zone_mcd0.05": ("big_zone_plate", dict(
        render_scale=1.0, sharpness=0.8, radius=2.0, use_cas=True,
        cas_max_color_delta=0.05)),
    "fsr_fused_noise_r0.3_eye1_offcentre": ("noise", dict(
        render_scale=0.75, sharpness=0.9, radius=0.3, eye=1,
        eye_centers=((0.45, 0.5), (0.55, 0.52)))),
    "fsr_fused_zone_doublewide": ("double_wide", dict(
        render_scale=0.75, sharpness=0.9, radius=0.5, single_eye=False)),
    "fsr_fused_noise10_r0.5": ("noise10", dict(
        render_scale=0.75, sharpness=0.9, radius=0.5, color_bits=10)),
    "rcas_only_zone10_r0.5_debug": ("big_zone_plate10", dict(
        render_scale=1.0, sharpness=0.9, radius=0.5, debug=True,
        color_bits=10)),
    "nvscaler_noise10_r0.5": ("noise10", dict(
        render_scale=0.75, sharpness=0.7, radius=0.5, use_nis=True,
        color_bits=10)),
    "nvsharpen_zone10_r0.5": ("big_zone_plate10", dict(
        render_scale=1.0, sharpness=0.7, radius=0.5, use_nis=True,
        color_bits=10)),
    "cas_upscale_noise10_r0.5": ("noise10", dict(
        render_scale=0.75, sharpness=0.8, radius=0.5, use_cas=True,
        color_bits=10)),
    "cas_sharpen_zone10_r0.5": ("big_zone_plate10", dict(
        render_scale=1.0, sharpness=0.8, radius=0.5, use_cas=True,
        color_bits=10)),
}


def _root_tool():
    """tools/parity.py imports only numpy and the standard library at
    module level."""
    spec = importlib.util.spec_from_file_location(
        "root_parity", REPO / "tools" / "parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _root_cases():
    """(name, frame, kwargs) of every case the root tool's main() lists."""
    tree = ast.parse((REPO / "tools" / "parity.py").read_text())
    cases = []
    for node in ast.walk(tree):
        target = (node.targets[0] if isinstance(node, ast.Assign)
                  else node.target if isinstance(node, ast.AugAssign)
                  else None)
        if not (isinstance(target, ast.Name) and target.id == "cases"
                and isinstance(node.value, ast.List)):
            continue
        for t in node.value.elts:
            name, frame, kw = t.elts
            cases.append((name.value, ROOT_FRAMES[ast.unparse(frame)],
                          {k.arg: ast.literal_eval(k.value)
                           for k in kw.keywords}))
    return cases


def test_the_root_cases_come_first():
    root = _root_cases()
    assert len(root) == 11
    assert P.CASES[:11] == root


def test_the_cases_the_tpu_record_lacks():
    assert {n: (f, kw) for n, f, kw in P.CASES[11:]} == NEW
    assert len(P.CASES) == 25
    assert P.TEN_BIT == tuple(n for n in NEW if "10_" in n)
    assert len(P.TEN_BIT) == 6
    tpu = json.loads((REPO / "PARITY_r05.json").read_text())["results"]
    assert set(tpu) == {n for n, _, _ in P.CASES[:11]}
    assert set(P.ZERO) == {n for n, r in tpu.items()
                           if r["mismatch_gt0"] == 0}


def test_select():
    assert P.select() == P.CASES
    assert [n for n, _, _ in P.select(skip_nis=True)] == [
        n for n, _, kw in P.CASES if not kw.get("use_nis")]
    assert len(P.select(skip_nis=True)) == 16
    assert [n for n, _, _ in P.select(names=("nvscaler_noise",
                                             "fsr_fused_zone_r0.5"))] == [
        "fsr_fused_zone_r0.5", "nvscaler_noise"]
    with pytest.raises(ValueError, match="unknown"):
        P.select(names=("nope",))


def test_case_key_is_the_root_tools():
    root = _root_tool()
    inputs = P.frames(small=True)
    for fp in ("0" * 40, P._oracle_fingerprint()):
        for name, f, kw in P.CASES:
            assert P._case_key(name, inputs[f], kw, fp) == \
                root._case_key(name, inputs[f], kw, fp)


def test_fingerprint_covers_the_port_oracle_and_its_imports(tmp_path,
                                                            monkeypatch):
    pkg = REPO / "openvr_fsr_tpu_torch"
    deps = sorted([*(pkg / "oracle").glob("*.py")]
                  + [pkg / "core" / f for f in ("constants.py",
                                                "nis_tables.py",
                                                "foveation.py")]
                  + [pkg / "utils" / "frames.py"])
    h = hashlib.sha1()
    for p in sorted(str(d) for d in deps):
        h.update(Path(p).read_bytes())
    assert P._oracle_fingerprint() == h.hexdigest()
    # an edit to any of them changes it
    for sub in ("oracle", "core", "utils"):
        shutil.copytree(pkg / sub, tmp_path / sub)
    monkeypatch.setattr(P, "PKG", str(tmp_path))
    before = P._oracle_fingerprint()
    for rel in ("oracle/easu.py", "core/nis_tables.py", "utils/frames.py"):
        with open(tmp_path / rel, "a") as f:
            f.write("\n")
        after = P._oracle_fingerprint()
        assert after != before, rel
        before = after


def test_frames():
    small = P.frames(small=True)
    assert small["zone_plate"].shape == (40, 48, 4)
    assert small["big_zone_plate"].shape == (53, 64, 4)
    assert small["double_wide"].shape == (40, 96, 4)
    assert np.array_equal(small["double_wide"][:, 48:], small["zone_plate"])
    assert small["noise10"].shape == small["zone_plate10"].shape == \
        (40, 48, 4)
    assert small["big_zone_plate10"].shape == (53, 64, 4)
    for name in ("noise10", "zone_plate10", "big_zone_plate10"):
        assert small[name].dtype == np.uint16
        assert small[name][..., :3].max() <= 1023
    assert set(np.unique(small["noise10"][..., 3])) == {0, 1, 2, 3}
    assert (small["zone_plate10"][..., 3] == 3).all()
    assert small["zone_plate10"][..., 0].max() > 1000
    assert P.FULL == (1869, 1683)
    assert (int(1869 / 0.75), int(1683 / 0.75)) == (2492, 2244)


def test_small_cpu_run(tmp_path, capsys):
    """Every case through the plain versions against the oracle at 48x40:
    the record's fields, 0 unequal values everywhere."""
    out = tmp_path / "parity.json"
    record = P.main(["--device", "cpu", "--small", "--out", str(out)])
    assert json.loads(out.read_text()) == record
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == record
    assert record["hardware"].startswith("cpu")
    assert list(record["results"]) == [n for n, _, _ in P.CASES]
    assert record["all_max_lsb"] == 0 and record["misses"] == []
    for name, r in record["results"].items():
        assert set(r) == {"pixels", "mismatch_gt0", "mismatch_gt1", "max_lsb",
                          "launches"}
        assert r["mismatch_gt0"] == r["mismatch_gt1"] == r["max_lsb"] == 0
        assert r["launches"] == 0                   # no CUDA kernel on a CPU
    assert record["results"]["fsr_fused_zone_r0.5"]["pixels"] == 53 * 64 * 4
    assert record["results"]["fsr_fused_zone_doublewide"]["pixels"] == \
        53 * 128 * 4
    assert record["results"]["fsr_supersample_zone"]["pixels"] == \
        int(53 * 1.3) * int(64 * 1.3) * 4


def test_oracle_pool_and_cache(tmp_path, monkeypatch):
    """Two missing cases computed in two spawned processes, equal to the
    in-process oracle, then read back from the cache."""
    cache = tmp_path / "cache.npz"
    inputs = P.frames(small=True)
    cases = P.select(names=("fsr_fused_zone_r0.5", "nvsharpen_zone_hdr2"))
    got = P.oracle_outputs(cases, inputs, str(cache), jobs=2)
    for name, f, kw in cases:
        assert np.array_equal(got[name], P.oracle_case(inputs[f], kw))
    with np.load(cache) as saved:
        assert len(saved.files) == 2
    monkeypatch.setattr(P, "oracle_case", None)     # a cache miss would fail
    again = P.oracle_outputs(cases, inputs, str(cache), jobs=2)
    for name in got:
        assert np.array_equal(again[name], got[name])


@pytest.mark.parametrize("r,name,ok", [
    (dict(max_lsb=0, mismatch_gt0=0), "fsr_fused_zone_r0.5", True),
    (dict(max_lsb=1, mismatch_gt0=3), "fsr_fused_zone_r0.5", False),
    (dict(max_lsb=1, mismatch_gt0=33), "nvscaler_noise", True),
    (dict(max_lsb=2, mismatch_gt0=1), "nvscaler_noise", False),
    (dict(max_lsb=0, mismatch_gt0=0), "nvscaler_noise10_r0.5", True),
    (dict(max_lsb=1, mismatch_gt0=1), "nvscaler_noise10_r0.5", False)])
def test_the_bar(r, name, ok):
    assert P.meets_bar(name, r) is ok


def test_compare_counts():
    want = np.zeros((2, 3, 4), np.uint8)
    got = want.copy()
    got[0, 0, 0], got[1, 2, 3] = 1, 3
    assert P.compare(got, want) == {"pixels": 24, "mismatch_gt0": 2,
                                    "mismatch_gt1": 1, "max_lsb": 3}
    with pytest.raises(ValueError):
        P.compare(got[:1], want)


def test_refusals(capsys):
    with pytest.raises(SystemExit):
        P.main(["--small"])                 # the card never runs small
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            P.main(["--skip-nis"])
        assert e.value.code == 1
        assert "no CUDA GPU" in capsys.readouterr().out
