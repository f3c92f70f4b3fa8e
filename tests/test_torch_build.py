"""The names of the kernel libraries (kernels/_build.py::library_path), on
copies of csrc/: a library's name hashes the nvcc flags, its source and
the csrc headers that source includes, directly or through another header,
so an edit to a header renames only the libraries that reach it.

Nothing here runs nvcc: the names are computed from the sources alone.
"""

import shutil

import pytest

from openvr_fsr_tpu_torch.kernels import _build

CLASS = {"fsr_fused", "rcas_sharpen", "nis_scaler", "nis_sharpen",
         "cas_upscale", "cas_sharpen"}
PROBES = {"vpu_rate", "vmem_rate", "mxu_rate"}
# header -> the libraries whose source reaches it (read off the #include
# lines by hand: codec.cuh includes rgba8.cuh and ffx_math.cuh, every class
# source includes codec.cuh, the bilinear and copy passes include codec.cuh)
READERS = {
    "rgba8.cuh": CLASS,
    "codec.cuh": CLASS,
    "ffx_math.cuh": CLASS,
    "bilinear_pass.cuh": {"fsr_fused", "nis_scaler", "cas_upscale",
                          "rcas_sharpen"},
    "copy_pass.cuh": {"nis_sharpen", "cas_sharpen", "rcas_sharpen"},
    "cas_math.cuh": {"cas_upscale", "cas_sharpen"},
    "nis_math.cuh": {"nis_scaler", "nis_sharpen"},
    "nis_coef.cuh": {"nis_scaler"},
    "rates.cuh": PROBES,
}


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that library_path reads in its place."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _names():
    return {k: _build.library_path(k).name for k in _build.kernel_names()}


def test_every_header_is_read_by_someone():
    assert sorted(READERS) == sorted(f.name for f in _build.CSRC.glob("*.cuh"))
    assert set(_build.kernel_names()) == CLASS | PROBES | {"dma_floor"}


@pytest.mark.parametrize("header", sorted(READERS))
def test_header_edit_renames_its_readers_only(header, csrc):
    """An edit to a header renames exactly the libraries whose source
    includes it, directly (nis_coef.cuh) or through another header
    (rgba8.cuh through codec.cuh); every other name stays."""
    before = _names()
    assert _names() == before                       # the same sources
    with open(csrc / header, "a") as f:
        f.write("\n// an edit\n")
    after = _names()
    renamed = {k for k in before if after[k] != before[k]}
    assert renamed == READERS[header]
    assert all(_build.CSRC / header in _build.includes(csrc / f"{k}.cu")
               for k in renamed)


def test_new_header_renames_its_includers_only(csrc):
    """A new header included by two sources (say, a level form shared by
    B1 and B2) renames those two when it is added and when it is edited,
    and no other library."""
    base = _names()
    (csrc / "levels.cuh").write_text("#pragma once\n#include <cstdint>\n")
    assert _names() == base                 # no source includes it yet
    for k in ("fsr_fused", "rcas_sharpen"):
        src = csrc / f"{k}.cu"
        src.write_text(src.read_text().replace(
            '#include "codec.cuh"',
            '#include "codec.cuh"\n#include "levels.cuh"'))
    added = _names()
    (csrc / "levels.cuh").write_text("#pragma once\n// edited\n")
    edited = _names()
    for names in (added, edited):
        assert {k for k in base if names[k] != base[k]} == {"fsr_fused",
                                                            "rcas_sharpen"}
    assert {k for k in base if edited[k] != added[k]} == {"fsr_fused",
                                                          "rcas_sharpen"}
    # an angle-bracket include is not a csrc header
    assert [h.name for h in _build.includes(csrc / "levels.cuh")] == []


def test_flags_rename_every_library(csrc, monkeypatch):
    """The nvcc flags are the numerics contract: a change to them renames
    every library."""
    before = _names()
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        (*_build.NVCC_FLAGS, "-lineinfo"))
    after = _names()
    assert all(after[k] != before[k] for k in before)


def test_source_edit_renames_its_library_only(csrc):
    before = _names()
    with open(csrc / "dma_floor.cu", "a") as f:
        f.write("\n// an edit\n")
    after = _names()
    assert {k for k in before if after[k] != before[k]} == {"dma_floor"}
