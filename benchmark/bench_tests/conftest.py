"""CPU tests of the benchmark (run from the repository root:
`python -m pytest benchmark/bench_tests -q`). Cases that need the card carry
the `card` marker and skip without one; the `card` fixture decides, never
an import."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (the benchmark's own runs)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU: the cell runs on the card only")
    return torch.device("cuda", 0)


@pytest.fixture
def spec():
    from fsrbench.spec import Spec
    return Spec(ROOT, BENCH_DIR)


SMALL = {"eye_in_wh": [63, 54], "eye_out_wh": [84, 72]}


STREAM = "fsr_rs075_stream90"   # the stream mix, not a cell (PERF.md §7)


@pytest.fixture
def small_cell(spec):
    """A cell of BENCHMARK.json (or the stream: the FSR deployment under
    traffic/stream_rings_90.json) at 2 x 63x54 -> 2 x 84x72, the CPU's
    size, with its configuration's limits."""
    from fsrbench.spec import Cell

    def make(name):
        if name == STREAM:
            cell = Cell(name, spec.config("fsr_rs075_2244x2492"),
                        spec.traffic("stream_rings_90"), 1, [], [])
        else:
            cell = spec.cell(name)
        cell.config = dict(cell.config, **SMALL)
        return cell
    return make
