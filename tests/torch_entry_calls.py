"""The `entry_calls` fixture: drives the port's kernel launches without a card.

Every C entry point the kernel wrappers bind
(`openvr_fsr_tpu_torch/kernels/_build.py::entry_point`) becomes a stub that
records `(library, entry, args)` and returns 0, and the current CUDA stream is
0. A test module takes the fixture with
`from torch_entry_calls import entry_calls  # noqa: F401`.
"""

import pytest
import torch

from openvr_fsr_tpu_torch.kernels import _build


@pytest.fixture
def entry_calls(monkeypatch):
    """Returns the list of recorded `(library, entry, args)` calls."""
    calls = []

    def entry_point(library, entry):
        def call(*args):
            calls.append((library, entry, args))
            return 0
        return call
    monkeypatch.setattr(_build, "entry_point", entry_point)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "S", (), {"cuda_stream": 0})())
    return calls
