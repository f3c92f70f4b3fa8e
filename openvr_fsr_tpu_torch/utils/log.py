"""Logging — the reference writes a single `openvr_mod.log` next to the DLL
(src/postprocess/Config.cpp:25-32) recording init decisions, per-interface
requests and GPU-time averages. Same event set here via `logging`."""

import logging
import sys

_LOGGER = None


def get_logger(path=None):
    """Module-wide logger; pass `path` once to also log to a file
    (openvr_mod.log analog)."""
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("openvr_fsr_tpu_torch")
        logger.setLevel(logging.INFO)
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter("[openvr_fsr_tpu_torch] %(message)s"))
            logger.addHandler(h)
        _LOGGER = logger
    if path is not None:
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        _LOGGER.addHandler(fh)
    return _LOGGER
