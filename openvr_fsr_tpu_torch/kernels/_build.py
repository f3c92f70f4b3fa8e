"""Build and load the port's CUDA kernels.

Each kernel source csrc/<name>.cu is compiled by `nvcc` into a shared
library of its own with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ctypes. `build()` starts one nvcc per source,
all at once, so the kernels build in parallel. The libraries land in the
package's `_build/` directory (listed in .gitignore) under names keyed by a
hash of the source, the shared headers (csrc/*.cuh) and the flags; a file
lock makes concurrent processes build each once. The flags are the
numerics contract: --fmad=false keeps every mul and add rounded on its own,
as in the plain torch ops, and --use_fast_math is never passed (IEEE
division and square root, no flush to zero).
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils import trace

__all__ = ["build", "load_library", "library_path", "kernel_names",
           "NVCC_FLAGS", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_LIBS = {}     # the load cache: library path -> loaded ctypes library


def kernel_names():
    """The kernel sources: the stem of every csrc/*.cu."""
    return [f.stem for f in sorted(CSRC.glob("*.cu"))]


def library_path(name):
    """Where the library of kernel `name` for the current sources and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def build(names=None):
    """Build the libraries of `names` (default: every kernel) that do not
    exist yet, one nvcc per source, all started together. Each nvcc command
    and its output (ptxas register and shared-memory use) is kept beside its
    library in a .log file. Returns the names built (empty when every
    library existed). Raises, naming every failed source, after all have
    ended."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [(n, library_path(n)) for n in names]
        todo = [(n, so) for n, so in todo if not so.exists()]
        if not todo:
            return []
        nvcc = _nvcc()
        jobs = []
        for name, so in todo:
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs.append((name, so, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, so, tmp, cmd, proc in jobs:
            try:
                out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                out += f"\nnvcc killed after {NVCC_TIMEOUT_S} s"
            so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{name}.cu: nvcc exited {proc.returncode}:\n"
                              f"{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        return [name for name, _ in todo]


def load_library(name):
    """The loaded library of kernel `name`, building it first if needed: a
    cold `library` span (utils/trace.py) whose info's `built` says whether
    nvcc ran. Raises on any build failure."""
    so = library_path(name)
    lib = _LIBS.get(so)
    if lib is None:
        with trace.span("library", cold=True) as sp:
            sp.info["built"] = bool(build([name]))
            lib = _LIBS[so] = ctypes.CDLL(str(so))
    return lib
