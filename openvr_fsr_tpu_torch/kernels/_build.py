"""Build and load the port's CUDA kernels.

`nvcc` compiles csrc/*.cu into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), loaded with ctypes. The
library lands in the package's `_build/` directory (listed in .gitignore)
under a name keyed by a hash of the sources and flags; a file lock makes
concurrent processes build it once. The flags are the numerics contract:
--fmad=false keeps every mul and add rounded on its own, as in the plain
torch ops, and --use_fast_math is never passed (IEEE division, no flush to
zero).
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "library_path", "NVCC_FLAGS", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS = {}     # the build cache: library path -> loaded ctypes library


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sum(_sources(), []):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libfsr_kernels_{h.hexdigest()[:16]}.so"


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


def load_library():
    """The loaded kernel library, building it first if needed. The nvcc
    command and its output (ptxas register and shared-memory use) are kept
    beside the library in a .log file. Raises on any build failure."""
    so = library_path()
    lib = _LIBS.get(so)
    if lib is not None:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            cu, _ = _sources()
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
            so.with_suffix(".log").write_text(
                " ".join(cmd) + "\n" + r.stdout + r.stderr)
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc exited {r.returncode}:\n{r.stdout}{r.stderr}")
            os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LIBS[so] = lib
    return lib
