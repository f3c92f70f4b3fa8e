"""Build and load the port's CUDA kernels.

Each kernel source csrc/<name>.cu is compiled by `nvcc` into a shared
library of its own with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ctypes. `build()` starts one nvcc per source,
all at once, so the kernels build in parallel. The libraries land in the
package's `_build/` directory (listed in .gitignore) under names keyed by a
hash of the flags, the source and the csrc headers it includes (#include
"...", transitively): an edit to a header renames only the libraries whose
source reaches it. A file lock makes concurrent processes build each once.
`entry_point` binds a library's C launch entry point with the argtypes of
its prototype in the source (`argtypes`), the one place that does. The
flags are the numerics contract: --fmad=false keeps every mul and add
rounded on its own, as in the plain torch ops, and --use_fast_math is never
passed (IEEE division and square root, no flush to zero).
"""

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from ..utils import trace

__all__ = ["build", "load_library", "library_path", "kernel_names",
           "includes", "prototype", "argtypes", "entry_point", "NVCC_FLAGS",
           "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_LIBS = {}     # the load cache: library path -> loaded ctypes library
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)
# a C parameter type -> its ctypes type; any pointer binds as c_void_p
C_TYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
           "unsigned int": ctypes.c_uint, "float": ctypes.c_float}


def kernel_names():
    """The kernel sources: the stem of every csrc/*.cu."""
    return [f.stem for f in sorted(CSRC.glob("*.cu"))]


def includes(source):
    """The csrc headers the file `source` reaches through #include "...",
    directly or through another header, sorted by name; angle-bracket
    includes do not count."""
    seen, todo = set(), [Path(source)]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            header = CSRC / name
            if header not in seen:
                seen.add(header)
                todo.append(header)
    return sorted(seen)


def library_path(name):
    """Where the library of kernel `name` for the current flags, source and
    the headers it includes lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    source = CSRC / f"{name}.cu"
    for f in [source, *includes(source)]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def prototype(entry, text):
    """[(type, name)] of the parameters of `extern "C" int <entry>(...)` in
    the C source `text`, each type with its spaces normalised and its stars
    bound to it ("const void*", "int"). Raises ValueError, naming the
    entry, where the source has no such prototype or a parameter has no
    name."""
    m = re.search(rf'extern\s+"C"\s+int\s+{re.escape(entry)}\s*\(([^)]*)\)',
                  text)
    if m is None:
        raise ValueError(f'no extern "C" int {entry}(...) in the source')
    params = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        t = re.fullmatch(r"(.*?[ *])(\w+)", p)
        if t is None:
            raise ValueError(f"{entry}: parameter {p!r} has no name")
        params.append((" ".join(t.group(1).replace("*", " * ").split())
                       .replace(" *", "*"), t.group(2)))
    return params


def argtypes(entry, text):
    """The ctypes types of <entry>'s parameters in the C source `text`
    (prototype): a pointer c_void_p, int c_int, unsigned c_uint, float
    c_float. Any other type raises ValueError naming the entry."""
    types = []
    for t, name in prototype(entry, text):
        c = ctypes.c_void_p if t.endswith("*") else C_TYPES.get(t)
        if c is None:
            raise ValueError(f"{entry}: no ctypes type for parameter "
                             f"{name}'s type {t!r}")
        types.append(c)
    return types


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


@functools.cache
def entry_point(library, entry):
    """The C entry point `entry` (an `extern "C" int` function) of kernel
    library `library`, loaded (and built) through load_library and bound
    once: restype c_int, argtypes from its prototype in csrc/<library>.cu
    (argtypes)."""
    f = getattr(load_library(library), entry)
    f.argtypes = argtypes(entry, (CSRC / f"{library}.cu").read_text())
    f.restype = ctypes.c_int
    return f
