"""What a built kernel library's SASS shows: instruction counts per
function and per loop, read with `cuobjdump -sass` (beside nvcc); and what
ptxas reported for each kernel when it was built (ptxas_usage).

chip_smoke.py checks with it that each kernel kept its work (the DMA
floor its loads and stores, each rate probe the instructions it meters),
and tools/vpu_audit.py takes the FP32 instructions of one vpu_cycle from
it. A loop is the span from a backward branch's target to the branch; the
innermost loop holding a given opcode is the one with the shortest span.
"""

import collections
import re
import subprocess
from pathlib import Path

__all__ = ["disassemble", "function_counts", "loops", "innermost_loop",
           "probe_loops", "ptxas_usage"]

_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\s+0x([0-9a-f]+)")
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_usage(log):
    """{kernel function: {"registers", "spill_stores", "spill_loads",
    "smem"}} from the `nvcc -Xptxas -v` output of one build (the .log
    beside each library of kernels/_build.py)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            fn = m.group(1)
            out[fn] = {"registers": None, "spill_stores": 0,
                       "spill_loads": 0, "smem": 0}
            continue
        if fn is None:
            continue
        if (m := _SPILL.search(line)):
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        if (m := _USED.search(line)):
            out[fn]["registers"] = int(m.group(1))
            sm = _SMEM.search(line)
            out[fn]["smem"] = int(sm.group(1)) if sm else 0
    return out


def disassemble(lib, nvcc):
    """The SASS text of a built library, or None where cuobjdump is not
    beside nvcc."""
    tool = Path(nvcc).with_name("cuobjdump")
    if not tool.exists():
        return None
    r = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump exited {r.returncode}: "
                           f"{r.stderr.strip()}")
    return r.stdout


def _opcode(text):
    """The opcode of an instruction without its predicate and modifiers:
    '@!P0 BRA 0x5e0' -> 'BRA', 'LDS.U.128 R4, [R2]' -> 'LDS'."""
    text = re.sub(r"^@!?U?P\w+\s+", "", text)
    return text.split()[0].split(".")[0]


def _functions(sass):
    """{function name: [(address, instruction text), ...]}."""
    funcs, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            funcs[fn] = []
            continue
        m = _INSN.match(line)
        if fn is not None and m:
            funcs[fn].append((int(m.group(1), 16), m.group(2)))
    return funcs


def function_counts(sass):
    """{function name: Counter of opcodes} over the whole function."""
    return {fn: collections.Counter(_opcode(t) for _, t in ins)
            for fn, ins in _functions(sass).items()}


def loops(sass):
    """{function name: [(span, first address, branch address, Counter of
    opcodes in the loop), ...]} for every backward branch, shortest first."""
    out = {}
    for fn, ins in _functions(sass).items():
        found = []
        for addr, text in ins:
            m = _BRANCH.search(text)
            if m and int(m.group(1), 16) < addr:
                first = int(m.group(1), 16)
                ops = collections.Counter(_opcode(t) for a, t in ins
                                          if first <= a <= addr)
                found.append((addr - first, first, addr, ops))
        out[fn] = sorted(found, key=lambda x: x[0])
    return out


def innermost_loop(sass, function_part, *opcodes):
    """The opcode Counter of the shortest loop of the function whose name
    holds `function_part` that holds every one of `opcodes`, or None."""
    for fn, found in loops(sass).items():
        if function_part not in fn:
            continue
        for _, _, _, ops in found:
            if all(ops[o] for o in opcodes):
                return ops
    return None


def probe_loops(nvcc=None):
    """What each rate probe's SASS keeps in its metering loop, or None
    without cuobjdump (the probes are built first where they are not):
      vpu_rate   FP32 instructions (FADD + FMUL + FMNMX) per vpu_cycle;
      vmem_rate  LDS in the Horner loop, and plane words per LDS (FMUL /
                 LDS: 4 for 128-bit loads, above 4 a load was dropped);
      mxu_rate   HMMA and LDSM per round of one warp.
    Each is the innermost loop holding the instructions it meters."""
    from ..kernels import _build

    names = ("vpu_rate", "vmem_rate", "mxu_rate")
    _build.build(names)
    nvcc = nvcc or _build._nvcc()
    texts = {}
    for name in names:
        texts[name] = disassemble(_build.library_path(name), nvcc)
        if texts[name] is None:
            return None
    vpu = innermost_loop(texts["vpu_rate"], "vpu_rate_kernel", "FMNMX")
    vmem = innermost_loop(texts["vmem_rate"], "vmem_rate_kernel", "LDS",
                          "FMUL")
    mxu = innermost_loop(texts["mxu_rate"], "mxu_rate_kernel", "HMMA")
    return {
        "vpu_rate": {"fp32_per_cycle": (vpu["FADD"] + vpu["FMUL"]
                                        + vpu["FMNMX"]) if vpu else 0},
        "vmem_rate": {"lds_in_loop": vmem["LDS"] if vmem else 0,
                      "words_per_lds": (vmem["FMUL"] / vmem["LDS"])
                      if vmem and vmem["LDS"] else None},
        "mxu_rate": {"hmma_per_round": mxu["HMMA"] if mxu else 0,
                     "ldsm_per_round": mxu["LDSM"] if mxu else 0},
    }
