"""What a built kernel library's SASS shows: instruction counts per
function and per loop, read with `cuobjdump -sass` (beside nvcc); and what
ptxas reported for each kernel when it was built (ptxas_usage).

chip_smoke.py checks with it that each kernel kept its work (the DMA
floor its TMA loads and its stores, each rate probe the instructions it
meters: the tensor-core probe its HGMMA),
and tools/vpu_audit.py takes the FP32 instructions of one vpu_cycle from
it; inside_float_per_output reads the float instructions of one output of
each compute kernel's inside kernel, to hold beside the op meter's count.
A loop is the span from a backward branch's target to the branch; the
innermost loop holding a given opcode is the one with the shortest span.
"""

import collections
import re
import subprocess
from pathlib import Path

__all__ = ["disassemble", "function_counts", "loops", "innermost_loop",
           "probe_loops", "probe_loop_counts", "ptxas_usage",
           "inside_float_per_output", "INSIDE_RULES"]

_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\s+0x([0-9a-f]+)")
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")

FLOAT_ARITH = ("FADD", "FMUL", "FFMA")
FLOAT_CMP = ("FMNMX", "FSETP", "FSEL")
OUTPUTS_PER_THREAD = 4         # every inside kernel's outputs per thread
FSR_POSITIONS_PER_OUTPUT = (34 / 32) ** 2   # B1's haloed stage-1 tile
# kernel -> (a part of its inside kernel's name, how one inside output's
# float instructions are read from it: inside_float_per_output)
INSIDE_RULES = {
    "fsr_fused": ("fsr_inside_kernel", "fsr"),
    "rcas_sharpen": ("rcas_sharpen_inside_kernel", "tile"),
    "nis_scaler": ("nis_inside_kernel", "run"),
    "nis_sharpen": ("nis_sharpen_inside_kernel", "tile"),
    "cas_upscale": ("cas_inside_kernel", "tile"),
    "cas_sharpen": ("cas_sharpen_inside_kernel", "tile"),
}


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
    """What each rate probe's SASS keeps in its metering loop
    (probe_loop_counts), or None without cuobjdump (the probes are built
    first where they are not)."""
    from ..kernels import _build

    names = ("vpu_rate", "vmem_rate", "mxu_rate")
    _build.build(names)
    nvcc = nvcc or _build._nvcc()
    texts = {}
    for name in names:
        texts[name] = disassemble(_build.library_path(name), nvcc)
        if texts[name] is None:
            return None
    return probe_loop_counts(texts)


def probe_loop_counts(texts):
    """From the SASS texts {probe name: text} of the three rate probes:
      vpu_rate   FP32 instructions (FADD + FMUL + FMNMX) per vpu_cycle;
      vmem_rate  LDS in the Horner loop, and plane words per LDS (FMUL /
                 LDS: 4 for 128-bit loads, above 4 a load was dropped);
      mxu_rate   HGMMA per round of one warpgroup (wgmma m64n128k16: 8 per
                 (64, 128) @ (128, 128) round).
    Each is the innermost loop holding the instructions it meters."""
    vpu = innermost_loop(texts["vpu_rate"], "vpu_rate_kernel", "FMNMX")
    vmem = innermost_loop(texts["vmem_rate"], "vmem_rate_kernel", "LDS",
                          "FMUL")
    mxu = innermost_loop(texts["mxu_rate"], "mxu_rate_kernel", "HGMMA")
    return {
        "vpu_rate": {"fp32_per_cycle": (vpu["FADD"] + vpu["FMUL"]
                                        + vpu["FMNMX"]) if vpu else 0},
        "vmem_rate": {"lds_in_loop": vmem["LDS"] if vmem else 0,
                      "words_per_lds": (vmem["FMUL"] / vmem["LDS"])
                      if vmem and vmem["LDS"] else None},
        "mxu_rate": {"hgmma_per_round": mxu["HGMMA"] if mxu else 0},
    }


def _floats(ops):
    """(arithmetic, compare-select) float instruction counts of a Counter."""
    return (sum(ops[o] for o in FLOAT_ARITH), sum(ops[o] for o in FLOAT_CMP))


def _outermost(found):
    """The loops of `found` that no other loop of it contains."""
    return [lp for lp in found
            if not any(o is not lp and o[1] <= lp[1] and lp[2] <= o[2]
                       for o in found)]


def inside_float_per_output(text, kernel, in_per_out=1.0):
    """(arithmetic, compare-select): the float instructions (FLOAT_ARITH,
    FLOAT_CMP) of one output inside the foveation circle, read from the
    SASS text of `kernel`'s library, or None where its inside kernel or a
    loop the rule needs is missing. Static: each instruction of a region
    counts once and every branch of it counts (a path that seldom runs, as
    IEEE division's slow one, too); the output's pack counts, the window's
    staging does not. By INSIDE_RULES:
      tile  the function less its staging loops (each outermost loop that
            stores to shared memory) over OUTPUTS_PER_THREAD: B2, B4, B5,
            B6, whose runs of 4 outputs per thread are unrolled;
      fsr   B1: its stage-1 loop (the innermost loop holding MUFU and STS:
            one EASU or bilinear position) x FSR_POSITIONS_PER_OUTPUT, plus
            its persistent tile loop (the longest) less the loops in it
            that store to shared memory, over OUTPUTS_PER_THREAD (RCAS);
      run   B3: its run loop (the longest: one output per trip, the reload
            and the one-row step both counted) plus each staging loop's
            body once per input pixel (in_per_out: the luma and the edge
            map are made per input pixel)."""
    part, rule = INSIDE_RULES[kernel]
    counts = function_counts(text)
    found = loops(text)
    names = [fn for fn in counts if part in fn]
    if not names:
        return None
    fn = names[0]
    whole, its = counts[fn], found[fn]
    staging = _outermost([lp for lp in its if lp[3]["STS"]])
    if rule == "tile":
        arith, cmp = _floats(whole)
        for lp in staging:
            a, c = _floats(lp[3])
            arith, cmp = arith - a, cmp - c
        return arith / OUTPUTS_PER_THREAD, cmp / OUTPUTS_PER_THREAD
    if not its:
        return None
    longest = its[-1]
    if rule == "run":
        arith, cmp = _floats(longest[3])
        for lp in staging:
            if lp is not longest:
                a, c = _floats(lp[3])
                arith, cmp = arith + a * in_per_out, cmp + c * in_per_out
        return arith, cmp
    stage1 = next((lp for lp in its if lp[3]["MUFU"] and lp[3]["STS"]
                   and lp is not longest), None)
    if stage1 is None:
        return None
    arith, cmp = _floats(longest[3])
    for lp in _outermost([lp for lp in its if lp[3]["STS"]
                          and lp is not longest
                          and longest[1] <= lp[1] and lp[2] <= longest[2]]):
        a, c = _floats(lp[3])
        arith, cmp = arith - a, cmp - c
    a, c = _floats(stage1[3])
    return (a * FSR_POSITIONS_PER_OUTPUT + arith / OUTPUTS_PER_THREAD,
            c * FSR_POSITIONS_PER_OUTPUT + cmp / OUTPUTS_PER_THREAD)
