"""launch_ms.paced: the mean, over the paced window's calls, of the
program's `launch` spans nested in each `process` span
(openvr_fsr_tpu_torch/utils/trace.py): the output's allocation, the
tables' lookup and the C entry point with its cudaLaunchKernel of both
class kernels, made from an idle card. None where no call launched (the
CPU's plain path)."""

SPANS = {"calls": "process", "launches": "launch", "builds": "build"}


def _records():
    """The program's span records (openvr_fsr_tpu_torch.utils.trace), or
    None: a program without them, none recorded, any dropped or left open,
    or a counter that disagrees with the count of its spans."""
    try:
        from openvr_fsr_tpu_torch.utils import trace
    except ImportError:
        return None
    recs, counts = trace.records(), trace.counters()
    if not recs or counts.get("dropped") or \
            any(r.end_ns is None for r in recs):
        return None
    for counter, name in SPANS.items():
        if counts.get(counter) != sum(r.name == name for r in recs):
            return None
    return recs


def read(ctx):
    recs = _records()
    calls = {i for i, r in enumerate(recs or ()) if r.name == "process"}
    launches = [r for r in recs or () if r.name == "launch"
                and r.parent in calls]
    if not calls or not launches:
        return None
    return sum(r.end_ns - r.start_ns for r in launches) * 1e-6 / len(calls)
