"""build_s: the run's seconds in the program's cold spans
(openvr_fsr_tpu_torch/utils/trace.py, recorded whatever the profiler):
each build-cache miss (`build`: stage plan, host maps, DMA geometry) and
each built function's first `launch` with its kernel library's load
(`library`, nvcc on a checkout's first run), nested time counted once.
The part of setup_s that is the program's own set-up work."""

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
    cold = sorted((r.start_ns, r.end_ns) for r in recs or () if r.cold)
    if not cold:
        return None
    total, end = 0, None
    for s, e in cold:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9
