"""api_self_ms.paced: api_self_ms in an open loop's window: the mean, over
the paced calls, of the program's `process` span less its nested
`launch` spans (openvr_fsr_tpu_torch/utils/trace.py), each call made
from an idle card."""

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
    calls = [(i, r) for i, r in enumerate(recs or ()) if r.name == "process"]
    if not calls:
        return None
    launch_ns = {}
    for r in recs:
        if r.name == "launch" and r.parent is not None:
            launch_ns[r.parent] = launch_ns.get(r.parent, 0) + \
                r.end_ns - r.start_ns
    self_ns = sum(r.end_ns - r.start_ns - launch_ns.get(i, 0)
                  for i, r in calls)
    return self_ns * 1e-6 / len(calls)

