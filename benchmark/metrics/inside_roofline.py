"""inside_roofline: the least time of one pair's outputs inside the
foveation circle over the device time per pair of the kernels that compute
them (those whose names hold `inside_kernel`), in percent.

The work is the benchmark's own (fsrbench/work.py's count of inside
outputs): operations, the configuration's `ops_per_output` for an inside
output (and its inputs' share); bytes, each inside output's word written
once and the input words read once, pro rata to the inside outputs; the
least time the larger of operations over 67 TFLOP/s FP32 and bytes over
3.35 TB/s. The program's launch records (openvr_fsr_tpu_torch/utils/
trace.py: a launch's `inside` outputs) only vouch for it: None where the
program publishes no `inside_outputs` counter, where any record was dropped
or left open, where a counter disagrees with its records, or where a
`process` call's launches computed another number of inside outputs than
the benchmark counts."""

SPANS = {"calls": "process", "launches": "launch", "builds": "build"}
SUMS = {"kernels": "kernels", "inside_outputs": "inside",
        "outside_outputs": "outside"}


def _inside_per_call():
    """The inside outputs of each `process` call's launches, or None."""
    try:
        from openvr_fsr_tpu_torch.utils import trace
    except ImportError:
        return None
    recs, counts = trace.records(), trace.counters()
    if "inside_outputs" not in counts or counts.get("dropped") or \
            any(r.end_ns is None for r in recs):
        return None
    for counter, name in SPANS.items():
        if counts.get(counter) != sum(r.name == name for r in recs):
            return None
    launches = [r for r in recs if r.name == "launch"]
    for counter, key in SUMS.items():
        if counts[counter] != sum(r.info.get(key, 0) for r in launches):
            return None
    per_call = {i: 0 for i, r in enumerate(recs) if r.name == "process"}
    for r in launches:
        if r.parent in per_call:
            per_call[r.parent] += r.info.get("inside", 0)
    return list(per_call.values())


def read(ctx):
    t, work, done = ctx.trace, ctx.work, ctx.window.completed
    if t is None or not done or not work["inside"]:
        return None
    per_call = _inside_per_call()
    if not per_call or any(n != work["inside"] for n in per_call):
        return None
    inside_us = sum(d for name, _, d in t.kernels if "inside_kernel" in name)
    if not inside_us:
        return None
    c = ctx.config
    (iw, ih), (ow, oh) = c["eye_in_wh"], c["eye_out_wh"]
    ops = c["ops_per_output"]
    share = work["inside"] / (2 * ow * oh)
    inside_work = {
        "ops": work["inside"] * (ops["inside"] + ops["per_input_inside"]
                                 * (iw * ih) / (ow * oh)),
        "bytes": work["inside"] * 4 + share * 2 * iw * ih * 4}
    least, _ = ctx.least_ms(inside_work)
    return 100.0 * least / (inside_us * 1e-3 / done)
