"""One run of one cell: set-up, warm-up, the measured window, the metrics,
the check, and the result line.

Set-up builds the configuration's model family (openvr_fsr_tpu_torch.models:
FsrModel, NisModel or CasModel, whose calls go to api.pipeline.Pipeline.
process), makes the run's input pairs from the seed, and calls the model on
every input pair before the window, so the build cache, the kernel
libraries and the CUDA context are warm. A stream mix (source host_rings)
also makes its rings and buffers and runs a short warm-up window through
them. `setup_s` runs from the process's start to the window's opening.
"""

import math
import time
from types import SimpleNamespace

import torch

from . import inputs as IN
from . import judge, work
from .load import StreamRig, run_window
from .trace import Tracer

__all__ = ["run_cell", "build_model", "WARM_CALLS", "WARM_STREAM_S"]

WARM_CALLS = 3            # calls per input pair before the window
WARM_STREAM_S = 0.2       # the stream's warm-up window


def build_model(config, device, precision=None):
    """The configuration's model family on `device`."""
    from openvr_fsr_tpu_torch.models.families import MODELS

    kw = ({"max_color_delta": config["cas_max_color_delta"]}
          if "cas_max_color_delta" in config else {})
    return MODELS[config["family"]](
        render_scale=config["render_scale"], sharpness=config["sharpness"],
        radius=config["radius"], eye_centers=work.eye_centers(config),
        color_bits=config["color_bits"],
        precision=precision or config["precision"], device=device, **kw)


def _percentile_nearest(values, q):
    """The q-th percentile by nearest rank over every value (inf allowed)."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def run_cell(cell, seed, seconds, trace, *, spec, device, t_process,
             precision=None, model_hook=None, log=None):
    """Run `cell` once. t_process: perf_counter at the process's start.
    precision overrides the configuration's (the control); model_hook wraps
    the model (the fault tests). Returns the result dict."""
    config, traffic = cell.config, cell.traffic
    log = log or (lambda *a: None)
    model = build_model(config, device, precision)
    call = model if model_hook is None else model_hook(model)
    iw, ih = config["eye_in_wh"]
    n_in = int(traffic.get("inputs", 3))
    pairs = IN.make_pairs(seed, n_in, iw, ih, device,
                          color_bits=config["color_bits"])
    for _ in range(WARM_CALLS):
        for x in pairs:
            model(x)
    host_pairs = [p.cpu().numpy() for p in pairs]
    rig = None
    if traffic["source"] == "host_rings":
        rig = StreamRig(host_pairs, int(traffic.get("ring_slots", 6)),
                        device)
        del pairs
        run_window(call, traffic, rig, WARM_STREAM_S,
                   IN.seed_rng(seed, 99), Tracer(False), device)
        feed = rig
    else:
        feed = pairs
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    # a cell whose end-to-end metrics read the device trace is traced in
    # its untraced runs too; busy_s and the breakdown stay --trace 1's
    tracer = Tracer(trace or any(m["source"] == "device_trace"
                                 for m in cell.end_to_end),
                    cuda=device.type == "cuda")
    if trace:
        seconds = min(seconds, float(traffic.get("trace_seconds", seconds)))
    win = run_window(call, traffic, feed, seconds, IN.seed_rng(seed, 1),
                     tracer, device)
    setup_s = win.t0 - t_process
    summary = tracer.summary
    shown = summary if trace else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"[window] {cell.name}: {win.completed}/{win.attempted} pairs in "
        f"{win.seconds:.3f} s, setup {setup_s:.3f} s")

    # the metrics
    ctx = SimpleNamespace(window=win, trace=summary, setup_s=setup_s,
                          work=work.pair_work(config), config=config,
                          traffic=traffic, percentile=_percentile_nearest,
                          least_ms=work.least_ms)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check: samples to the host, the program's state freed first
    samples = [(i, t, o.cpu().numpy()) for i, t, o in win.samples]
    win.samples = []
    del feed, model, call
    if rig is not None:
        rig.close()
        rig = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, info = judge.checks(
        samples, host_pairs, config,
        tag_errors=win.tag_errors if traffic["source"] == "host_rings"
        else None)
    info["reference_s"] = time.perf_counter() - t_ref
    correct = "max_lsb" in checks and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    info.update(_window_info(win))
    result = {
        "correct": bool(correct),
        "attempted": int(win.attempted),
        "failed": int(win.failed),
        "metrics": metrics,
        "device": _device(device, peak, shown),
    }
    if shown is not None:
        result["breakdown"] = {"device_ops": shown.device_ops,
                               "idle_gaps": shown.idle_gaps}
    result["info"] = info
    result["checks"] = checks
    return result


def _window_info(win):
    info = {"window_s": win.seconds, "completed": win.completed}
    if win.late_ms:
        info["generator_late_ms_p95"] = _percentile_nearest(win.late_ms, 95)
    if win.latencies_ms:
        finite = [x for x in win.latencies_ms if x != float("inf")]
        if finite:
            info["latency_ms_p50"] = _percentile_nearest(finite, 50)
            info["latency_ms_max"] = max(finite)
    return info


def _device(device, peak, summary):
    if device.type == "cuda":
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
             "count": 1, "memory_peak_bytes": int(peak)}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1,
             "memory_peak_bytes": 0}
    if summary is not None:
        d["busy_s"] = summary.busy_s
        d["window_s"] = summary.window_s
    return d
