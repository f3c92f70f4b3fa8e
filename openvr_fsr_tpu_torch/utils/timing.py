"""Debug-mode frame timer.

Analog of the reference's GPU timestamp-query ring (PostProcessor.h:72-83,
PostProcessor.cpp:547-628): time each dispatch, keep a rolling average over
500 frames, and log "Average GPU processing time for upscale: X ms" at each
rollover. CUDA work is timed with a pair of `torch.cuda.Event`s on the
current stream (the timestamp queries' counterpart); CPU work with
`time.perf_counter`.
"""

import time

import torch

from .log import get_logger

__all__ = ["GpuTimer"]


class GpuTimer:
    """Rolling-average frame timer (500-sample window like the reference).

    Logs per-STEREO-PAIR milliseconds. The reference times one single-eye
    dispatch and doubles it (PostProcessor.cpp:621-622); here one measured
    call covers a whole batch, so the per-pair figure is t / pairs with
    pairs supplied by the caller (B/2 for single-eye batches — a B=1
    single-eye call has pairs=0.5, reproducing the reference's x2)."""

    def __init__(self, window=500, scale_for_stereo=False):
        self.window = window
        self.scale_for_stereo = scale_for_stereo
        self.summed = 0.0
        self.count = 0
        self.last_avg_ms = None

    def measure(self, fn, *args, pairs=None):
        """Run fn(*args) and add its time (seconds) to the window. Any CUDA
        tensor argument selects event timing on the current stream; the call
        then waits for its end event."""
        cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1000.0
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            seconds = time.perf_counter() - t0
        if pairs is None:
            pairs = 0.5 if self.scale_for_stereo else 1.0
        self.summed += seconds / pairs
        self.count += 1
        if self.count >= self.window:
            avg_ms = 1000.0 / self.count * self.summed
            self.last_avg_ms = avg_ms
            get_logger().info(
                "Average GPU processing time for upscale: %.4f ms", avg_ms)
            self.count = 0
            self.summed = 0.0
        return out
