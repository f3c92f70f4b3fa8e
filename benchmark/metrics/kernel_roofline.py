"""kernel_roofline: the least time one pair needs on the card over the
kernels' device time per pair (kernel_ms), in percent. The least time is
the larger of the pair's operations over 67 TFLOP/s FP32 and its unique
bytes over 3.35 TB/s (fsrbench/work.py); both count the algorithm's work,
whatever kernel does it."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels or not ctx.window.completed:
        return None
    kernel_ms = sum(d for _, _, d in t.kernels) * 1e-3 / ctx.window.completed
    least, _ = ctx.least_ms(ctx.work)
    return 100.0 * least / kernel_ms
