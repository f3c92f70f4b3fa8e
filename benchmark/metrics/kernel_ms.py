"""kernel_ms: the summed device time of every CUDA kernel that started in the
traced window, per pair completed in it (torch.profiler's kernel events)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels or not ctx.window.completed:
        return None
    return sum(d for _, _, d in t.kernels) * 1e-3 / ctx.window.completed
