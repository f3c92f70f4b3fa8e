"""upscale_gpu_ms: the card's processing time per pair, the quantity the
upstream mod's debug mode logs as "Average GPU processing time for
upscale" (fholger/openvr_fsr PostProcessor.cpp:601-628, D3D11 timestamp
queries): the device trace's busy time inside the window (the union of its
kernels, copies and memsets) over the pairs completed in it. The harness
traces every run of a cell that reports it. None without a trace, or where
nothing ran on the device (the CPU's plain path)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or not ctx.window.completed:
        return None
    return t.busy_s * 1e3 / ctx.window.completed
