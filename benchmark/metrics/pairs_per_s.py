"""pairs_per_s: every pair completed in a closed loop's window over the
window, which ends in torch.cuda.synchronize() (host clock)."""


def read(ctx):
    w = ctx.window
    if ctx.traffic["arrivals"] != "closed" or w.seconds <= 0:
        return None
    return w.completed / w.seconds
