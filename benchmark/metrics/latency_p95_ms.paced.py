"""latency_p95_ms.paced: the 95th percentile (nearest rank) over every pair
due in an open loop's window of its latency, from its due time at the
generator to the host seeing its output complete on the card, read in the
traced run. A pair that failed (dropped by a full ring, or never completed)
lies beyond every latency; should the percentile fall on one, it reads the
window's length."""


def read(ctx):
    w = ctx.window
    if not w.latencies_ms:
        return None
    p = ctx.percentile(w.latencies_ms, 95)
    return p if p != float("inf") else w.seconds * 1e3
