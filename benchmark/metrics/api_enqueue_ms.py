"""api_enqueue_ms: the host's time to enqueue one Pipeline.process call with
no sync inside it, from a synchronised start (the procedure of the port's
tools/api_cost.py::enqueue_ms, commit 28546975116d8068293ff5b32b22b8593be022b5,
one call a round): the mean over every paced pair of the window."""


def read(ctx):
    e = ctx.window.enqueue_ms
    if not e:
        return None
    return sum(e) / len(e)
