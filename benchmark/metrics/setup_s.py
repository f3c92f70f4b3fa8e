"""setup_s: the process's start to the window's opening (host clock):
imports, the CUDA context, the kernel libraries (built on a checkout's
first run), the inputs, the warm-up."""


def read(ctx):
    return ctx.setup_s
