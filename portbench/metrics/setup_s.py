"""setup_s: seconds from the process's start to the window's first block
(loading, the kernels' build on a first run, state, events, warm-up)."""


def read(ctx):
    return ctx.window.setup_s
