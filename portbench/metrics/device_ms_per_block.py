"""device_ms_per_block: the card's busy time (the union of its kernels,
copies and memsets) over the traced stretch, a whole chunk of the window
with its upload, per block."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_us <= 0.0 or t.blocks <= 0:
        return None
    return t.busy_us * 1e-3 / t.blocks
