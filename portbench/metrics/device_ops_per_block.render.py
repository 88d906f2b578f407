"""device_ops_per_block: kernels, copies and memsets a block in the trace."""

from portbench.harness import readers


def read(ctx):
    return readers.ops_per_block(ctx)
