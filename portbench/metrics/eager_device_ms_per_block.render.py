"""eager_device_ms_per_block.render: device ms a block of the operations
that are not the port's hand-written kernels (the eager glue, copies,
memsets)."""

from portbench.harness import readers


def read(ctx):
    return readers.eager_device_ms_per_block(ctx)
