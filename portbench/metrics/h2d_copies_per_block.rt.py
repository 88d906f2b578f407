"""h2d_copies_per_block.rt: host-to-device copies a block in the trace
(the per-block uploads of events and targets)."""

from portbench.harness import readers


def read(ctx):
    return readers.ops_per_block(ctx, lambda name: "HtoD" in name)
