"""host_ms_per_block.rt: host ms a block inside the calls to
``_render_all`` and ``process_chain``, untraced blocks."""

from portbench.harness import readers


def read(ctx):
    return readers.host_ms_per_block(ctx, ("render_all", "process_chain"))
