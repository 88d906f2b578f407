"""bus_roofline_pct: the least time of the bus group's work a block
(``work/bus.json`` at the cell's widths) over the group's device time in
the trace, in percent."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "bus")
