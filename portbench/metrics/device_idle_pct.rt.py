"""device_idle_pct: 1 - the union of device activity over the wall of the
traced stretch, in percent."""

from portbench.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
