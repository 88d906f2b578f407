"""block_ms_p95: the 95th percentile of every window block's wall time,
from handing its events over to its stereo on the host, in ms."""

from portbench.harness import readers


def read(ctx):
    p = readers.percentile(ctx.window.latencies, 95)
    return None if p is None else 1e3 * p
