"""Set-up, warm-up and the measured window of one run.

Two clients, named by the traffic mix (``client.kind``):

* ``chunked``: the events of ``chunk_blocks`` blocks go to the card at a
  time (``Program.upload``), then each block through ``render`` and, where
  the configuration has a chain, ``process_chain``, back to back; each
  block's stereo is copied on the card (kept for the checks).  The window
  closes with ``torch.cuda.synchronize()`` after the first block enqueued
  past ``--seconds``.
* ``block``: each block's events are handed over as host arrays, the block
  goes through ``render`` and, where the configuration has a chain,
  ``process_chain``; its stereo is copied to the host before the next
  block starts.  A block's latency runs from handing its events over to its
  stereo on the host.

A mix of another shape needs a client here.  Both are closed loops.
Before the window the garbage collector is run and what set-up made is
frozen out of its later passes.  The window starts from the
configuration's initial state at block 0; the warm-up renders
``WARMUP_BLOCKS`` blocks of the same shapes from a copy of that state
first.  Along the window the harness keeps, for the checks, the stereo
and the mono of the first ``START_BLOCKS`` blocks and the mono of each
step block, and snapshots of the state after the start blocks, before
each step block and after it.  Step blocks (the mix's ``step_checks``)
fall where the window's clock passes fractions of ``--seconds`` drawn from
the seed.  With ``--trace 1`` the profiler records the mix's
``trace_blocks`` blocks from the first block past ``TRACE_AT`` of the
window (in the ``chunked`` client, the first that opens a chunk), between
two synchronizations (``harness/trace.py``); a cell whose end-to-end
metrics come from the trace has that stretch in every run.  The host
spans, and the blocks and seconds of the host's own rate, are taken over
the blocks before that stretch (all blocks of an untraced run), so that
the profiler's cost stays out of them.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field

import numpy as np

from portbench.harness import tree

#: blocks the warm-up renders; blocks the window holds at least; blocks at
#: its start that the checks follow from the reference's own initial state;
#: the share of the window before the traced stretch
WARMUP_BLOCKS = 3
MIN_BLOCKS = 8
START_BLOCKS = 4
TRACE_AT = 0.4


@dataclass
class Window:
    blocks: int = 0
    seconds: float = 0.0
    setup_s: float = 0.0
    latencies: list = field(default_factory=list)   # seconds, block client
    spans: dict = field(default_factory=dict)         # name -> host seconds, span_blocks
    span_blocks: int = 0
    pre_blocks: int = 0                               # blocks done before the traced stretch
    pre_seconds: float = 0.0                          # and the window's seconds they took
    ends: list = field(default_factory=list)          # window seconds at each block's enqueue end
    outs: dict = field(default_factory=dict)          # block -> stereo kept for the checks
    monos: dict = field(default_factory=dict)         # block -> mono kept for the checks
    snaps: dict = field(default_factory=dict)         # block -> state before that block
    step_blocks: list = field(default_factory=list)
    nonfinite_blocks: int = 0
    trace: object = None                              # harness.trace.Trace
    memory_peak_bytes: int = 0


def step_fractions(seed: int, n: int) -> list:
    """Where in the window the step checks fall, as fractions of it."""
    rng = np.random.default_rng([seed % 2**63, 7])
    return sorted(float(f) for f in rng.uniform(0.15, 0.9, size=n))


class _Spans:
    """Host seconds by name over the blocks before the traced stretch;
    inside it each span goes to the tracer with its times instead, and
    after it nothing is summed."""

    def __init__(self):
        self.total, self.tracer, self.summing = {}, None, True

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if self.tracer is not None:
                self.tracer.span(name, t0, t1)
            elif self.summing:
                self.total[name] = self.total.get(name, 0.0) + t1 - t0


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step(system, client, state, ev, spans=None):
    """One block through the system -> ``(state, stereo, mono)``; the
    stereo left on the device (``chunked``) or on the host (``block``)."""
    spans = spans or _no_spans
    with spans("render_all"):
        state, out, mono = system.render(state, ev)
    if system.has_chain:
        with spans("process_chain"):
            state, out = system.process_chain(state, out)
    if client["kind"] == "chunked":
        with spans("keep_out"):
            out = out.clone()
    else:
        with spans("copy_out"):
            out = out.cpu()
    return state, out, mono


@contextlib.contextmanager
def _no_spans(name):
    yield


def warm_up(system, table, mix, device):
    """Render ``WARMUP_BLOCKS`` blocks of the cell's own shapes from a copy
    of the initial state (the first call builds the kernels)."""
    client = mix["client"]
    state = system.initial_state()
    if client["kind"] == "chunked":
        ev = system.upload(table.chunk(0, int(client["chunk_blocks"])))
        for i in range(WARMUP_BLOCKS):
            state, _out, _mono = _step(system, client, state, {k: v[i] for k, v in ev.items()})
    else:
        for i in range(WARMUP_BLOCKS):
            state, _out, _mono = _step(system, client, state, table.block(i))
    _sync(device)
    del state


def run_window(system, table, mix, *, seconds, seed, trace, device, setup_clock) -> Window:
    """The measured window (see the module's docstring)."""
    from portbench.harness.trace import Tracer

    client = mix["client"]
    chunk = int(client.get("chunk_blocks", 1))
    start_blocks = START_BLOCKS
    min_blocks = max(MIN_BLOCKS, start_blocks + 2 * int(mix["step_checks"]) + 2)
    fracs = step_fractions(seed, int(mix["step_checks"]))
    w = Window()
    spans = _Spans()
    tracer = Tracer(device, int(mix["trace_blocks"])) if trace else None
    trace_at = TRACE_AT * seconds
    keep_after = set()

    state = system.initial_state()
    _sync(device)
    # what set-up made stays alive through the window: keep the collector's
    # passes in the window from walking it
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    w.setup_s = setup_clock()
    ev_dev, i = None, 0
    while True:
        now = time.perf_counter() - t0
        tracing = tracer is not None and tracer.active
        if (tracer is not None and not tracer.started and now >= trace_at and i >= start_blocks
                and not keep_after and i % chunk == 0):
            _sync(device)
            w.pre_blocks, w.pre_seconds = i, time.perf_counter() - t0
            tracer.start()
            spans.tracer, spans.summing = tracer, False
            tracing = True
        if i == start_blocks:
            w.snaps[i] = tree.clone(state)
        elif (fracs and i > start_blocks and now >= fracs[0] * seconds and not tracing
              and not keep_after):
            fracs.pop(0)
            w.snaps[i] = tree.clone(state)
            w.step_blocks.append(i)
            keep_after.add(i + 1)
        tb = time.perf_counter()
        if client["kind"] == "chunked":
            if i % chunk == 0:
                with spans("events_to"):
                    ev_dev = system.upload(table.chunk(i, chunk))
            ev = {k: v[i % chunk] for k, v in ev_dev.items()}
        else:
            ev = table.block(i)
        state, out, mono = _step(system, client, state, ev, spans)
        if client["kind"] == "block":
            w.latencies.append(time.perf_counter() - tb)
            if not bool(np.isfinite(out.numpy()).all()):
                w.nonfinite_blocks += 1
        if client["kind"] == "chunked" or i < start_blocks:
            w.outs[i] = out
        if i < start_blocks or i in w.step_blocks:
            w.monos[i] = mono
        if spans.summing and not tracing:
            w.span_blocks += 1
        i += 1
        w.ends.append(time.perf_counter() - t0)
        if i in keep_after:
            w.snaps[i] = tree.clone(state)
            keep_after.discard(i)
        if tracing and tracer.count_block():
            tracer.stop()
            spans.tracer = None
        if (time.perf_counter() - t0 >= seconds and i >= min_blocks and not keep_after
                and not (tracer is not None and tracer.active)):
            break
    _sync(device)
    w.seconds = time.perf_counter() - t0
    gc.unfreeze()
    w.blocks = i
    if tracer is None or not tracer.started:
        w.pre_blocks, w.pre_seconds = w.blocks, w.seconds
    w.spans = spans.total
    w.trace = tracer.result() if tracer is not None and tracer.started else None
    if client["kind"] == "chunked":
        import torch

        finite = torch.stack([torch.isfinite(o).all() for o in w.outs.values()]).cpu()
        w.nonfinite_blocks = int((~finite).sum())
        w.outs = {b: o for b, o in w.outs.items() if b < start_blocks}
    return w
