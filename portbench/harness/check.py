"""What decides ``correct``: the blocks and the state that the timed path
produced, against the plain reference (``portbench/reference``), run once
the window has closed, on the host.

* The start: the reference renders the window's first ``START_BLOCKS``
  blocks from its own initial state, through its own bus and chain; each
  block's stereo and mono are compared, and the state after them (read by
  meaning, ``harness/meaning.py``) against the program's snapshot there.
* The steps: at each step block (drawn from the seed along the window) the
  reference starts from the program's snapshot before it, read by meaning,
  renders that block's banks, mix and master, and its mono and its state
  after it are compared with the program's.  The reference cannot afford
  to follow a window of hundreds of blocks from the start, so it follows
  the program one block at a time from the program's own state; the start
  checks that state's beginning.  The bus and the chain, whose state the
  checks do not read, are compared over the start blocks only.

Numbers compared, each with its limit (the configuration's ``limits``,
set from the readings in PERF.md):

* ``out_gap``: the worst ``|program - reference|`` of a start block's
  stereo sample over that block's reference peak (at least
  ``PEAK_FLOOR``): a gap relative to the block's loudness;
* ``mono_gap``: the same of the mono (the mix's sum through the master and
  the limiter) of every compared block;
* ``state_gap``: the worst leaf of the voices' and the mixer's state by
  meaning (``meaning.gap``);
* ``nonfinite_blocks``: window blocks whose stereo holds a NaN or an
  infinity (limit 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness import meaning
from portbench.harness.window import START_BLOCKS

#: the least peak a block's gap is taken relative to (-60 dBFS)
PEAK_FLOOR = 1e-3


def _host(x) -> np.ndarray:
    return (x.detach().to("cpu").numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            ).astype(np.float64)


def out_gap(prog, ref) -> float:
    a, b = _host(prog), _host(ref)
    if a.shape != b.shape:
        return math.inf
    if not a.size:
        return 0.0
    d = np.abs(a - b)
    d[np.isnan(a) & np.isnan(b)] = 0.0
    d[np.isnan(d)] = math.inf
    peak = np.abs(b[np.isfinite(b)]).max(initial=0.0)
    return float(d.max()) / max(float(peak), PEAK_FLOOR)


def judge(window, table, cfg) -> dict:
    """The numbers compared: ``{name: value}``, with where each worst one
    was found under ``"where"``."""
    from portbench.reference.render import Reference

    ref = Reference(cfg)
    kinds = list(cfg["voices"])
    worst = {"out_gap": (0.0, "none"), "mono_gap": (0.0, "none"), "state_gap": (0.0, "none")}

    def note(name, value, where):
        if value > worst[name][0] or math.isnan(value):
            worst[name] = (value, where)

    state, bus = ref.init_state(), ref.bus()
    for b in range(START_BLOCKS):
        state, y, mono = ref.render_block(state, table.block(b), bus)
        note("out_gap", out_gap(window.outs[b], y), f"block {b}")
        note("mono_gap", out_gap(window.monos[b], mono), f"block {b}")
    g, where = meaning.gap(meaning.read(window.snaps[START_BLOCKS], kinds), state)
    note("state_gap", g, f"after block {START_BLOCKS - 1}: {where}")
    for j in window.step_blocks:
        state = meaning.read(window.snaps[j], kinds)
        state, _y, mono = ref.render_block(state, table.block(j))
        note("mono_gap", out_gap(window.monos[j], mono), f"block {j}")
        g, where = meaning.gap(meaning.read(window.snaps[j + 1], kinds), state)
        note("state_gap", g, f"after block {j}: {where}")
    return {"out_gap": worst["out_gap"][0], "mono_gap": worst["mono_gap"][0],
            "state_gap": worst["state_gap"][0], "nonfinite_blocks": window.nonfinite_blocks,
            "where": {k: v[1] for k, v in worst.items()}}


def is_correct(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in limits.items())
