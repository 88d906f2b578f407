"""A run of bus effects in one kernel launch (port of
libgooey_tpu/ops/pallas_chain.py ``process_run``).

Each effect module's ``prepare`` gives its block's kernel phase (the
compressor: a list of two, its detector and its gain stage) and its state
update, the same glue its ``process_block`` wraps around its own kernels;
the phases then run in order in one ``bus_chain`` launch, the signal passing
from one effect to the next on the card.  The glue (the
trajectories that feed a kernel, the delay's ring gather and scatter, state
packing, freezes) runs in PyTorch before and after the launch, as it runs
in XLA around ``chain_fused``.  A run gives what the effects' own
``process_block`` give one after the other: none reads the signal before
its kernel, and the input is made finite once, up front, where each
effect does it on its own.  The plate, a sidechained compressor and a
feedback waveshaper with its feedback on do not join a run
(engine/engine.py and mixer/chain.py split their effects around them).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from libgooey_tpu_torch.ops import bus_kernels


def process_run(modules: Sequence, states: Sequence, x: torch.Tensor, targets_list: Sequence,
                *, sample_rate: float, options: Optional[Sequence[dict]] = None):
    """Run effects ``modules`` (each with ``prepare``: a phase, or a list of
    phases for the compressor and the feedback waveshaper) over the stereo
    block ``x`` [2, B] in one launch.  ``options``: per-effect keyword
    arguments of ``prepare`` (the delay's ``pingpong``).  Returns
    ``(new_states, y)``."""
    B = x.shape[-1]
    x = torch.where(torch.isfinite(x), x, 0.0)
    phases, finishers = [], []
    for i, (mod, st, tg) in enumerate(zip(modules, states, targets_list)):
        kw = options[i] if options is not None else {}
        phase, finish = mod.prepare(st, tg, sample_rate=sample_rate, block_size=B,
                                    device=x.device, **kw)
        group = isinstance(phase, list)
        phases += phase if group else [phase]
        finishers.append((finish, len(phase) if group else None))
    y, outputs = bus_kernels.bus_chain(x.contiguous(), phases)
    new_states, o = [], 0
    for finish, n in finishers:
        new_states.append(finish(outputs[o:o + n] if n else outputs[o]))
        o += n or 1
    return new_states, y
