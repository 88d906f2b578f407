#!/usr/bin/env python3
"""bus_chain inside full_kit_4096_bus7's render against the same launches
replayed alone, on one CUDA card.

    python3 tools/torch_render_chain.py

Renders ``chip_smoke.py``'s full_kit_4096_bus7 (``bus_inputs`` with the
whole bus) for 48 blocks, keeping a copy of each ``bus_chain`` launch's
signal and phases; prints the device time of ``bus_chain`` per call in a
profiled render of 4 blocks (torch.profiler, the kernel's own rows), then
replays captured launches alone, back to back (``chip_smoke.device_ms``),
whole and one phase at a time (the compressor's detector and gain stage
together), and phase 3's inputs the same way; then one captured launch
after an idle gap on the card and after a 64 MB sweep through L2, on the
card named in the first line.  The render's time less the replay's is what the launches
around the kernel cost it, not its data.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_BLOCKS = 48
REPLAYED = (0, 10, 20, 47)


def groups(phases):
    """The phases one launch at a time, a detector with its gain stage."""
    out = []
    for p in phases:
        if p.args and p.args[0] is None and out and out[-1][-1].name == "env_follower_block":
            out[-1].append(p)
        else:
            out.append([p])
    return out


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.ops import bus_kernels as bus

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)

    def copy(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    captured = []
    real = bus._launch_phases

    def recording(name, x, phases, *, fused):
        if fused:
            captured.append((x.clone(), [p._replace(args=tuple(map(copy, p.args)))
                                         for p in phases]))
        return real(name, x, phases, fused=fused)

    state, events, static = cs.bus_inputs(dev, N_BLOCKS, order=cs.FX_ORDER_FULL)
    bus._launch_phases = recording
    try:
        engine.render_many(state, events, **static)
        torch.cuda.synchronize()
    finally:
        bus._launch_phases = real

    four = {k: v[:4] for k, v in events.items()}
    engine.render_many(state, four, **static)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.render_many(state, four, **static)
        torch.cuda.synchronize()
    rows = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and "bus_chain_kernel" in e.name]
    print(f"in the render (4 profiled blocks): bus_chain "
          f"{[round(e.self_device_time_total, 1) for e in rows]} us", flush=True)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        return cs.device_ms(fn, 20) * 1e3

    def replay(label, x, phases):
        whole = timed(lambda: bus.bus_chain(x, phases))
        alone = [timed(lambda g=g: bus.bus_chain(x, g)) for g in groups(phases)]
        print(f"{label}: bus_chain {whole:.1f} us; each phase alone "
              f"{[round(a, 1) for a in alone]} us ({[p.name for p in phases]})", flush=True)

    for k in REPLAYED:
        replay(f"render block {k} replayed", *captured[k])
    # the same launch after what a render puts before it: an idle gap on
    # the card, or other work through L2 (a 64 MB sweep)
    x, phases = captured[REPLAYED[-1]]
    sweep = torch.empty(16 << 20, device=dev)

    def after_gap():
        torch.cuda._sleep(2_000_000)   # ~1 ms of a spinning kernel, then idle
        torch.cuda.synchronize()
        time.sleep(0.001)
        bus.bus_chain(x, phases)

    def after_sweep():
        sweep.add_(1.0)
        bus.bus_chain(x, phases)

    for label, fn in (("after an idle gap", after_gap), ("after an L2 sweep", after_sweep)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        rows = [e.self_device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "bus_chain_kernel" in e.name]
        print(f"render block {REPLAYED[-1]} replayed {label}: bus_chain median "
              f"{float(np.median(rows)):.1f} us over {len(rows)}", flush=True)
    replay("phase 3's inputs",
           *list(cs.bus_cases(dev, np.random.RandomState(cs.SEED), cs.B)[1].values())[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
