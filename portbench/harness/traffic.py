"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and a configuration's banks -> the per-block trigger events, from the seed.

The sequencer is the port's host sequencer without swing, copied: a step
every ``float32(60 / bpm / 4 * sr)`` samples, each step's sample the
float32 sum of the last one's and a step, rounded half to even.  Every
voice of a bank is struck on each enabled step, lagged by its own draw in
``[0, lag_max_s * sr)``; its velocity is ``base + span * ((v % cycle) /
(cycle - 1))`` for voice index ``v`` of its bank.  The draws come from one
``numpy.random.RandomState`` seeded with ``seed mod 2**32``, bank by bank
in the configuration's family order, as ``chip_smoke.kit_inputs`` draws
them.  A voice struck twice in one block keeps the later strike.

The events of ``LOOP_BLOCKS`` blocks form a table that the window plays in
a loop (block ``i`` takes row ``i % LOOP_BLOCKS``; its ``block_start`` is
``i * B`` throughout): the table is made once, in set-up.
"""

from __future__ import annotations

import numpy as np

#: blocks of events in the table (8 s of audio at 44.1 kHz in 512-sample
#: blocks; the window plays it in a loop)
LOOP_BLOCKS = 689


def step_samples(bpm: float, sample_rate: float) -> float:
    return float(np.float32((60.0 / bpm) / 4.0 * sample_rate))


def hit_samples(seq: dict, sample_rate: float, n_samples: int) -> list:
    """Samples of the enabled steps' strikes before ``n_samples``."""
    sps = step_samples(seq["bpm"], sample_rate)
    pattern = [ch != "." for ch in seq["pattern"][: seq["steps"]]]
    hits, t, step = [], 0, 0
    while t < n_samples:
        if pattern[step]:
            hits.append(t)
        step = (step + 1) % len(pattern)
        t = int(round(float(np.float32(t) + np.float32(sps))))
    return hits


def bank_events(hits, lags, vel_of, block_size: int, n_blocks: int):
    """``(offs [n_blocks, V] int32, vels [n_blocks, V] float32)``: each
    strike at ``hit + lag`` lands in its block at its offset; no strike is
    offset ``block_size``."""
    nv = lags.shape[0]
    offs = np.full((n_blocks, nv), block_size, np.int32)
    vels = np.zeros((n_blocks, nv), np.float32)
    cols = np.arange(nv)
    for h in hits:
        s = h + lags
        ok = s < n_blocks * block_size
        offs[s[ok] // block_size, cols[ok]] = s[ok] % block_size
        vels[s[ok] // block_size, cols[ok]] = vel_of[ok]
    return offs, vels


class EventTable:
    """The window's events: per family ``[L, V]`` offsets and velocities,
    the bus's staged targets, and the block's start."""

    def __init__(self, cfg: dict, mix: dict, seed: int, loop_blocks: int = LOOP_BLOCKS):
        sr, B = cfg["sample_rate"], cfg["block_size"]
        self.block_size = B
        self.loop_blocks = int(loop_blocks)
        hits = hit_samples(mix["sequencer"], sr, self.loop_blocks * B)
        rng = np.random.RandomState(seed % 2**32)
        vel = mix["velocity"]
        self.banks = {}
        for kind, nv in cfg["voices"].items():
            lags = rng.randint(0, int(sr * mix["lag_max_s"]), size=nv)
            vel_of = (vel["base"] + vel["span"] * ((np.arange(nv) % vel["cycle"])
                                                   / (vel["cycle"] - 1.0))).astype(np.float32)
            self.banks[kind] = bank_events(hits, lags, vel_of, B, self.loop_blocks)
        self.fx = {name: np.asarray(t, np.float32)
                   for name, t in cfg.get("bus", {}).get("targets", {}).items()
                   if name in cfg["bus"]["order"]}

    def block(self, i: int) -> dict:
        """Block ``i``'s events as host arrays (views into the table)."""
        r = i % self.loop_blocks
        ev = {"block_start": np.int32(i * self.block_size)}
        for kind, (offs, vels) in self.banks.items():
            ev[kind + "_off"] = offs[r]
            ev[kind + "_vel"] = vels[r]
        for name, t in self.fx.items():
            ev["fx_" + name] = t
        return ev

    def chunk(self, i: int, n: int) -> dict:
        """Blocks ``i .. i+n-1`` stacked on a leading axis (host arrays)."""
        r = i % self.loop_blocks
        rows = slice(r, r + n) if r + n <= self.loop_blocks else np.arange(i, i + n) % self.loop_blocks
        ev = {"block_start": (np.arange(i, i + n) * self.block_size).astype(np.int32)}
        for kind, (offs, vels) in self.banks.items():
            ev[kind + "_off"] = offs[rows]
            ev[kind + "_vel"] = vels[rows]
        for name, t in self.fx.items():
            ev["fx_" + name] = np.tile(t, (n, 1))
        return ev
