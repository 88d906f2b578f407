"""MixerGraph: host-defined named submix tracks with routing and metering
(port of libgooey_tpu/mixer/graph.py).

Behavioral reference: src/mixer/graph.rs (533 LoC).

* sources: DrumKit, Bass, PolySynth, Granulator, LoopMixer + 4 dynamic
  sampler racks (SOURCE_* 0-8, graph.rs:27-42);
* per-track strip: gain (≤2x, 10 ms smoothing), stereo balance (identity at
  center: l*=min(2(1-p),1), r*=min(2p,1)), mute/solo with scoped solo,
  read-and-reset peak meter, per-track effect rack;
* render: clear scratch → scatter(source, frame) → per-track strip+rack →
  master sum (rs:336-399); default 4-track layout is bit-identical to the
  flat mix (rs:131-143).

The scatter is a ``[T, S] × [S, 2, B]`` routing product (a plain
``torch.einsum``: the JAX package computes it outside any kernel); the
strips are smoothed trajectories; each track's rack runs through
``mixer/chain.process_chain`` (its runs on ``bus_chain``, the plate on
``plate_block``); peaks are block maxima folded into a device-side running
maximum, read on the host only when asked.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank, smooth_block, smoothing_coeff
from libgooey_tpu_torch.mixer import chain as chain_mod

SOURCE_DRUMKIT = 0
SOURCE_BASS = 1
SOURCE_POLYSYNTH = 2
SOURCE_GRANULATOR = 3
SOURCE_LOOPMIXER = 4
SOURCE_COUNT = 5
SOURCE_SAMPLER_BASE = 5
SAMPLER_SOURCE_COUNT = 4
SOURCE_CAPACITY = SOURCE_COUNT + SAMPLER_SOURCE_COUNT

MAX_TRACK_GAIN = 2.0


def graph_block(bank, targets, source_frames, routing, rack_states, rack_targets, *,
                coeff, block_size, sample_rate, rack_keys):
    """One block of the whole graph.  ``targets``: the ``[T, 3]`` strip
    targets (gain, pan, audible) on the device; ``source_frames``:
    ``[SOURCE_CAPACITY, 2, B]``; ``routing``: ``[T, SOURCE_CAPACITY]``;
    ``rack_keys``: each track's chain ``static_key``.  Returns ``(bank,
    rack_states, master [2, B], peaks [T])``."""
    bank = SmootherBank(current=bank.current, target=targets)
    bank, traj = smooth_block(bank, coeff, block_size)               # [T, 3, B]
    tracks_in = torch.einsum("ts,scb->tcb", routing, source_frames)  # [T, 2, B]

    gain_t = traj[:, 0, :]
    pan_t = traj[:, 1, :]
    mute_t = traj[:, 2, :]
    lg = torch.clamp(2.0 * (1.0 - pan_t), max=1.0)
    rg = torch.clamp(2.0 * pan_t, max=1.0)
    stripped = torch.stack(
        [tracks_in[:, 0] * gain_t * lg, tracks_in[:, 1] * gain_t * rg], dim=1
    ) * mute_t[:, None, :]

    outs, peaks, new_states = [], [], []
    for ti, key in enumerate(rack_keys):
        sig = stripped[ti]
        if key:
            st, sig = chain_mod.process_chain(rack_states[ti], sig.contiguous(),
                                              rack_targets[ti], key, sample_rate=sample_rate)
            new_states.append(tuple(st))
        else:
            new_states.append(rack_states[ti])
        outs.append(sig)
        peaks.append(torch.max(torch.abs(sig)))
    master = sum(outs) if outs else torch.zeros_like(source_frames[0])
    peaks_arr = (torch.stack(peaks) if peaks
                 else torch.zeros((0,), dtype=torch.float32, device=source_frames.device))
    return bank, tuple(new_states), master, peaks_arr


class Track:
    def __init__(self, name: str, sample_rate: float, bpm: float, *, device):
        self.name = name
        self.gain = 1.0
        self.pan = 0.5
        self.muted = False
        self.soloed = False
        self.peak = 0.0
        self.rack = chain_mod.EffectChain(sample_rate, bpm, device=device)


class MixerGraph:
    """Host graph config + functional per-block render over source frames."""

    def __init__(self, sample_rate: float, bpm: float, *, device):
        self.sr = sample_rate
        self.bpm = bpm
        self.device = device
        self.tracks: List[Track] = []
        self.routes: List[Optional[int]] = [None] * SOURCE_CAPACITY
        self._smooth: Optional[SmootherBank] = None  # [T, 3]: gain, pan, mute
        self._coeff = smoothing_coeff(sample_rate, 10.0)
        #: device-side per-track peak accumulator (graph.rs:93-98 meters):
        #: record_peaks folds block maxima in without a host sync; take_peak
        #: drains it on the host query
        self._peak_dev = None
        #: the routing matrix and strip targets on the device, rebuilt only
        #: after a mutator below invalidates them
        self._routing_dev = None
        self._targets_dev = None

    @staticmethod
    def with_default_layout(sample_rate: float, bpm: float, *, device) -> "MixerGraph":
        g = MixerGraph(sample_rate, bpm, device=device)
        for name in ("Drums", "Bass", "Synth", "Loops"):
            g.add_track(name)
        g.route(SOURCE_DRUMKIT, 0)
        g.route(SOURCE_BASS, 1)
        g.route(SOURCE_POLYSYNTH, 2)
        g.route(SOURCE_GRANULATOR, 3)
        g.route(SOURCE_LOOPMIXER, 3)
        return g

    def add_track(self, name: str) -> int:
        self.tracks.append(Track(name, self.sr, self.bpm, device=self.device))
        self._smooth = None
        self._routing_dev = None
        self._targets_dev = None
        return len(self.tracks) - 1

    def route(self, source: int, track: Optional[int]) -> bool:
        if not (0 <= source < SOURCE_CAPACITY):
            return False
        if track is not None and not (0 <= track < len(self.tracks)):
            return False
        self.routes[source] = track
        self._routing_dev = None
        return True

    def set_track_gain(self, track: int, gain: float):
        self.tracks[track].gain = float(np.clip(gain, 0.0, MAX_TRACK_GAIN))
        self._targets_dev = None

    def set_track_pan(self, track: int, pan: float):
        self.tracks[track].pan = float(np.clip(pan, 0.0, 1.0))
        self._targets_dev = None

    def set_track_mute(self, track: int, muted: bool):
        self.tracks[track].muted = bool(muted)
        self._targets_dev = None

    def set_track_solo(self, track: int, soloed: bool):
        self.tracks[track].soloed = bool(soloed)
        self._targets_dev = None

    def take_peak(self, track: int) -> float:
        self._drain_peaks()
        p = self.tracks[track].peak
        self.tracks[track].peak = 0.0
        return p

    def _drain_peaks(self):
        """Pull the device peak accumulator into the host mirrors (the only
        peak sync point — a host-initiated query, off the render path)."""
        if self._peak_dev is None:
            return
        for t, p in zip(self.tracks, self._peak_dev.cpu().numpy()):
            t.peak = max(t.peak, float(p))
        self._peak_dev = None

    def _strip_targets(self) -> np.ndarray:
        any_solo = any(t.soloed for t in self.tracks)
        rows = []
        for t in self.tracks:
            audible = (not t.muted) and ((not any_solo) or t.soloed)
            rows.append([t.gain, t.pan, 1.0 if audible else 0.0])
        return np.asarray(rows, np.float32)

    def routing_matrix(self) -> np.ndarray:
        """[T, SOURCE_CAPACITY] 0/1 scatter matrix."""
        T = len(self.tracks)
        m = np.zeros((T, SOURCE_CAPACITY), np.float32)
        for s, t in enumerate(self.routes):
            if t is not None and t < T:
                m[t, s] = 1.0
        return m

    def _stage(self):
        """Build the strip smoothers and upload the routing matrix and the
        strip targets where a mutator invalidated them."""
        if self._smooth is None:
            self._smooth = SmootherBank.init(self._strip_targets(), self.device)
        if self._routing_dev is None:
            self._routing_dev = torch.as_tensor(self.routing_matrix(), device=self.device)
        if self._targets_dev is None:
            self._targets_dev = torch.as_tensor(self._strip_targets(), device=self.device)

    def render(self, source_frames, block_size: int):
        """Mix ``source_frames[SOURCE_CAPACITY, 2, B]`` → ``[2, B]``.

        Returns ``(master, per_track_peaks[T])``, device tensors.  Chain
        states live in each track's rack."""
        self._stage()
        rack_keys = tuple(t.rack.static_key() for t in self.tracks)
        rack_states = tuple(tuple(t.rack.states) for t in self.tracks)
        rack_targets = tuple(tuple(t.rack.targets_list()) for t in self.tracks)
        bank, new_states, master, peaks = graph_block(
            self._smooth, self._targets_dev, source_frames, self._routing_dev,
            rack_states, rack_targets, coeff=self._coeff, block_size=block_size,
            sample_rate=self.sr, rack_keys=rack_keys)
        self._smooth = bank
        for t, st in zip(self.tracks, new_states):
            t.rack.states = list(st)
        return master, peaks

    def record_peaks(self, peaks):
        """Fold a block's per-track maxima into the accumulator — no sync."""
        if self._peak_dev is None or self._peak_dev.shape != peaks.shape:
            self._peak_dev = peaks
        else:
            self._peak_dev = torch.maximum(self._peak_dev, peaks)
