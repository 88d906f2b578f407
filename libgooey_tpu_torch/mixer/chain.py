"""Per-channel/per-track effect chain: the reorderable EFFECT_* rack
(port of libgooey_tpu/mixer/chain.py).

Behavioral reference: src/mixer/effect_chain.rs — a typed, ordered list
over the 9 reorderable effects with musically-useful defaults
(effect_chain.rs:57-108) and ``set_param(PARAM_*, value)`` dispatch
(rs:156-230).  A chain is a host object holding ordered entries (effect id,
staged targets) and a matching list of device states; ``process_chain``
folds the stereo block through them.

As the JAX package does on the TPU (mixer/chain.py:269-304), a maximal run
of two or more mergeable entries (all but the plate and a feedback
waveshaper with feedback on) is one ``bus_chain`` launch
(``effects/chain.process_run``); every other entry launches its own
kernels.  ``fuse_runs=False`` (the JAX package's ``LIBGOOEY_CHAIN_FUSE=off``)
keeps one launch per entry.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libgooey_tpu_torch.effects import chain as fx_chain
from libgooey_tpu_torch.effects import compressor as fx_compressor
from libgooey_tpu_torch.effects import delay as fx_delay
from libgooey_tpu_torch.effects import feedback_waveshaper as fx_fbws
from libgooey_tpu_torch.effects import lowpass as fx_lowpass
from libgooey_tpu_torch.effects import reverb_plate as fx_plate
from libgooey_tpu_torch.effects import reverb_spring as fx_spring
from libgooey_tpu_torch.effects import saturation as fx_saturation
from libgooey_tpu_torch.effects import tilt as fx_tilt
from libgooey_tpu_torch.effects import waveshaper as fx_ws
from libgooey_tpu_torch.ops.oversample import OversamplerState

# EFFECT_* ids (ffi.rs:1548-1579)
EFFECT_LOWPASS_FILTER = 0
EFFECT_DELAY = 1
EFFECT_SATURATION = 2
EFFECT_COMPRESSOR = 3
EFFECT_TILT_FILTER = 4
EFFECT_LIMITER = 5
EFFECT_REVERB = 6
EFFECT_WAVESHAPER = 7
EFFECT_FEEDBACK_WAVESHAPER = 8
EFFECT_PLATE_REVERB = 9
REORDERABLE_EFFECT_COUNT = 9

#: effect id -> the module whose ``prepare`` gives its phases in a run
#: (pallas_chain._BUILDERS)
_MERGEABLE = {
    EFFECT_LOWPASS_FILTER: fx_lowpass,
    EFFECT_DELAY: fx_delay,
    EFFECT_SATURATION: fx_saturation,
    EFFECT_COMPRESSOR: fx_compressor,
    EFFECT_TILT_FILTER: fx_tilt,
    EFFECT_REVERB: fx_spring,
    EFFECT_WAVESHAPER: fx_ws,
    EFFECT_FEEDBACK_WAVESHAPER: fx_fbws,
}


def _default_targets(effect_id: int, bpm: float):
    """from_id defaults (effect_chain.rs:57-108)."""
    if effect_id == EFFECT_LOWPASS_FILTER:
        return np.array([20000.0, 0.0], np.float32)
    if effect_id == EFFECT_DELAY:
        return np.array(
            [fx_delay.timing_to_seconds(fx_delay.TIMING_QUARTER, bpm), 0.3, 0.3, 8000.0],
            np.float32,
        )
    if effect_id == EFFECT_SATURATION:
        return np.array([0.3, 0.4, 0.5], np.float32)
    if effect_id == EFFECT_COMPRESSOR:
        return np.array([-12.0, 4.0, 5.0, 100.0, 0.5], np.float32)
    if effect_id == EFFECT_TILT_FILTER:
        return np.array([0.5, 0.0], np.float32)
    if effect_id == EFFECT_REVERB:
        return np.array([0.5, 0.3, 0.5], np.float32)
    if effect_id == EFFECT_PLATE_REVERB:
        return np.array([0.5, 0.3, 0.5, 0.0, 1.0, 0.5], np.float32)
    if effect_id == EFFECT_WAVESHAPER:
        return np.array([1.0, 0.0], np.float32)
    if effect_id == EFFECT_FEEDBACK_WAVESHAPER:
        return np.array([1.0, 0.0, 2000.0, 0.0], np.float32)
    return None


def _init_device_state(effect_id: int, sample_rate: float, device):
    if effect_id == EFFECT_LOWPASS_FILTER:
        return fx_lowpass.init_state(sample_rate, 20000.0, 0.0, device=device)
    if effect_id == EFFECT_DELAY:
        return fx_delay.init_state(sample_rate, 0.5, 0.3, 0.3, 8000.0, device=device)
    if effect_id == EFFECT_SATURATION:
        return fx_saturation.init_state(sample_rate, 0.3, 0.4, 0.5, device=device)
    if effect_id == EFFECT_COMPRESSOR:
        return fx_compressor.init_state(sample_rate, -12.0, 4.0, 5.0, 100.0, 0.5, device=device)
    if effect_id == EFFECT_TILT_FILTER:
        return fx_tilt.init_state(sample_rate, device=device)
    if effect_id == EFFECT_REVERB:
        return fx_spring.init_state(sample_rate, 0.5, 0.3, 0.5, device=device)
    if effect_id == EFFECT_PLATE_REVERB:
        return fx_plate.init_state(sample_rate, 0.5, 0.3, 0.5, device=device)
    if effect_id == EFFECT_WAVESHAPER:
        return OversamplerState.init(2, device)   # the 4x nonlinearity's history
    if effect_id == EFFECT_FEEDBACK_WAVESHAPER:
        return fx_fbws.FBShaperState.init((2,), device)
    return None


class Entry:
    def __init__(self, effect_id: int, sample_rate: float, bpm: float):
        self.effect_id = effect_id
        self.targets = _default_targets(effect_id, bpm)
        self.pingpong = False
        self.timing = fx_delay.TIMING_QUARTER
        self.bpm = bpm

    def set_param(self, param: int, value: float):
        """PARAM_* dispatch (effect_chain.rs:156-230, ffi.rs:1582-1730)."""
        if self.effect_id == EFFECT_DELAY:
            if param == 0:      # DELAY_PARAM_TIMING
                self.timing = int(value)
                self.targets[0] = fx_delay.timing_to_seconds(self.timing, self.bpm)
            elif param == 4:    # DELAY_PARAM_PINGPONG
                self.pingpong = value >= 0.5
            else:
                self.targets[param] = value
        else:
            self.targets[param] = value

    def get_param(self, param: int) -> float:
        if self.effect_id == EFFECT_DELAY:
            if param == 0:
                return float(self.timing)
            if param == 4:
                return 1.0 if self.pingpong else 0.0
        return float(self.targets[param])

    def set_bpm(self, bpm: float):
        self.bpm = bpm
        if self.effect_id == EFFECT_DELAY:
            self.targets[0] = fx_delay.timing_to_seconds(self.timing, bpm)


def process_entry(effect_id: int, state, x, targets, *, sample_rate: float,
                  pingpong: bool = False, sidechain=None):
    """Run one chain entry on a stereo block -> ``(new_state, y)``.

    ``pingpong`` is the entry's static flag: ping-pong mode for the delay,
    the zero-feedback fast path for the feedback waveshaper (see
    ``EffectChain.static_key``)."""
    if effect_id == EFFECT_LOWPASS_FILTER:
        return fx_lowpass.process_block(state, x, targets, sample_rate=sample_rate)
    if effect_id == EFFECT_DELAY:
        return fx_delay.process_block(state, x, targets, sample_rate=sample_rate,
                                      pingpong=pingpong)
    if effect_id == EFFECT_SATURATION:
        return fx_saturation.process_block(state, x, targets, sample_rate=sample_rate)
    if effect_id == EFFECT_COMPRESSOR:
        return fx_compressor.process_block(state, x, targets, sample_rate=sample_rate,
                                           sidechain=sidechain)
    if effect_id == EFFECT_TILT_FILTER:
        return fx_tilt.process_block(state, x, targets, sample_rate=sample_rate)
    if effect_id == EFFECT_REVERB:
        return fx_spring.process_block(state, x, targets, sample_rate=sample_rate)
    if effect_id == EFFECT_PLATE_REVERB:
        return fx_plate.process_block(state, x, targets, sample_rate=sample_rate)
    if effect_id == EFFECT_WAVESHAPER:
        # the history holds over a bypassed block (waveshaper.rs:55-57)
        return fx_ws.process(state, x, targets)
    if effect_id == EFFECT_FEEDBACK_WAVESHAPER:
        if pingpong:
            return fx_fbws.process_bus(state, x, targets, sample_rate=sample_rate)
        t = torch.as_tensor(targets, dtype=torch.float32, device=x.device)
        return fx_fbws.process_block(state, x, t[0], t[1], fx_fbws.filter_coeff(t[2], sample_rate),
                                     t[3], sample_rate, feedback_path=True)
    raise KeyError(effect_id)


def mergeable(effect_id: int, flag: bool) -> bool:
    """Whether an entry joins a run (pallas_chain.mergeable): all but the
    plate, and the feedback waveshaper only on its zero-feedback path."""
    if effect_id == EFFECT_FEEDBACK_WAVESHAPER and not flag:
        return False
    return effect_id in _MERGEABLE


class EffectChain:
    """Host chain: ordered entries + device states, add/remove/move/clear."""

    def __init__(self, sample_rate: float, bpm: float = 120.0, *, device):
        self.sample_rate = sample_rate
        self.bpm = bpm
        self.device = device
        self.entries: List[Entry] = []
        self.states: List = []

    def order(self):
        return tuple(e.effect_id for e in self.entries)

    def add(self, effect_id: int) -> bool:
        if _default_targets(effect_id, self.bpm) is None:
            return False
        self.entries.append(Entry(effect_id, self.sample_rate, self.bpm))
        self.states.append(_init_device_state(effect_id, self.sample_rate, self.device))
        return True

    def remove(self, index: int) -> bool:
        if not 0 <= index < len(self.entries):
            return False
        self.entries.pop(index)
        self.states.pop(index)
        return True

    def move(self, src: int, dst: int) -> bool:
        n = len(self.entries)
        if not (0 <= src < n and 0 <= dst < n):
            return False
        self.entries.insert(dst, self.entries.pop(src))
        self.states.insert(dst, self.states.pop(src))
        return True

    def clear(self):
        self.entries.clear()
        self.states.clear()

    def reset(self):
        """Re-init all device states (the reference's reset clears DSP history)."""
        self.states = [_init_device_state(e.effect_id, self.sample_rate, self.device)
                       for e in self.entries]

    def set_bpm(self, bpm: float):
        self.bpm = bpm
        for e in self.entries:
            e.set_bpm(bpm)

    def set_param(self, index: int, param: int, value: float) -> bool:
        if not 0 <= index < len(self.entries):
            return False
        self.entries[index].set_param(param, value)
        return True

    def get_param(self, index: int, param: int) -> float:
        return self.entries[index].get_param(param)

    def targets_list(self):
        """Each entry's staged targets, a float32 numpy copy."""
        return [np.array(e.targets, np.float32) for e in self.entries]

    def static_key(self):
        """Static ``(effect_id, flag)`` pairs (``entry_flag``)."""
        return tuple((e.effect_id, entry_flag(e)) for e in self.entries)


def entry_flag(e: Entry) -> bool:
    """An entry's static flag: the delay's ping-pong mode, or the feedback
    waveshaper's zero-feedback fast path (every factory preset ships
    feedback 0)."""
    if e.effect_id == EFFECT_DELAY:
        return bool(e.pingpong)
    if e.effect_id == EFFECT_FEEDBACK_WAVESHAPER:
        return float(e.targets[1]) == 0.0
    return False


def process_chain(states, x, targets_list, static_key, *, sample_rate: float,
                  fuse_runs: bool = True):
    """Fold a stereo block ``x`` [2, B] through the chain -> ``(new_states,
    y)``.  Maximal runs of two or more mergeable entries are one
    ``bus_chain`` launch each; the plate and a general-feedback feedback
    waveshaper split the chain into runs."""
    new_states = []
    i, n = 0, len(static_key)
    while i < n:
        j = i
        while fuse_runs and j < n and mergeable(*static_key[j]):
            j += 1
        if j - i >= 2:
            run = static_key[i:j]
            sts, x = fx_chain.process_run(
                [_MERGEABLE[eid] for eid, _ in run], list(states[i:j]), x, list(targets_list[i:j]),
                sample_rate=sample_rate,
                options=[{"pingpong": flag} if eid == EFFECT_DELAY else {} for eid, flag in run])
            new_states.extend(sts)
            i = j
            continue
        eid, flag = static_key[i]
        st, x = process_entry(eid, states[i], x, targets_list[i], sample_rate=sample_rate,
                              pingpong=flag)
        new_states.append(st)
        i += 1
    return new_states, x
