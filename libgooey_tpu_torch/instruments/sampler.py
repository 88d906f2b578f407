"""SamplerRack: 16 sample pads × 32 voices with an embedded step sequencer
(port of libgooey_tpu/instruments/sampler.py).

Behavioral reference: src/instruments/sampler.rs (356 LoC).

* slots hold PCM (1-2 ch, any sample rate); voices play them once at
  ``buffer_sr / engine_sr`` increment with linear interpolation
  (sampler.rs:62-79, 118);
* fixed 32-frame edge fade click-guard (rs:127-135); oldest-age stealing
  (rs:196-206);
* embedded sequencer whose per-step *note* selects the slot (rs:228-237);
  transport-quantized pattern start via schedule_start/activate_start_if_due
  (rs:252-272).

Slot PCM lives in one device arena ``[A, 2]``; a voice's audio is a pure
function of samples-since-start, so the whole voice pool (any number of
voices: the 4,128-lane bench flattens four racks into one 128-voice state)
renders as one batch of reads in ``sampler_read_linear``
(ops/grain_kernels.py).  The host mirrors voice allocation (it knows every
voice's end sample exactly) and hands each block's starts over as numpy
``StartEvents``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from libgooey_tpu_torch.engine.sequencer import Sequencer
from libgooey_tpu_torch.ops import grain_kernels
from libgooey_tpu_torch.ops.bank_kernels import _div
from libgooey_tpu_torch.ops.grain_kernels import wrap_i32

SLOTS = 16
VOICES = 32
EDGE_FADE = 32.0
MAX_STARTS_PER_BLOCK = 16


class SamplerState(NamedTuple):
    """Device state: arena + per-voice latches ([V] each)."""

    arena: torch.Tensor         # [A, 2] slot PCM, stereo (mono duplicated)
    start_sample: torch.Tensor  # [V] i32 global sample of voice start
    base: torch.Tensor          # [V] i32 arena offset of the slot's first frame
    frames: torch.Tensor        # [V] f32 slot length in frames
    increment: torch.Tensor     # [V] f32 buffer_sr / engine_sr
    velocity: torch.Tensor      # [V]


class StartEvents(NamedTuple):
    """A block's voice starts, numpy arrays of ``MAX_STARTS_PER_BLOCK``."""

    voice: np.ndarray      # [K] lane (-1 unused)
    offset: np.ndarray     # [K]
    base: np.ndarray       # [K]
    frames: np.ndarray     # [K]
    increment: np.ndarray  # [K]
    velocity: np.ndarray   # [K]

    @staticmethod
    def empty() -> "StartEvents":
        K = MAX_STARTS_PER_BLOCK
        return StartEvents(
            voice=np.full(K, -1, np.int32), offset=np.zeros(K, np.int32),
            base=np.zeros(K, np.int32), frames=np.ones(K, np.float32),
            increment=np.ones(K, np.float32), velocity=np.zeros(K, np.float32),
        )


def init_state(arena_frames: int = 1 << 20, *, device) -> SamplerState:
    def full(fill, dtype=torch.float32):
        return torch.full((VOICES,), fill, dtype=dtype, device=device)

    return SamplerState(
        arena=torch.zeros((arena_frames, 2), dtype=torch.float32, device=device),
        start_sample=full(-(2**30), torch.int32),
        base=full(0, torch.int32),
        frames=full(1.0),
        increment=full(1.0),
        velocity=full(0.0),
    )


#: the voice fields a start writes, and the event column of each
_START_FIELDS = (("start_sample", "offset"), ("base", "base"), ("frames", "frames"),
                 ("increment", "increment"), ("velocity", "velocity"))


def apply_events(st: SamplerState, events: StartEvents, block_start: int,
                 mesh=None) -> SamplerState:
    """Latch a block's starts in order (sampler.py:97-109); unused entries
    (voice -1) are skipped on the host, and the state's tensors are not
    modified in place.  Host values are written by ``fill_`` (a kernel
    argument, not a blocking copy from the host on the card).  With
    ``mesh``, ``st`` holds this rank's contiguous voices and the events'
    voice ids are global: the rank latches the starts of its voices."""
    ev = {f: np.asarray(getattr(events, f)) for f in StartEvents._fields}
    used = [k for k in range(ev["voice"].shape[0]) if ev["voice"][k] >= 0]
    if not used:
        return st
    V = st.start_sample.shape[0]
    lo, size = (0, 1) if mesh is None else (mesh.rank * V, mesh.size)
    arrs = {f: getattr(st, f).clone() for f, _ in _START_FIELDS}
    for k in used:
        v = int(ev["voice"][k])
        if v >= V * size:
            raise ValueError(f"sampler event {k}: voice {v} of {V * size}")
        if not lo <= v < lo + V:
            continue
        v -= lo
        arrs["start_sample"][v].fill_(wrap_i32(block_start + int(ev["offset"][k])))
        arrs["base"][v].fill_(int(ev["base"][k]))
        for f, col in _START_FIELDS[2:]:
            arrs[f][v].fill_(float(ev[col][k]))
    return st._replace(**arrs)


def render_block(
    state: SamplerState,
    events: StartEvents,
    block_start: int,
    *,
    sample_rate: float,
    block_size: int,
    mesh=None,
):
    """Render one block → ``(new_state, out[2, B])``; ``block_start`` is a
    host integer.  The JAX package's ``voice_read`` choice has no
    counterpart: the read is always ``sampler_read_linear``, whose semantics
    are the gather path's.  ``mesh`` (a ``parallel.mesh.Mesh``): ``state``
    holds this rank's voices (``parallel.mesh.shard_rack_state``), starts
    keep global voice ids, and ``out`` is summed over the group in one
    ``[2, B]`` all-reduce, the same on every rank."""
    del sample_rate
    B = block_size
    block_start = int(block_start)
    st = apply_events(state, events, block_start, mesh)
    n_local = torch.arange(B, dtype=torch.int32, device=st.arena.device)
    start, inc, vel = st.start_sample, st.increment, st.velocity

    age = ((n_local + wrap_i32(block_start))[None, :] - start[:, None]).to(torch.float32)
    pos = age * inc[:, None]
    end = st.frames[:, None]
    active = (age >= 0.0) & (pos < end)

    # linear-interp stereo read (sampler.rs frame()) with position clamp
    posc = torch.minimum(torch.clamp(pos, min=0.0), end - 1.0)
    frame = grain_kernels.sampler_read_linear(st.arena, st.base, st.frames, start, inc,
                                              block_start, B=B)

    # 32-frame edge fade click-guard (rs:127-135)
    gain = torch.clamp(
        torch.minimum(_div(posc, EDGE_FADE), torch.clamp(_div(end - posc, EDGE_FADE), min=0.0)),
        max=1.0,
    ) * vel[:, None]
    contrib = torch.where(active[..., None], frame * gain[..., None], 0.0)
    out = torch.sum(contrib, dim=0).T                                 # [2, B]
    if mesh is not None:
        out = mesh.all_reduce(out.contiguous())          # the voice sum (sampler.py:149)
    return st, out


class SamplerRackHost:
    """Host control: slot storage layout, voice stealing, embedded sequencer."""

    def __init__(self, sample_rate: float, bpm: float, name: str = "rack",
                 arena_frames: int = 1 << 20):
        self.sr = sample_rate
        self.name = name
        self.arena_frames = arena_frames
        self.arena = np.zeros((arena_frames, 2), np.float32)
        self.slot_meta: List[Optional[Tuple[int, int, float]]] = [None] * SLOTS
        self._next_free = 0
        self.arena_dirty = True
        self.voice_end = np.zeros(VOICES, np.int64)
        self.voice_age = np.zeros(VOICES, np.int64)
        self._age = 0
        self.sequencer = Sequencer(bpm, sample_rate, SLOTS, name)
        self.pattern_running = False
        self.pending_start_beat: Optional[float] = None
        self._starts: List[Tuple[int, int, float]] = []  # (slot, offset, vel)

    # --- slots -----------------------------------------------------------------

    def set_buffer(self, slot: int, samples: np.ndarray, sample_rate: float) -> bool:
        """Load PCM into a slot.  ``samples``: [frames] mono or [frames, 2]."""
        if not (0 <= slot < SLOTS):
            return False
        pcm = np.asarray(samples, np.float32)
        if pcm.ndim == 1:
            pcm = np.stack([pcm, pcm], axis=-1)
        frames = pcm.shape[0]
        if self._next_free + frames > self.arena_frames:
            raise RuntimeError("sampler arena full")
        base = self._next_free
        self.arena[base : base + frames] = pcm[:, :2]
        self._next_free += frames
        self.slot_meta[slot] = (base, frames, float(sample_rate))
        self.arena_dirty = True
        return True

    def clear_slot(self, slot: int) -> bool:
        if not (0 <= slot < SLOTS):
            return False
        self.slot_meta[slot] = None
        return True

    # --- triggering ---------------------------------------------------------------

    def trigger(self, slot: int, velocity: float, offset: int = 0) -> bool:
        if not (0 <= slot < SLOTS) or self.slot_meta[slot] is None:
            return False
        self._starts.append((slot, offset, float(np.clip(velocity, 0.0, 1.0))))
        return True

    def set_step(self, step: int, enabled: bool, slot: int, velocity: float) -> bool:
        if step >= SLOTS or slot >= SLOTS:
            return False
        self.sequencer.set_step_with_settings(step, enabled, velocity, note=slot)
        return True

    def schedule_start(self, beat: float) -> bool:
        if not np.isfinite(beat) or beat < 0:
            return False
        self.pattern_running = False
        self.sequencer.stop()
        self.pending_start_beat = float(beat)
        return True

    def activate_start_if_due(self, transport_beat: float):
        if self.pending_start_beat is None:
            return
        if transport_beat + 1e-8 < self.pending_start_beat:
            return
        target = self.pending_start_beat
        self.pending_start_beat = None
        self.sequencer.set_beat_position(target)
        self.sequencer.start()
        self.pattern_running = True

    def stop_pattern(self):
        self.pending_start_beat = None
        self.pattern_running = False
        self.sequencer.stop()
        self.voice_end[:] = 0  # stop_all

    def _allocate(self, now: int) -> int:
        free = np.nonzero(self.voice_end <= now)[0]
        idx = int(free[0]) if len(free) else int(np.argmin(self.voice_age))
        self._age += 1
        self.voice_age[idx] = self._age
        return idx

    def collect_events(self, block_start: int, block_size: int) -> StartEvents:
        """This block's starts, as numpy arrays (the JAX host's
        ``collect_events(..., device=False)``)."""
        if self.pattern_running:
            for trig in self.sequencer.tick_block(block_size):
                slot = trig.note if trig.note is not None else 0
                self.trigger(slot, trig.velocity, trig.offset)

        ev = StartEvents.empty()
        for k, (slot, off, velocity) in enumerate(self._starts[:MAX_STARTS_PER_BLOCK]):
            meta = self.slot_meta[slot]
            if meta is None:
                continue
            b, fr, ssr = meta
            now = block_start + off
            v = self._allocate(now)
            ev.voice[k] = v
            ev.offset[k] = off
            ev.base[k] = b
            ev.frames[k] = fr
            ev.increment[k] = ssr / self.sr
            ev.velocity[k] = velocity
            self.voice_end[v] = now + int(fr / (ssr / self.sr)) + 1
        self._starts.clear()
        return ev
