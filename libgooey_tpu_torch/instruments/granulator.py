"""Granulator: Arbhar-inspired frozen-scan granular instrument
(port of libgooey_tpu/instruments/granulator.py).

Behavioral reference: src/instruments/granulator.rs (1,154 LoC).

* pool of 64 grains + 16-slot release pool for soft-stolen grains (~4 ms
  fade, granulator.rs:13-25);
* spawn scheduler at ``density`` grains/s with zero-mean timing jitter
  (rs:508-539); per grain: source pos = scan*len ± spray (cubic-interp
  read), direction probability, speed = pitch_ratio * buf_sr/sr (exp map
  0.25-4x), raised-sine window shaped by texture, random amp (rs:541-610);
  edge-safe duration clamping (rs:584-600);
* 1/sqrt(active) gain compensation smoothed 10 ms (rs:652-660);
* drive = fixed-4x Waveshaper with mix as the knob (rs:26-32, 730-739);
* cloud trigger with duration 50-8000 ms; deterministic XorShift32 + set_seed.

All randomness happens at grain spawn (control rate): ``GranulatorHost``
schedules spawns and steals on the host (same XorShift32, same draw order)
as per-block ``SpawnEvents`` of numpy arrays, and each grain's audio is a
pure function of samples-since-spawn.  ``render_block`` runs on the device
of the state, one lane per grain, whatever the lane count (the 4,000-lane
bench is one state): the grain reads in ``grain_read_cubic``
(ops/grain_kernels.py), the 1/sqrt(N) compensation through ``ops/scan``'s
first-order recurrence (``affine1_bank``, one row), the drive's
``tanh(4v)*tanh(.5)/tanh(2)`` at 4x in ``ws4_bank`` (one row, drive 4).
Block starts are host integers and events stay on the host, so a block
reads nothing back from the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from libgooey_tpu_torch.core.rng import XorShift32
from libgooey_tpu_torch.core.smoother import (
    SmootherBank,
    _q,
    pow_table,
    settle_snap,
    smoothing_coeff,
)
from libgooey_tpu_torch.ops import bank_kernels, grain_kernels
from libgooey_tpu_torch.ops import scan as tscan
from libgooey_tpu_torch.ops.grain_kernels import wrap_i32
from libgooey_tpu_torch.ops.oversample import HalfbandState, OversamplerState

MAX_GRAINS = 64
RELEASE_POOL = 16
STEAL_RELEASE_MS = 4.0
DRIVE_INTERNAL = 4.0
MIN_GRAIN_MS, MAX_GRAIN_MS = 5.0, 3000.0
MAX_SPRAY_SECS = 10.0
MIN_CLOUD_MS, MAX_CLOUD_MS = 50.0, 8000.0
MAX_DENSITY = 80.0
MIN_PITCH, MAX_PITCH = 0.25, 4.0
MAX_SPAWNS_PER_BLOCK = 16

PARAM_NAMES = (
    "scan_position", "grain_length", "spray", "pitch", "density", "texture",
    "direction", "cloud_duration", "volume", "random_timing", "random_amp",
    "drive",
)
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}


def grain_length_ms(v):
    v = np.clip(v, 0.0, 1.0)
    return MIN_GRAIN_MS + v * v * (MAX_GRAIN_MS - MIN_GRAIN_MS)


def spray_seconds(v):
    v = np.clip(v, 0.0, 1.0)
    return v**3 * MAX_SPRAY_SECS


def pitch_ratio(v):
    v = np.clip(v, 0.0, 1.0)
    return MIN_PITCH * (MAX_PITCH / MIN_PITCH) ** v


def density_gps(v):
    return float(np.clip(v, 0.0, 1.0) * MAX_DENSITY)


def cloud_duration_ms(v):
    v = np.clip(v, 0.0, 1.0)
    return MIN_CLOUD_MS + v * (MAX_CLOUD_MS - MIN_CLOUD_MS)


def window_shape(texture):
    """Texture 0-1 → window power 0.5-4 (granulator.rs window_shape map)."""
    v = float(np.clip(texture, 0.0, 1.0))
    return 0.5 + v * 3.5


@dataclass(frozen=True)
class GranulatorConfig:
    scan_position: float = 0.5
    grain_length: float = 0.16
    spray: float = 0.12
    pitch: float = 0.5
    density: float = 0.35
    texture: float = 0.25
    direction: float = 0.0
    cloud_duration: float = 0.35
    volume: float = 0.8
    random_timing: float = 0.0
    random_amp: float = 0.0
    drive: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.clip(
            np.array([getattr(self, n) for n in PARAM_NAMES], np.float32), 0.0, 1.0
        )


PRESETS = {"default": GranulatorConfig}

TOTAL = MAX_GRAINS + RELEASE_POOL


class GrainState(NamedTuple):
    """Device grain lanes: [lanes] each (main pool then release pool;
    ``TOTAL`` lanes for one instrument)."""

    params: SmootherBank        # [NUM_PARAMS] (single instance)
    spawn_sample: torch.Tensor  # [lanes] i32
    duration: torch.Tensor      # [lanes] samples
    src_pos: torch.Tensor       # [lanes] start position (buffer samples)
    step: torch.Tensor          # [lanes] speed*direction per engine sample
    shape: torch.Tensor         # [lanes] window power
    vel: torch.Tensor           # [lanes] velocity*amp_factor
    rel_start: torch.Tensor     # [lanes] i32 release fade start (main: -1)
    rel_total: torch.Tensor     # [lanes] fade length in samples (0 = none)
    gain_comp: torch.Tensor     # scalar smoothed 1/sqrt(N)
    buffer: torch.Tensor        # [L] mono source
    buffer_sr: torch.Tensor     # scalar
    ovs: OversamplerState       # drive waveshaper 4x oversampler (batch ())


#: the lane fields a spawn writes and a steal copies
_GRAIN_FIELDS = ("spawn_sample", "duration", "src_pos", "step", "shape", "vel")


class SpawnEvents(NamedTuple):
    """Per-block grain lifecycle events (host-computed, rs:541-610), numpy
    arrays of ``MAX_SPAWNS_PER_BLOCK`` entries."""

    slot: np.ndarray        # [K] lane index (-1 = unused); release-pool
    offset: np.ndarray      # [K] sample offset in block
    duration: np.ndarray    # [K]
    src_pos: np.ndarray     # [K]
    step: np.ndarray        # [K]
    shape: np.ndarray       # [K]
    vel: np.ndarray         # [K]
    rel_total: np.ndarray   # [K] (>0 for steals moved into the release pool)
    copy_from: np.ndarray   # [K] main lane to copy when stealing (-1 = spawn)

    @staticmethod
    def empty() -> "SpawnEvents":
        K = MAX_SPAWNS_PER_BLOCK

        def z(dt, fill=0):
            return np.full(K, fill, dt)

        return SpawnEvents(
            slot=z(np.int32, -1), offset=z(np.int32), duration=z(np.float32, 1),
            src_pos=z(np.float32), step=z(np.float32), shape=z(np.float32, 2),
            vel=z(np.float32), rel_total=z(np.float32), copy_from=z(np.int32, -1),
        )


def init_state(buffer, buffer_sr: float, config: Optional[GranulatorConfig] = None, *,
               device) -> GrainState:
    cfg = (config or GranulatorConfig()).as_array()

    def z(fill=0.0, dtype=torch.float32):
        return torch.full((TOTAL,), fill, dtype=dtype, device=device)

    return GrainState(
        params=SmootherBank.init(cfg, device),
        ovs=OversamplerState.init((), device),
        spawn_sample=z(-(2**30), torch.int32),
        duration=z(1.0),
        src_pos=z(),
        step=z(1.0),
        shape=z(2.0),
        vel=z(),
        rel_start=z(-1, torch.int32),
        rel_total=z(),
        gain_comp=torch.ones((), dtype=torch.float32, device=device),
        buffer=torch.as_tensor(buffer, dtype=torch.float32, device=device),
        buffer_sr=torch.tensor(float(np.float32(buffer_sr)), dtype=torch.float32, device=device),
    )


def _event_writes(ev: dict, used, total: int) -> list:
    """Each used event's write in order, ``(target lane, root, steal?,
    offset, rel_total)``, ``root`` being where its six ``_GRAIN_FIELDS``
    come from: ``("spawn", k)`` for spawn k's values, or a lane as the block
    found it, an int; a steal's copy is followed back through the events
    before it (a lane written earlier in the block is never a root)."""
    last, writes = {}, []
    for k in used:
        tgt, src = int(ev["slot"][k]), int(ev["copy_from"][k])
        if tgt >= total or src >= total:
            raise ValueError(f"granulator event {k}: lane {max(tgt, src)} of {total}")
        root = last.get(src, src) if src >= 0 else ("spawn", k)
        last[tgt] = root
        writes.append((tgt, root, src >= 0, int(ev["offset"][k]), float(ev["rel_total"][k])))
    return writes


def _fetch_lanes(st: GrainState, lanes: list, lo: int, mesh) -> torch.Tensor:
    """The six ``_GRAIN_FIELDS`` of global ``lanes`` as the block found
    them, ``[len(lanes), 6]`` float64 on every rank of ``mesh``: the owning
    rank contributes each row and the others -0.0, whose sum keeps every
    bit (float64 holds the int32 spawn sample exactly), in one all-reduce."""
    n = st.spawn_sample.shape[0]
    buf = torch.full((len(lanes), len(_GRAIN_FIELDS)), -0.0, dtype=torch.float64,
                     device=st.src_pos.device)
    for i, lane in enumerate(lanes):
        if lo <= lane < lo + n:
            buf[i] = torch.stack([getattr(st, f)[lane - lo].to(torch.float64)
                                  for f in _GRAIN_FIELDS])
    return mesh.all_reduce(buf)


def apply_events(st: GrainState, events: SpawnEvents, block_start: int, mesh=None) -> GrainState:
    """Apply a block's spawns and steals in order (granulator.py:198-236):
    a steal copies its victim's lane as the events before it left it, and
    starts its release fade at the event's offset.  Unused entries (slot -1)
    are skipped on the host; the state's tensors are not modified in
    place.  Host values are written by ``fill_`` (a kernel argument; an
    assignment would be a blocking copy from the host on the card).

    With ``mesh`` (a ``parallel.mesh.Mesh``), ``st`` holds this rank's
    contiguous lanes and the events' lane ids are global: the rank applies
    the events whose target it holds, and a steal whose victim lies on
    another rank takes the victim's fields through one all-reduce a block
    (only in blocks that hold such a steal; the host sees which)."""
    ev = {f: np.asarray(getattr(events, f)) for f in SpawnEvents._fields}
    used = [k for k in range(ev["slot"].shape[0]) if ev["slot"][k] >= 0]
    if not used:
        return st
    n = st.spawn_sample.shape[0]
    lo, size = (0, 1) if mesh is None else (mesh.rank * n, mesh.size)
    writes = _event_writes(ev, used, n * size)
    cross = sorted({root for tgt, root, _, _, _ in writes
                    if isinstance(root, int) and root // n != tgt // n})
    fetched = _fetch_lanes(st, cross, lo, mesh) if cross else None
    arrs = {f: getattr(st, f).clone() for f in _GRAIN_FIELDS + ("rel_start", "rel_total")}
    for tgt, root, steal, offset, rel_total in writes:
        if not lo <= tgt < lo + n:
            continue
        tgt -= lo
        if isinstance(root, tuple):
            k = root[1]
            arrs["spawn_sample"][tgt].fill_(wrap_i32(block_start + int(ev["offset"][k])))
            for f in _GRAIN_FIELDS[1:]:
                arrs[f][tgt].fill_(float(ev[f][k]))
        elif lo <= root < lo + n:
            for f in _GRAIN_FIELDS:
                arrs[f][tgt] = getattr(st, f)[root - lo]
        else:
            row = fetched[cross.index(root)]
            for j, f in enumerate(_GRAIN_FIELDS):
                arrs[f][tgt] = row[j]
        arrs["rel_start"][tgt].fill_(wrap_i32(block_start + offset) if steal else -1)
        arrs["rel_total"][tgt].fill_(rel_total if steal else 0.0)
    return st._replace(**arrs)


def _batch1(ovs: OversamplerState) -> OversamplerState:
    """The batch-() oversampler state as one bank row."""
    return OversamplerState(*(HalfbandState(*(t[None] for t in hb)) for hb in ovs))


def _unbatch1(ovs: OversamplerState) -> OversamplerState:
    return OversamplerState(*(HalfbandState(*(t[0] for t in hb)) for hb in ovs))


def render_block(
    state: GrainState,
    events: SpawnEvents,
    block_start: int,
    *,
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    overrides=None,
    mesh=None,
):
    """Render one block → ``(new_state, out[B])`` (mono instrument).

    ``block_start`` is the block's first sample as a host integer;
    ``overrides`` maps a parameter name to its ``[B]`` trajectory (as the
    JAX package's LFO routes pass them).  The JAX package's ``grain_read``
    choice has no counterpart: the read is always ``grain_read_cubic``,
    whose semantics are the gather path's.  ``mesh`` (a
    ``parallel.mesh.Mesh``): ``state`` holds this rank's lanes
    (``parallel.mesh.shard_rack_state``), events keep global lane ids
    (:func:`apply_events`), and the lane sums ``raw`` and ``count`` are
    summed over the group in one ``[2, B]`` all-reduce, so the
    compensation, the drive and the volume run replicated and every rank
    returns the same ``out``."""
    B = block_size
    block_start = int(block_start)
    st = apply_events(state, events, block_start, mesh)
    dev = st.src_pos.device
    n_local = torch.arange(B, dtype=torch.int32, device=dev)
    bs = wrap_i32(block_start)

    # ages as int32 (block_start + n - spawn, wrapping), rounded once
    age0 = bs - st.spawn_sample
    age = (age0[:, None] + n_local[None, :]).to(torch.float32)
    in_life = (age >= 0.0) & (age < st.duration[:, None])

    # release fade (soft-stolen grains): gain ramps 1→0 over rel_total
    rel_age = ((bs - st.rel_start)[:, None] + n_local[None, :]).to(torch.float32)
    rel_total = st.rel_total[:, None]
    rel_gain = torch.where(
        (st.rel_start >= 0)[:, None] & (rel_total > 0),
        torch.clamp(1.0 - rel_age / torch.clamp(rel_total, min=1.0), 0.0, 1.0),
        1.0,
    )
    active = in_life & (rel_gain > 0.0)

    # window + cubic buffer read
    phase = torch.clamp(age / torch.clamp(st.duration[:, None], min=1.0), 0.0, 1.0)
    window = torch.pow(torch.clamp(torch.sin(math.pi * phase), min=0.0), st.shape[:, None])
    sample = grain_kernels.grain_read_cubic(st.buffer, st.src_pos, st.step, B=B, age0=age0)

    contrib = torch.where(active, sample * window * rel_gain * st.vel[:, None], 0.0)
    raw = torch.sum(contrib, dim=0)                       # [B]

    # --- 1/sqrt(N) gain compensation, 10 ms one-pole (rs:652-660) ------------
    count = torch.sum(active, dim=0).to(torch.float32)
    if mesh is not None:
        # the cross-lane seams (granulator.py:289,292): one [2, B] sum
        raw, count = mesh.all_reduce(torch.stack([raw, count]))
    comp_target = torch.where(
        count > 0, torch.ones_like(count) / torch.sqrt(torch.clamp(count, min=1.0)), 1.0)
    comp_coeff = smoothing_coeff(sample_rate, 10.0)
    comp = tscan.linrec1(torch.full_like(comp_target, _q(comp_coeff)),
                         float(np.float32(comp_coeff)) * comp_target, state.gain_comp)
    raw = raw * comp

    # --- drive (fixed 4x waveshaper, mix = drive knob) + volume ----------------
    powers = pow_table(float(np.float32(1.0 - smooth_coeff)), B, dev)

    def ptraj(name):
        if overrides and name in overrides:
            return overrides[name]
        idx = PARAM_INDEX[name]
        tgt = state.params.target[idx]
        return tgt + settle_snap((state.params.current[idx] - tgt) * powers)

    mix = ptraj("drive")
    ovs1 = _batch1(state.ovs)
    shaped, nst = bank_kernels.ws4_bank(
        raw[None].contiguous(), torch.full((1, B), DRIVE_INTERNAL, device=dev),
        bank_kernels.pack_ws4_bank(ovs1))
    new_ovs = _unbatch1(bank_kernels.unpack_ws4_bank(nst, ovs1))
    driven = torch.where(mix <= 1e-4, raw, raw * (1.0 - mix) + shaped[0] * mix)
    out = driven * ptraj("volume")

    q = float(np.float32(1.0 - smooth_coeff) ** np.float32(B))
    dec = (state.params.current - state.params.target) * q
    new_params = SmootherBank(current=state.params.target + settle_snap(dec),
                              target=state.params.target)
    new_state = st._replace(params=new_params, gain_comp=comp[-1], ovs=new_ovs)
    return new_state, out


class GranulatorHost:
    """Host-side spawn scheduler: exact reference control logic (rs:508-676).

    Mirrors the grain pool allocation, soft-steal policy, XorShift32 draw
    order, and cloud timing; emits numpy SpawnEvents per block.
    """

    def __init__(self, sample_rate: float, buffer: np.ndarray, buffer_sr: float,
                 config: Optional[GranulatorConfig] = None, seed: int = 0x12345678):
        self.sr = sample_rate
        self.buffer_len = len(buffer)
        self.buffer_sr = buffer_sr
        self.cfg = dict(zip(PARAM_NAMES, (config or GranulatorConfig()).as_array()))
        self.rng = XorShift32(seed)
        self.cloud_active = False
        self.cloud_end = 0.0
        self.next_grain_time = 0.0
        self.velocity = 1.0
        # host mirror of grain lifetimes: (end_sample) per lane
        self.main_end = np.zeros(MAX_GRAINS, np.int64)
        self.main_spawn = np.full(MAX_GRAINS, -(2**60), np.int64)
        self.main_dur = np.zeros(MAX_GRAINS, np.float64)
        self.rel_end = np.zeros(RELEASE_POOL, np.int64)

    def set_seed(self, seed: int):
        self.rng = XorShift32(seed)

    def set_param(self, name: str, value: float):
        self.cfg[name] = float(np.clip(value, 0.0, 1.0))

    def trigger(self, time_s: float, velocity: float = 1.0):
        self.velocity = float(np.clip(velocity, 0.0, 1.0))
        self.cloud_active = True
        self.cloud_end = time_s + cloud_duration_ms(self.cfg["cloud_duration"]) * 0.001
        self.next_grain_time = time_s

    def active_grain_count(self, now: int) -> int:
        return int((self.main_end > now).sum() + (self.rel_end > now).sum())

    def collect_events(self, block_start: int, block_size: int) -> SpawnEvents:
        """This block's spawns and steals, as numpy arrays (the JAX host's
        ``collect_events(..., device=False)``)."""
        ev = SpawnEvents.empty()._asdict()
        ev["step"][:] = 1.0   # the host's unused entries carry step 1 (SpawnEvents.empty 0)
        k = 0
        if self.cloud_active:
            density = density_gps(self.cfg["density"])
            if density > 0:
                interval = 1.0 / density
                jitter_amt = float(np.clip(self.cfg["random_timing"], 0.0, 1.0))
                for n in range(block_size):
                    t = (block_start + n) / self.sr
                    if t > self.cloud_end:
                        self.cloud_active = False
                        break
                    guard = 0
                    while (self.cloud_active and t + 1e-12 >= self.next_grain_time
                           and guard < 8 and k < MAX_SPAWNS_PER_BLOCK - 1):
                        k = self._spawn(ev, k, block_start + n, n)
                        self.next_grain_time += interval
                        if jitter_amt > 0.0:
                            j = (self.rng.next_f32() * 2.0 - 1.0) * interval * jitter_amt
                            self.next_grain_time = max(self.next_grain_time + j, t)
                        if self.next_grain_time > self.cloud_end:
                            self.cloud_active = False
                        guard += 1
        return SpawnEvents(**ev)

    def _spawn(self, ev, k, now: int, offset: int) -> int:
        amp_jitter = self.rng.next_f32()  # pre-rolled (rs:548-550)

        free = np.nonzero(self.main_end <= now)[0]
        if len(free) == 0:
            # soft-steal: shortest remaining main grain → release pool
            remaining = self.main_end - now
            victim = int(np.argmin(remaining))
            rel_free = np.nonzero(self.rel_end <= now)[0]
            if len(rel_free) == 0:
                return k  # drop this spawn
            rel_slot = int(rel_free[0])
            release = max(STEAL_RELEASE_MS * 0.001 * self.sr, 1.0)
            release = min(release, max(float(self.main_end[victim] - now), 1.0))
            ev["slot"][k] = MAX_GRAINS + rel_slot
            ev["offset"][k] = offset
            ev["rel_total"][k] = release
            ev["copy_from"][k] = victim
            self.rel_end[rel_slot] = now + int(release) + 1
            self.main_end[victim] = now  # freed
            k += 1
            if k >= MAX_SPAWNS_PER_BLOCK:
                return k
            free = np.array([victim])
        slot = int(free[0])

        last = float(self.buffer_len - 1)
        scan = float(np.clip(self.cfg["scan_position"], 0, 1)) * last
        spray = spray_seconds(self.cfg["spray"]) * self.buffer_sr
        spray_off = (self.rng.next_f32() * 2.0 - 1.0) * spray
        requested = float(np.clip(scan + spray_off, 0.0, last))
        direction = -1.0 if self.rng.next_f32() < self.cfg["direction"] else 1.0
        speed = pitch_ratio(self.cfg["pitch"]) * (self.buffer_sr / self.sr)
        dur = max(grain_length_ms(self.cfg["grain_length"]) * 0.001 * self.sr, 1.0)
        shape = window_shape(self.cfg["texture"])
        travel = dur * speed
        if travel >= last:
            dur = max(last / speed, 1.0)
            src = last if direction < 0 else 0.0
        elif direction < 0:
            src = float(np.clip(requested, travel, last))
        else:
            src = float(np.clip(requested, 0.0, last - travel))
        amp_factor = 1.0 - float(np.clip(self.cfg["random_amp"], 0, 1)) * amp_jitter

        ev["slot"][k] = slot
        ev["offset"][k] = offset
        ev["duration"][k] = dur
        ev["src_pos"][k] = src
        ev["step"][k] = speed * direction
        ev["shape"][k] = shape
        ev["vel"][k] = self.velocity * amp_factor
        self.main_spawn[slot] = now
        self.main_dur[slot] = dur
        self.main_end[slot] = now + int(dur)
        return k + 1
