"""Mixer: 4 loop channels + clip grid, with stem rendering (port of
libgooey_tpu/mixer/mixer.py).

Behavioral reference: src/mixer/mod.rs (655 LoC) — owns the loop channels
and the ClipGrid; `tick()` runs grid.before_tick (transport + scheduled
actions), solo-aware channel gating, the channel sum, grid.after_tick;
propagates BPM to channel effects + grid (rs:80-87); offline single-channel
render with effect-warming preroll (`render_channel_to_interleaved`,
rs:444-476).

Each channel's device buffer is ``[2, 2 * capacity]``: two regions, so a
quantized swap or a clip launch can land mid-block.  A block's read plan
(float64 positions rounded to float32 on the host, weights, lengths,
regions) goes up as one ``[6, B]`` array per channel.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank, smooth_block, smoothing_coeff
from libgooey_tpu_torch.mixer import chain as chain_mod
from libgooey_tpu_torch.mixer.clip_grid import ClipGrid
from libgooey_tpu_torch.mixer.loop_channel import LoopChannelHost
from libgooey_tpu_torch.mixer.stereo_buffer import read_cubic

NUM_CHANNELS = 4  # mixer/mod.rs:31


def pack_plan(pos, weights, region, length) -> np.ndarray:
    """One block's read plan as one float32 ``[6, B]`` array: the two
    position streams (float64 rounded to float32, as ``jnp.asarray``
    rounds them), their weights, the valid length and the region."""
    return np.concatenate([np.asarray(pos, np.float32), weights,
                           np.asarray(length, np.float32)[None],
                           np.asarray(region, np.float32)[None]])


def _dry(buffer, plan, capacity, wrap):
    """The two OLA cubic reads of one block from its ``[6, B]`` plan."""
    base = plan[5].to(torch.int64) * capacity
    length = plan[4]
    return (read_cubic(buffer, plan[0], wrap, length, base) * plan[2][None, :]
            + read_cubic(buffer, plan[1], wrap, length, base) * plan[3][None, :])


def gain_chain(dry, gain_bank, chain_states, chain_targets, *, chain_key,
               sample_rate: float, coeff: float):
    """A channel's block after its reads: gain → chain → active gate.
    ``gain_bank``'s target holds the block's [gain, gate] targets.  Returns
    ``(gain_bank', chain_states', wet [2, B])``."""
    bank, traj = smooth_block(gain_bank, coeff, dry.shape[-1])   # [2, B]: gain, active
    gained = dry * traj[0][None, :]
    new_states, wet = chain_mod.process_chain(
        chain_states, gained, chain_targets, chain_key, sample_rate=sample_rate)
    return bank, tuple(new_states), wet * traj[1][None, :]


def _channel_block(buffer, plan, gain_bank, chain_states, chain_targets, *, capacity: int,
                   wrap: bool, chain_key, sample_rate: float, coeff: float):
    """One loop channel: OLA cubic reads → gain → chain → active gate.

    ``buffer`` holds two capacity regions (active + staged) so a quantized
    swap can land mid-block; the plan's region and length rows locate each
    sample's source."""
    return gain_chain(_dry(buffer, plan, capacity, wrap), gain_bank, chain_states,
                      chain_targets, chain_key=chain_key, sample_rate=sample_rate, coeff=coeff)


def _channel_blocks(buffer, plans, targets_seq, gain_bank, chain_states, chain_targets, *,
                    capacity: int, wrap: bool, chain_key, sample_rate: float, coeff: float):
    """K-block form of :func:`_channel_block` (the JAX package's scan): the
    same per-block math over ``plans [K, 6, B]`` and ``targets_seq [K,
    2]``.  Returns ``(gain_bank', chain_states', wet[K, 2, B])``."""
    bank, states = gain_bank, tuple(chain_states)
    wets = []
    for k in range(plans.shape[0]):
        bank = SmootherBank(current=bank.current, target=targets_seq[k])
        bank, states, wet = _channel_block(
            buffer, plans[k], bank, states, chain_targets, capacity=capacity, wrap=wrap,
            chain_key=chain_key, sample_rate=sample_rate, coeff=coeff)
        wets.append(wet)
    return bank, states, torch.stack(wets)


class Mixer:
    def __init__(self, sample_rate: float, bpm: float = 120.0,
                 block_size: int = 512, buffer_capacity: int = 1 << 21, *, device):
        self.sr = sample_rate
        self.block = block_size
        self.bpm = bpm
        self.device = device
        self.channels: List[LoopChannelHost] = [
            LoopChannelHost(sample_rate, buffer_capacity, device=device)
            for _ in range(NUM_CHANNELS)
        ]
        self.clip_grid = ClipGrid(sample_rate, bpm)
        self.capacity = buffer_capacity
        self._dev_buffers = [
            torch.zeros((2, 2 * buffer_capacity), dtype=torch.float32, device=device)
            for _ in range(NUM_CHANNELS)
        ]
        self._gain_banks = [
            SmootherBank.init(np.array([1.0, 1.0], np.float32), device)
            for _ in range(NUM_CHANNELS)
        ]
        self._coeff = smoothing_coeff(sample_rate)

    def set_bpm(self, bpm: float):
        """Propagate BPM to channels' delay timings + grid (mod.rs:80-87)."""
        self.bpm = bpm
        self.clip_grid.set_bpm(bpm)
        for ch in self.channels:
            ch.engine_bpm = bpm
            ch.chain.set_bpm(bpm)

    def _silent(self, i: int) -> bool:
        """True when channel ``i`` contributes exact silence this block AND
        skipping its host sweep + device work is state-neutral: no loaded or
        staged buffer (nothing to read or land) and an empty effect chain
        (no tails to ring out; the gain/gate smoothers of a silent channel
        scale zeros, so holding them is exact)."""
        ch = self.channels[i]
        return (ch.buffer is None and ch.pending is None
                and ch.region_buffers[0] is None
                and ch.region_buffers[1] is None
                and not ch.chain.entries)

    def _upload_if_dirty(self, i: int):
        """Copy a region that changed into the channel's device buffer, in
        place."""
        ch = self.channels[i]
        for r in range(2):
            if ch.region_dirty[r] and ch.region_buffers[r] is not None:
                arr = ch.region_buffers[r].device_array()
                lo = r * self.capacity
                self._dev_buffers[i][:, lo:lo + arr.shape[-1]].copy_(torch.as_tensor(arr))
                ch.region_dirty[r] = False

    def _targets(self, ch) -> np.ndarray:
        return np.array([ch.gain_target, 1.0 if ch.audible else 0.0], np.float32)

    def render_block(self):
        """One block → stereo sum ``[2, B]`` (device tensor)."""
        B = self.block
        actions = self.clip_grid.before_tick(self.channels, B)
        any_solo = any(ch.soloed for ch in self.channels)
        total = torch.zeros((2, B), dtype=torch.float32, device=self.device)
        for i, ch in enumerate(self.channels):
            ch.audible = (not ch.muted) and ((not any_solo) or ch.soloed)
            if self._silent(i) and i not in actions:
                continue
            self._upload_if_dirty(i)  # staged swaps upload before the sweep lands
            pos, weights, region, length, wraps = ch.sweep_positions(B, actions.get(i, ()))
            self._upload_if_dirty(i)
            self._gain_banks[i] = self._gain_banks[i].with_targets(self._targets(ch))
            plan = torch.as_tensor(pack_plan(pos, weights, region, length), device=self.device)
            bank, new_states, wet = _channel_block(
                self._dev_buffers[i], plan, self._gain_banks[i], tuple(ch.chain.states),
                tuple(ch.chain.targets_list()), capacity=self.capacity, wrap=bool(wraps),
                chain_key=ch.chain.static_key(), sample_rate=self.sr, coeff=self._coeff)
            self._gain_banks[i] = bank
            ch.chain.states = list(new_states)
            total = total + wet
        self.clip_grid.after_tick(B)
        return total

    def render_blocks(self, n_blocks: int, collect_beats=None):
        """Batched render: plan ``n_blocks`` blocks on the host, then render
        each channel's blocks.

        Equivalent to ``n_blocks`` :meth:`render_block` calls — the same
        float64 sweeps, quantized swaps, clip-grid actions and gain
        trajectories run on the host in the same order; the streamed
        channels (``stream.render_stream_channels``) run their hops on the
        device with one read back per wrap group.  Returns ``[2, n_blocks
        * block]`` (device tensor).

        A channel whose window wrap-ness changes mid-batch is split into
        maximal uniform-wrap runs.

        ``collect_beats``: optional list — appends one
        ``(transport_beat, transport_running)`` tuple per block, read before
        that block's ``before_tick``.
        """
        from libgooey_tpu_torch.mixer import stream as stream_mod

        B = self.block
        K = int(n_blocks)
        #: silent channels skip host sweeps AND device work for the whole
        #: span; safe to decide up front — no host API runs mid-span, so
        #: the only way a skipped channel could wake is a scheduled grid
        #: action, checked here
        skip = [self._silent(i)
                and self.clip_grid.pending[i] is None
                and self.clip_grid.pending_retrim[i] is None
                for i in range(len(self.channels))]
        stream_cfgs = [stream_mod.stream_config(self, i, K) for i in range(len(self.channels))]
        plans = [[] for _ in self.channels]   # per channel: ([6, B] plan, wrap)
        targets = [[] for _ in self.channels]
        for _k in range(K):
            if collect_beats is not None:
                collect_beats.append((self.clip_grid.transport_beat,
                                      self.clip_grid.transport_running))
            actions = self.clip_grid.before_tick(self.channels, B)
            any_solo = any(ch.soloed for ch in self.channels)
            for i, ch in enumerate(self.channels):
                ch.audible = (not ch.muted) and ((not any_solo) or ch.soloed)
                if skip[i]:
                    continue
                targets[i].append(self._targets(ch))
                if stream_cfgs[i] is not None:
                    continue  # rendered through the device hop loop below
                self._upload_if_dirty(i)
                pos, weights, region, length, wraps = ch.sweep_positions(B, actions.get(i, ()))
                self._upload_if_dirty(i)
                plans[i].append((pack_plan(pos, weights, region, length), bool(wraps)))
            self.clip_grid.after_tick(B)

        total = torch.zeros((2, K * B), dtype=torch.float32, device=self.device)
        finalizers = []
        # every streamed channel's hops run together
        # (stream.render_stream_channels); channels it can't take (batch
        # shorter than the hop remainder) are planned on the host below
        stream_items = [(i, stream_cfgs[i]) for i in range(len(self.channels))
                        if not skip[i] and stream_cfgs[i] is not None]
        streamed = stream_mod.render_stream_channels(
            self, stream_items, K, {i: np.stack(targets[i]) for i, _ in stream_items},
        ) if stream_items else {}
        self.streamed_channels = len(streamed)
        for i, ch in enumerate(self.channels):
            if skip[i]:
                continue
            if stream_cfgs[i] is not None:
                if i in streamed:
                    wets, wb, fin = streamed[i]
                    total = total + wets.permute(1, 0, 2).reshape(2, -1)
                    finalizers.append((wb, fin))
                    continue
                # batch shorter than the hop remainder: plan it on the host
                for _k in range(K):
                    pos, weights, region, length, wraps = ch.sweep_positions(B)
                    plans[i].append((pack_plan(pos, weights, region, length), bool(wraps)))
            wet_runs = []
            k0 = 0
            while k0 < K:
                wrap = plans[i][k0][1]
                k1 = k0
                while k1 < K and plans[i][k1][1] == wrap:
                    k1 += 1
                run = torch.as_tensor(np.stack([p for p, _ in plans[i][k0:k1]]),
                                      device=self.device)
                tgt = torch.as_tensor(np.stack(targets[i][k0:k1]), device=self.device)
                bank, new_states, wets = _channel_blocks(
                    self._dev_buffers[i], run, tgt, self._gain_banks[i],
                    tuple(ch.chain.states), tuple(ch.chain.targets_list()),
                    capacity=self.capacity, wrap=wrap, chain_key=ch.chain.static_key(),
                    sample_rate=self.sr, coeff=self._coeff)
                self._gain_banks[i] = bank
                ch.chain.states = list(new_states)
                wet_runs.append(wets.permute(1, 0, 2).reshape(2, -1))
                k0 = k1
            total = total + torch.cat(wet_runs, dim=-1)
        # the streamed channels' scheduler write-backs, after every channel
        # is enqueued: one copy per wrap group, started right after its hop
        # loop, waited on here once
        host_wbs = {}
        for (copy, row), fin in finalizers:
            if id(copy) not in host_wbs:
                host_wbs[id(copy)] = copy.numpy()
            fin(host_wbs[id(copy)][row])
        return total

    # --- offline stem render (mod.rs:444-476) -----------------------------------

    def render_channel_to_buffer(self, index: int, frames: int,
                                 preroll_blocks: int = 8) -> np.ndarray:
        """Render one channel solo to ``[2, frames]``: reset its effects, warm
        them with a discarded preroll, restart the cursor, capture exactly
        ``frames`` (gain baked from sample 0; mute/solo ignored)."""
        ch = self.channels[index]
        if ch.buffer is None:
            return np.zeros((2, frames), np.float32)
        ch.chain.reset()
        saved_cursor = ch.cursor
        saved_playing = ch.playing
        ch.playing = True
        bank = SmootherBank.init(np.array([ch.gain_target, 1.0], np.float32), self.device)
        self._upload_if_dirty(index)

        def run(n_samples, collect):
            nonlocal bank
            out = []
            done = 0
            while done < n_samples:
                pos, weights, region, length, wraps = ch.sweep_positions(self.block)
                plan = torch.as_tensor(pack_plan(pos, weights, region, length),
                                       device=self.device)
                bank, new_states, wet = _channel_block(
                    self._dev_buffers[index], plan, bank, tuple(ch.chain.states),
                    tuple(ch.chain.targets_list()), capacity=self.capacity,
                    wrap=bool(wraps), chain_key=ch.chain.static_key(),
                    sample_rate=self.sr, coeff=self._coeff)
                ch.chain.states = list(new_states)
                if collect:
                    out.append(wet.cpu().numpy())
                done += self.block
            return np.concatenate(out, axis=-1)[:, :n_samples] if collect else None

        # preroll warms the effect tails, then restart and capture
        run(preroll_blocks * self.block, collect=False)
        ch.restart()
        result = run(frames, collect=True)
        ch.cursor = saved_cursor
        ch.playing = saved_playing
        return result

    def render_channel_to_wav(self, index: int, frames: int, path, bits: int = 32):
        from libgooey_tpu_torch.io_wav import write_wav

        buf = self.render_channel_to_buffer(index, frames)
        write_wav(path, buf, int(self.sr), bits=bits)
        return buf
