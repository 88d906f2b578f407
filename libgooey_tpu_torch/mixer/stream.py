"""Batched device-resident WSOLA rendering for PreservePitch loop channels
(port of libgooey_tpu/mixer/stream.py).

Host glue around :mod:`libgooey_tpu_torch.ops.wsola_stream`: maps the
``WsolaHost`` scheduler state onto the device hop loop, renders ``K``
blocks (partial-hop prefix + ``n_hops`` full hops + the gain/chain tail)
with nothing read back in between, and writes the final hop state back so
the host scheduler can continue seamlessly — per-block rendering, another
batch, or a queued swap all pick up where the device left off.

Engages from :meth:`Mixer.render_blocks` when a channel is PreservePitch
with the device search enabled, no pending swap, and no clip-grid action
scheduled for its column within the span (see :func:`stream_config`).
The write-back of a wrap group is one stacked ``[C, hop + 5]`` tensor,
copied to pinned host memory without blocking right after the hop loop is
enqueued; ``Mixer.render_blocks`` waits on it only after every channel's
tail is enqueued.
"""

from __future__ import annotations

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank
from libgooey_tpu_torch.mixer import wsola
from libgooey_tpu_torch.mixer.loop_channel import PITCH_PRESERVE
from libgooey_tpu_torch.mixer.stereo_buffer import read_cubic
from libgooey_tpu_torch.ops import wsola_stream as dws


def _f32(x, device):
    """A host float64 plan as a float32 device tensor (rounded on the host,
    as ``jnp.asarray`` rounds it)."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class HostCopy:
    """A device tensor's copy to the host, started without blocking.  On the
    card: a pinned buffer, a ``non_blocking`` copy and an event, waited on
    in :meth:`numpy`; on the CPU a plain copy."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _gain_chain_tail(dry, targets_seq, gain_bank, chain_states, chain_targets, *,
                     chain_key, sample_rate, coeff):
    """Per block of ``dry`` ``[K, 2, B]``: the gain/gate smoothers toward
    ``targets_seq[k]`` (``[K, 2]`` on the device), the chain, the gate.
    Returns ``(bank, states, wets [K, 2, B])``."""
    from libgooey_tpu_torch.mixer.mixer import gain_chain

    bank, states, wets = gain_bank, tuple(chain_states), []
    for k in range(dry.shape[0]):
        bank, states, wet = gain_chain(
            dry[k], SmootherBank(current=bank.current, target=targets_seq[k]), states,
            chain_targets, chain_key=chain_key, sample_rate=sample_rate, coeff=coeff)
        wets.append(wet)
    return bank, states, torch.stack(wets)


def _stream_channel(buf2, prefix_pos, prefix_w, r0, cur_i, cur_f, have_prev,
                    ref_tail, ptail_pos, ptail_valid, w1, w2, targets_seq,
                    gain_bank, chain_states, chain_targets, *, cfg, n_hops: int,
                    K: int, B: int, wrap_read: bool, chain_key,
                    sample_rate: float, coeff: float):
    """One channel's whole batch: prefix + hop loop + slice + per-block
    gain/chain, and its packed write-back ``[hop + 5]``.  Positions and
    weights are host arrays; the rest device tensors."""
    dev = buf2.device
    rows = torch.cat([(buf2[0] + buf2[1])[None, :], buf2], dim=0)
    P3 = dws.pad_buffer(rows, cfg)
    pp, pw = _f32(prefix_pos, dev), _f32(prefix_w, dev)
    pre = (read_cubic(buf2, pp[0], wrap_read) * pw[0][None, :]
           + read_cubic(buf2, pp[1], wrap_read) * pw[1][None, :])
    ptail = read_cubic(buf2, _f32(ptail_pos, dev), wrap_read) * w2[None, :] * float(ptail_valid)
    state = dws.state_tuple((cur_i, cur_f, have_prev, ref_tail, ptail), dev)
    carry, bi, bf, hps, ys = dws.stream_hops(P3, w1, w2, state, n_hops=n_hops, cfg=cfg)
    full = torch.cat([pre, ys.permute(1, 0, 2).reshape(2, -1)], dim=1)
    s = min(max(cfg.hop - int(r0), 0), full.shape[1] - K * B)
    dry = full[:, s:s + K * B].reshape(2, K, B).permute(1, 0, 2)
    bank, states, wets = _gain_chain_tail(dry, targets_seq, gain_bank, chain_states,
                                          chain_targets, chain_key=chain_key,
                                          sample_rate=sample_rate, coeff=coeff)
    _cur, _hp, ref_out, _pt = carry
    z = torch.zeros((), dtype=torch.float32, device=dev)
    wb = torch.cat([ref_out, torch.stack([
        bi[-1], bf[-1], bi[-2] if n_hops >= 2 else z, bf[-2] if n_hops >= 2 else z,
        hps[-1].to(torch.float32)])])
    return bank, states, wets, wb


def stream_config(mixer, i, n_blocks: int = 0):
    """The stream config for channel ``i``, or None if ineligible.

    A running clip-grid transport does not disqualify the channel: grid
    actions are beat-scheduled, so the host knows at span-planning time
    whether anything can land on this column within ``n_blocks``
    (clip_grid.rs:582+).  Only a pending launch/stop/retrim for this
    column inside the span's horizon forces the per-block host path.
    """
    ch = mixer.channels[i]
    if (
        not ch.playing
        or ch.buffer is None
        or ch.pitch_mode != PITCH_PRESERVE
        or ch.speed < 0.0
        or ch.pending is not None
    ):
        return None
    grid = mixer.clip_grid
    if grid.transport_running:
        bps = grid.beats_per_sample()
        horizon = grid.transport_beat + n_blocks * mixer.block * bps + bps
        p = grid.pending[i]
        r = grid.pending_retrim[i]
        if (p is not None and p.beat < horizon) or (
                r is not None and r.beat < horizon):
            return None
    use_dev = (ch._stretcher.use_device if ch._stretcher is not None
               else wsola.USE_DEVICE_SEARCH)
    if not use_dev:
        return None
    L = len(ch.buffer)
    w = ch.window(float(L))
    return dws.make_config(mixer.sr, ch.buffer.sample_rate, L, w.lo, w.span,
                           w.wraps, ch.speed, ch.warp_ratio())


def _prep_channel(mixer, i, K: int, cfg):
    """Host-side prep shared by the single-channel and batched paths.

    Returns a dict of everything the device work needs, or None when the
    batch is shorter than the current hop remainder (the caller plans that
    channel on the host)."""
    ch = mixer.channels[i]
    B = mixer.block
    T = K * B
    host = ch._stretcher
    if host is None:
        host = ch._stretcher = wsola.WsolaHost(mixer.sr, ch.cursor, device=mixer.device)
    hop = cfg.hop
    r0 = hop - host.drain_idx if host.drain_idx < hop else 0
    if T <= r0:
        return None

    L = float(len(ch.buffer))
    w = ch.window(L)
    ratio = ch.buffer.sample_rate / max(mixer.sr, 1.0)
    warp = ch.warp_ratio()

    ppos = np.zeros((2, hop), np.float64)
    pw = np.zeros((2, hop), np.float32)
    if r0:
        pos, wts, _cur = host.plan_block(r0, ch.buffer, w, ratio, ch.speed, warp)
        ppos[:, hop - r0:] = pos
        pw[:, hop - r0:] = wts
    n_hops = -(-(T - r0) // hop)

    v = (w.to_virtual(host.analysis_cursor) if w.wraps
         else (host.analysis_cursor - w.lo))
    have_prev = bool(host.have_prev)
    ref_tail = (np.asarray(host.prev_tail_mono, np.float32) if have_prev
                else np.zeros(hop, np.float32))
    if have_prev:
        idx = np.arange(hop)
        pos_v = np.clip(host.cur_start_v + (hop + idx) * host.cur_step, 0.0, w.span)
        ptail_pos = (np.mod(w.lo + pos_v, w.len) if w.wraps else (w.lo + pos_v))
        pvalid = 1.0
    else:
        ptail_pos = np.zeros(hop, np.float64)
        pvalid = 0.0

    mixer._upload_if_dirty(i)
    base = ch.active_region * mixer.capacity
    buf2 = mixer._dev_buffers[i][:, base:base + int(L)]
    return dict(ch=ch, host=host, w=w, L=L, hop=hop, r0=r0, n_hops=n_hops,
                ppos=ppos, pw=pw, v=float(v), have_prev=have_prev,
                ref_tail=ref_tail, ptail_pos=ptail_pos, pvalid=pvalid,
                buf2=buf2, T=T)


def _mk_finalize(mixer, i, p, cfg):
    """The host-scheduler write-back closure (shared by both paths)."""
    ch, host, w = p["ch"], p["host"], p["w"]
    hop, n_hops, r0, T = p["hop"], p["n_hops"], p["r0"], p["T"]
    prev_cur_start = getattr(host, "cur_start_v", None)
    prev_cur_step = getattr(host, "cur_step", cfg.step)

    def finalize(wb_host):
        wb_host = np.asarray(wb_host, np.float64)
        ref_out = wb_host[:hop].astype(np.float32)
        last_i, last_f, prev_i, prev_f, last_hp = wb_host[hop:hop + 5]
        best_last = last_i + last_f
        if n_hops >= 2:
            host.prev_start_v = prev_i + prev_f
            host.prev_step = cfg.step
        else:
            host.prev_start_v = (prev_cur_start if prev_cur_start is not None
                                 else best_last)
            host.prev_step = float(prev_cur_step)
        host.cur_start_v = best_last
        host.cur_step = cfg.step
        host.had_prev_for_cur = bool(last_hp > 0.5)
        host.have_prev = True
        host.prev_tail_mono = ref_out
        host.analysis_cursor = float(
            np.mod(w.lo + best_last, w.len) if w.wraps
            else (w.lo + best_last))
        host.drain_idx = int((T - r0) - (n_hops - 1) * hop)
        host._buffer_sr = ch.buffer.sample_rate
        ch.cursor = host.analysis_cursor

    return finalize


def _stream_hops_batched(P3c, ptail_pos, pvalid, w1, w2, cur_i, cur_f, have_prev, ref_tail,
                         n_active, dyn, *, cfg, n_hops: int):
    """The batched hop loop: each channel's overlap-add partner read from
    its padded rows, the hops of every channel together, and the packed
    per-channel write-backs ``[C, hop + 5]``.  ``n_active``: host
    integers."""
    C = P3c.shape[0]
    # rows = padded [3, W]; positions are pre-wrapped host coordinates, so
    # a flat read at pos+4 sees exactly the host taps (pad_buffer layout)
    ptail = torch.stack([read_cubic(P3c[c, 1:3], ptail_pos[c] + 4.0, False) * w2[None, :]
                         for c in range(C)]) * pvalid[:, None, None]
    state = ((cur_i, cur_f), have_prev, ref_tail, ptail)
    carry, bi, bf, hps, ys = dws.stream_hops_batched(P3c, w1, w2, state, n_active, dyn,
                                                     n_hops=n_hops, cfg=cfg)
    _cur, _hp, ref_out, _pt = carry
    # the last and second-to-last hop of each channel, known on the host
    last = [max(int(n) - 1, 0) for n in n_active]
    prev = [max(int(n) - 2, 0) for n in n_active]
    has2 = [1.0 if int(n) >= 2 else 0.0 for n in n_active]
    wb = torch.cat([ref_out, torch.stack([
        torch.stack([bi[last[c], c], bf[last[c], c], bi[prev[c], c] * has2[c],
                     bf[prev[c], c] * has2[c], hps[last[c], c].to(torch.float32)])
        for c in range(C)])], dim=-1)
    return ys, wb


def _stream_tail(buf2, prefix_pos, prefix_w, r0, ys_c, targets_seq,
                 gain_bank, chain_states, chain_targets, *, n_hops: int,
                 hop: int, K: int, B: int, wrap_read: bool, chain_key,
                 sample_rate: float, coeff: float):
    """Per-channel epilogue: prefix read + slice + gain/chain.  ``ys_c``:
    ``[n_hops, 2, hop]``; ``targets_seq``: ``[K, 2]`` on the device."""
    dev = buf2.device
    pp, pw = _f32(prefix_pos, dev), _f32(prefix_w, dev)
    pre = (read_cubic(buf2, pp[0], wrap_read) * pw[0][None, :]
           + read_cubic(buf2, pp[1], wrap_read) * pw[1][None, :])
    full = torch.cat([pre, ys_c.permute(1, 0, 2).reshape(2, -1)], dim=1)
    s = min(max(hop - int(r0), 0), full.shape[1] - K * B)   # dynamic_slice's clamp
    dry = full[:, s:s + K * B].reshape(2, K, B).permute(1, 0, 2)

    if not chain_key:
        # empty chain (the live clip-grid case): the K smoother steps of
        # the gain and the gate, then one elementwise product.  As the JAX
        # package's closed form: q = f32(1 - coeff), block k starts from
        # block k-1's end value, the 1e-4 settle snap per sample.
        q = float(np.float32(1.0 - coeff))
        powers = torch.pow(q, torch.arange(1, B + 1, dtype=torch.float32, device=dev))
        cur, trajs = gain_bank.current, []
        for k in range(K):
            tgt = targets_seq[k]
            decayed = (cur - tgt)[:, None] * powers[None, :]
            traj = tgt[:, None] + torch.where(decayed.abs() < 1e-4, 0.0, decayed)
            cur = traj[:, -1]
            trajs.append(traj)
        trajs = torch.stack(trajs)                              # [K, 2, B]
        wets = dry * trajs[:, 0][:, None, :] * trajs[:, 1][:, None, :]
        return SmootherBank(current=cur, target=targets_seq[-1]), tuple(chain_states), wets

    return _gain_chain_tail(dry, targets_seq, gain_bank, chain_states, chain_targets,
                            chain_key=chain_key, sample_rate=sample_rate, coeff=coeff)


def render_stream_channels(mixer, items, K: int, targets_by_ch):
    """Render K blocks for several stream channels at once.

    ``items``: list of ``(i, cfg)``.  The hop loops of all channels run
    together, grouped by window wrap-ness (a read mode); the prefix and
    chain epilogues stay per channel.  Returns ``{i: (wets, (copy, row),
    finalize)}``: ``copy`` is the group's :class:`HostCopy` of its stacked
    write-back, started right after the hop loop; the caller waits on it
    once and feeds each row to its finalize.  Channels whose batch is
    shorter than their hop remainder are absent from the result (the
    caller plans them on the host).
    """
    B = mixer.block
    dev = mixer.device
    preps = {}
    for i, cfg in items:
        p = _prep_channel(mixer, i, K, cfg)
        if p is not None:
            preps[i] = (cfg, p)
    out = {}
    for wraps in (False, True):
        group = [(i, cfg, p) for i, (cfg, p) in preps.items() if cfg.wraps == wraps]
        if not group:
            continue
        hop = group[0][1].hop
        U = max(cfg.U for _i, cfg, _p in group)
        nf = max(cfg.nf for _i, cfg, _p in group)
        shared = group[0][1]._replace(U=U, nf=nf)
        n_hops = max(p["n_hops"] for _i, _cfg, p in group)
        Wmax = max(int(p["L"]) for _i, _cfg, p in group) + 4 + U

        P3_rows, dyn_rows = [], []
        for i, cfg, p in group:
            # the padded rows change only with the buffer, window or padding
            # geometry: cached on the channel
            ch = p["ch"]
            key = (ch.active_region, cfg.wraps, U, Wmax)
            cached = getattr(ch, "_p3_cache", None)
            if cached is not None and cached[0] == key and cached[2] is ch.buffer:
                P3 = cached[1]
            else:
                buf2 = p["buf2"]
                rows = torch.cat([(buf2[0] + buf2[1])[None, :], buf2], dim=0)
                P3 = dws.pad_buffer(rows, cfg._replace(U=U))
                pad = Wmax - P3.shape[1]
                if pad:
                    P3 = torch.nn.functional.pad(P3, (0, pad))
                ch._p3_cache = (key, P3, ch.buffer)
            P3_rows.append(P3)
            dyn_rows.append(dws._static_dyn(cfg))
        P3c = torch.stack(P3_rows)
        host0 = group[0][2]["host"]
        ps = [p for _i, _c, p in group]
        v = np.array([p["v"] for p in ps])
        ys, wb = _stream_hops_batched(
            P3c, _f32(np.stack([p["ptail_pos"] for p in ps]), dev),
            _f32([p["pvalid"] for p in ps], dev),
            _f32(host0.window[:hop], dev), _f32(host0.window[hop:], dev),
            _f32(np.floor(v), dev), _f32(v - np.floor(v), dev),
            torch.as_tensor(np.array([p["have_prev"] for p in ps]), device=dev),
            _f32(np.stack([p["ref_tail"] for p in ps]), dev),
            np.array([p["n_hops"] for p in ps], np.int64),
            dws.dyn_tensors(dyn_rows, dev), cfg=shared, n_hops=n_hops)
        # start the write-back's copy now: it depends only on the hop loop,
        # so it lands while the tails below run
        copy = HostCopy(wb)
        for row, (i, cfg, p) in enumerate(group):
            ch = p["ch"]
            bank, states, wets = _stream_tail(
                p["buf2"], p["ppos"], p["pw"], p["r0"], ys[:p["n_hops"], row],
                _f32(targets_by_ch[i], dev), mixer._gain_banks[i],
                tuple(ch.chain.states), tuple(ch.chain.targets_list()),
                n_hops=p["n_hops"], hop=hop, K=K, B=B, wrap_read=wraps,
                chain_key=ch.chain.static_key(), sample_rate=mixer.sr,
                coeff=mixer._coeff)
            mixer._gain_banks[i] = bank
            ch.chain.states = list(states)
            out[i] = (wets, (copy, row), _mk_finalize(mixer, i, p, cfg))
    return out


def render_stream_channel(mixer, i, K: int, targets_np, cfg):
    """Single-channel wrapper over :func:`render_stream_channels`.

    Returns ``(wets, (copy, row), finalize)`` or None when the batch is
    shorter than the current hop remainder."""
    res = render_stream_channels(mixer, [(i, cfg)], K, {i: targets_np})
    return res.get(i)
