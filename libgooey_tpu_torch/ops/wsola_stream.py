"""Device-resident WSOLA streaming: the hop loop on device tensors (port of
libgooey_tpu/ops/wsola_stream.py).

Behavioral reference: src/mixer/wsola.rs (synthesize_hop / search loops,
rs:120-330) — the same 20 ms hop scheduler, coarse-to-fine NCC search and
COLA overlap-add as ``mixer/wsola.WsolaHost``, but with the whole per-hop
loop (search, grain reads, tail update, overlap-add) on the device.  The
per-block host path reads the search result back once a hop (it feeds the
next hop's reference tail); this path runs ``n_hops`` hops with no read
back at all: the argmax, the selects and each hop's slice start stay
device tensors, and the loop over hops is a Python loop that only enqueues.

* **Positions are (integer, fraction) float32 pairs.**  The reference
  keeps float64 hop cursors on the host; here every carried position is
  ``int + frac`` with the integer part exact in float32 (< 2^24) and the
  fraction in [0, 1): per-hop rounding is ≤ ulp(2) ≈ 2.4e-7 samples.
* **Every candidate and grain read is ``grain_kernels.grain_read_cubic``**
  (``csrc/grain_kernels.cu`` on the card): a candidate row reads
  ``cubic(mono, cand + i*step)``, the granulator's "fractional start +
  uniform step" shape, over a per-hop union window sliced from the
  (edge- or wrap-padded) buffer.  The union covers every coarse/fine
  candidate window and the chosen grain (anchor = floor(lo_b); its width
  is static).  Three reads a hop: the coarse candidates, the fine ones
  and the grain (mono, left, right), each over every channel at once.
  The reads are ``hop`` and ``win_n`` samples long; the JAX package pads
  them to a TPU block length and slices the padding away, and each
  output column depends only on its own position, so the port does not.
* The previous grain's windowed second half (stereo, for overlap-add) and
  its windowed mono tail (the NCC reference) are carried through the loop
  instead of re-read.

Known deviations from the host scheduler (the JAX package's, kept):
score-window positions are not clamped at ``max_start + step``; in-kernel
positions ``p0 + step*n`` are float32, so scores and audio differ from the
float64 host by ~1e-4 and ties in the argmax on periodic material can
resolve differently; the coarse candidate count replicates ``np.arange``'s
float64 ceil via ``floor(q + 1e-5) + 1``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.ops import grain_kernels

COARSE_STEPS = 64
NC = COARSE_STEPS + 1
_EPS = float(np.finfo(np.float32).eps)

#: the JAX package's grain-kernel step limit (``pallas_grain.MAX_STEP``, its
#: largest window tier).  The port's ``grain_read_cubic`` has no such limit,
#: but the streamed path keeps the same gate with the same constant, so a
#: channel takes the same path in both packages at every speed.
MAX_STEP = float((15 * 128 - 5 - 127) / (256 - 1))


class StreamConfig(NamedTuple):
    """Per-batch WSOLA parameters (host-computed in float64)."""

    hop: int
    win_n: int
    step: float        # source step per output sample (sr_ratio * speed)
    hopw_i: float      # hop_span * warp, split int/frac
    hopw_f: float
    rad: float         # search radius (integer-valued)
    ms_i: float        # max_start split
    ms_f: float
    wl_i: float        # floor(win_lo) / frac(win_lo)
    wl_f: float
    L: int             # window length (== buffer length, loop_channel.window)
    wraps: bool
    U: int             # union-window width
    nf: int            # fine candidate capacity


def make_config(engine_sr: float, buffer_sr: float, L: int, win_lo: float,
                span: float, wraps: bool, speed: float,
                warp: float) -> StreamConfig | None:
    """Build the config, or None when streaming can't apply (degenerate
    window, step beyond ``MAX_STEP - 0.5``, buffer shorter than the union
    window)."""
    sr = max(engine_sr, 1.0)
    hop = max(int(round(20.0 / 1000.0 * sr)), 1)
    win_n = 2 * hop
    ratio = buffer_sr / sr
    step = max(ratio * max(speed, 0.0), 1e-6)
    if step > MAX_STEP - 0.5:
        return None
    grain_span = (win_n - 1.0) * step + 1.0
    max_start = span - grain_span
    if max_start <= 0.0:
        return None
    radius = max(round(10.0 / 1000.0 * buffer_sr), 1.0)
    U = int(2 * radius + grain_span + 24)
    if wraps and L < U + 8:
        return None
    hop_span_warp = hop * step * max(warp, 0.0)
    stride_max = max(2.0 * radius / COARSE_STEPS, 1.0)
    nf = 2 * int(np.ceil(stride_max)) + 3
    return StreamConfig(
        hop=hop, win_n=win_n, step=float(step),
        hopw_i=float(math.floor(hop_span_warp)),
        hopw_f=float(hop_span_warp - math.floor(hop_span_warp)),
        rad=float(radius),
        ms_i=float(math.floor(max_start)),
        ms_f=float(max_start - math.floor(max_start)),
        wl_i=float(math.floor(win_lo)),
        wl_f=float(win_lo - math.floor(win_lo)),
        L=int(L), wraps=bool(wraps), U=U, nf=nf,
    )


def pad_buffer(rows, cfg: StreamConfig):
    """``[R, L] -> [R, 4 + L + U]`` with the host tap semantics baked in:
    wrap windows get wrap padding (taps mod L), non-wrap get edge holds
    (taps clamped to [0, L-1]).  Flat index ``p + 4`` reads sample ``p``."""
    if cfg.wraps:
        return torch.cat([rows[:, -4:], rows, rows[:, : cfg.U]], dim=1)
    return torch.cat([rows[:, :1].expand(-1, 4), rows,
                      rows[:, -1:].expand(-1, cfg.U)], dim=1)


# --- (integer, fraction) pairs -----------------------------------------------

def _norm(i, f):
    k = torch.floor(f)
    return i + k, f - k


def _add(a, b):
    return _norm(a[0] + b[0], a[1] + b[1])


def _sub(a, b):
    return _norm(a[0] - b[0], a[1] - b[1])


def _lt(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def _sel(c, a, b):
    return torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1])


def _pmax(a, b):
    return _sel(_lt(a, b), b, a)


def _pmin(a, b):
    return _sel(_lt(a, b), a, b)


# --- the hop loop ----------------------------------------------------------------

def _static_dyn(cfg: StreamConfig):
    return dict(step=float(cfg.step), hopw_i=float(cfg.hopw_i),
                hopw_f=float(cfg.hopw_f), rad=float(cfg.rad),
                ms_i=float(cfg.ms_i), ms_f=float(cfg.ms_f),
                wl_i=float(cfg.wl_i), wl_f=float(cfg.wl_f),
                L=float(cfg.L))


def dyn_tensors(rows, device):
    """Per-channel parameter dicts (:func:`_static_dyn`) -> one dict of
    ``[C]`` float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.array([d[k] for d in rows], np.float32), device=device)
            for k in rows[0]}


def _hop_once_batched(carry, P3c, w1, w2, d, cfg: StreamConfig):
    """One hop for C channels at once.

    The window reads are channel-flattened into single ``grain_read_cubic``
    calls over the concatenated union windows; everything else is
    elementwise on [C] or batched einsums.  ``d``: dict of [C] float32
    per-channel parameters; ``cfg`` supplies the structural values (hop,
    win_n, U, nf, wraps)."""
    f32 = torch.float32
    dev = P3c.device
    C, W = P3c.shape[0], P3c.shape[2]
    U, hop = cfg.U, cfg.hop
    step = d["step"]                                           # [C]
    zc = torch.zeros((C,), dtype=f32, device=dev)
    ZERO = (zc, zc)
    HOPW = (d["hopw_i"], d["hopw_f"])
    RAD = (d["rad"], zc)
    MS = (d["ms_i"], d["ms_f"])
    jc = torch.arange(NC, dtype=f32, device=dev)
    jf = torch.arange(cfg.nf, dtype=f32, device=dev)
    row_off = torch.arange(3, dtype=f32, device=dev) * U          # [3]
    chan_off = torch.arange(C, dtype=f32, device=dev) * (3 * U)   # [C]

    cur, have_prev, ref_tail, ptail = carry
    raw = _add(cur, HOPW)
    wrapped = _lt(MS, raw)  # raw_target > max_start (max_start > 0 here)
    # host: search_center = 0 if wrapped else max(raw_target, 0) — the
    # cursor can sit below the loop window (negative virtual coords)
    ctr = _sel(wrapped, ZERO, _pmax(raw, ZERO))
    hp_cur = have_prev & ~wrapped

    lo = _pmax(_sub(ctr, RAD), ZERO)
    hi = _pmin(_add(ctr, RAD), MS)
    search_ok = _lt(lo, hi)

    anchor = lo[0]                                             # [C]
    sb = d["wl_i"] + anchor
    if cfg.wraps:
        sb = torch.where(sb >= d["L"], sb - d["L"], sb)
    # jax.lax.dynamic_slice: the start is clamped so the slice fits
    start = torch.clamp(sb.to(torch.int64), 0, W - U)
    cols = start[:, None] + torch.arange(U, device=dev)
    uwin3 = torch.gather(P3c, 2, cols[:, None, :].expand(C, 3, U))   # [C, 3, U]
    uflat = uwin3.reshape(-1)                                  # [C*3*U]

    def rel(p):
        return (p[0] - anchor) + (p[1] + (d["wl_f"] + 4.0))

    def read(starts, steps, n):
        return grain_kernels.grain_read_cubic(uflat, starts.contiguous(), steps.contiguous(), B=n)

    def scores(p0s, valid, nrows):
        """p0s [C, n] channel-relative mono starts -> NCC scores [C, n]."""
        starts = (p0s + chan_off[:, None]).reshape(-1)
        steps = step[:, None].expand(p0s.shape).reshape(-1)
        cand = read(starts, steps, hop).reshape(C, nrows, hop)
        num = torch.einsum("cnh,ch->cn", cand, ref_tail)
        ce = torch.einsum("cnh,cnh->cn", cand, cand)
        ok = (ce > _EPS) & (re > _EPS)[:, None]
        sc = torch.where(ok, num / (torch.sqrt(re)[:, None] * torch.sqrt(ce)), 0.0)
        return torch.where(valid, sc, -torch.inf)

    # coarse stage
    dd = (hi[0] - lo[0]) + (hi[1] - lo[1])                     # [C]
    stride = torch.clamp(dd / COARSE_STEPS, min=1.0)
    q = dd / stride
    nc_valid = torch.floor(q + 1e-5) + 1.0
    base = rel(lo)                                             # [C]
    re = torch.einsum("ch,ch->c", ref_tail, ref_tail)
    sc = scores(base[:, None] + jc[None, :] * stride[:, None],
                jc[None, :] < nc_valid[:, None], NC)
    ci = torch.argmax(sc, dim=-1)                              # [C]
    best_c = jc[ci] * stride

    # fine stage (1-sample steps around the coarse winner)
    f_lo = torch.clamp(best_c - stride, min=0.0)
    f_hi = torch.minimum(best_c + stride, dd)
    nf_valid = torch.floor(f_hi - f_lo + 1e-9) + 1.0
    sf = scores(base[:, None] + f_lo[:, None] + jf[None, :],
                jf[None, :] < nf_valid[:, None], cfg.nf)
    fi = torch.argmax(sf, dim=-1)
    cix = torch.arange(C, device=dev)
    best_off = torch.where(sf[cix, fi] > sc[cix, ci], f_lo + jf[fi], best_c)

    searched = _norm(lo[0], lo[1] + best_off)
    best = _sel(hp_cur & search_ok, searched, ctr)

    # the chosen grains, [C, 3, win_n] = mono, left, right: one read
    gstarts = rel(best)[:, None] + row_off[None, :] + chan_off[:, None]   # [C, 3]
    g3 = read(gstarts.reshape(-1), step[:, None].expand(C, 3).reshape(-1),
              cfg.win_n).reshape(C, 3, cfg.win_n)
    y = (g3[:, 1:3, :hop] * w1[None, None, :]
         + torch.where(hp_cur, 1.0, 0.0)[:, None, None] * ptail)
    new_ref = g3[:, 0, hop:] * w2[None, :]
    new_ptail = g3[:, 1:3, hop:] * w2[None, None, :]

    out = (best[0], best[1], hp_cur, y)
    return (best, torch.ones((C,), dtype=torch.bool, device=dev), new_ref, new_ptail), out


def _select(keep, new, old):
    """``new`` where ``keep`` [C], else ``old``, leaf by leaf."""
    if isinstance(new, tuple):
        return tuple(_select(keep, n, o) for n, o in zip(new, old))
    return torch.where(keep.reshape((keep.shape[0],) + (1,) * (new.dim() - 1)), new, old)


def stream_hops_batched(P3c, w1, w2, state, n_active, dyn, *, n_hops: int,
                        cfg: StreamConfig):
    """Run up to ``n_hops`` hops for C channels.

    ``P3c``: ``[C, 3, W]`` padded rows (channels padded to a shared ``4 +
    Lmax + U``); ``state``: :func:`state_tuple`'s per-channel state with a
    leading C axis on every leaf; ``n_active``: each channel's hop count, a
    host integer array (hops past it keep the carry frozen and produce
    don't-care ``ys`` the caller never slices into); ``dyn``: dict of
    ``[C]`` float32 tensors (:func:`dyn_tensors`).  ``cfg`` carries the
    shared structural values — ``U``/``nf`` the batch maxima, ``wraps``
    uniform (callers group channels by wrap-ness).

    Returns ``(state', bests_i[n, C], bests_f[n, C], hps[n, C], ys[n, C,
    2, hop])``.  Nothing is read back from the device.
    """
    n_active = np.asarray(n_active)
    keep = None
    if n_hops and n_active.min() < n_hops:   # a frozen channel: its masks, one copy
        keep = torch.as_tensor(np.arange(n_hops)[:, None] < n_active[None, :],
                               device=P3c.device)
    carry = state
    bi, bf, hps, ys = [], [], [], []
    for h in range(n_hops):
        new_carry, out = _hop_once_batched(carry, P3c, w1, w2, dyn, cfg)
        carry = new_carry if h < n_active.min() else _select(keep[h], new_carry, carry)
        for acc, o in zip((bi, bf, hps, ys), out):
            acc.append(o)
    return carry, torch.stack(bi), torch.stack(bf), torch.stack(hps), torch.stack(ys)


def _hop_once(carry, P3, w1, w2, d, cfg: StreamConfig):
    """One WSOLA hop for one channel: :func:`_hop_once_batched` over a
    batch of one (its candidates read from its own flattened union, at the
    positions the JAX package's single-channel hop reads).  ``d``: the
    channel's parameters, floats or ``[1]`` tensors."""
    dev = P3.device
    d = {k: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1)
         for k, v in d.items()}
    (cur_i, cur_f), have_prev, ref_tail, ptail = carry
    carry1 = ((cur_i.reshape(1), cur_f.reshape(1)), have_prev.reshape(1), ref_tail[None],
              ptail[None])
    (best, hp, new_ref, new_ptail), (bi, bf, hps, y) = _hop_once_batched(
        carry1, P3[None], w1, w2, d, cfg)
    return ((best[0][0], best[1][0]), hp[0], new_ref[0], new_ptail[0]), (bi[0], bf[0], hps[0],
                                                                         y[0])


def stream_hops(P3, w1, w2, state, *, n_hops: int, cfg: StreamConfig):
    """Run ``n_hops`` WSOLA hops on the device for one channel.

    ``P3``: ``[3, 4+L+U]`` padded rows (mono = L+R, left, right) from
    :func:`pad_buffer`.  ``w1``/``w2``: the COLA window halves ``[hop]``.
    ``state``: :func:`state_tuple` of ``(cur_i, cur_f, have_prev,
    ref_tail[hop], ptail[2, hop])``.

    Returns ``(state', bests_i[n], bests_f[n], hps[n], ys[n, 2, hop])``.
    """
    d = {k: torch.as_tensor(np.float32(v), device=P3.device).reshape(1)
         for k, v in _static_dyn(cfg).items()}
    carry = state
    outs = []
    for _ in range(n_hops):
        carry, out = _hop_once(carry, P3, w1, w2, d, cfg)
        outs.append(out)
    bi, bf, hps, ys = (torch.stack(o) for o in zip(*outs))
    return carry, bi, bf, hps, ys


def state_tuple(state, device=None):
    """``(cur_i, cur_f, have_prev, ref_tail, ptail)`` -> the carried state
    ``((cur_i, cur_f), have_prev, ref_tail, ptail)`` as float32 / bool
    tensors (on ``device``, or where the tensors already are)."""
    cur_i, cur_f, have_prev, ref_tail, ptail = state

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                               device=device).to(dtype)

    return ((t(cur_i, torch.float32), t(cur_f, torch.float32)), t(have_prev, torch.bool),
            t(ref_tail, torch.float32), t(ptail, torch.float32))
