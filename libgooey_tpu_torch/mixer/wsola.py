"""WSOLA time-stretcher for PreservePitch loop playback (port of
libgooey_tpu/mixer/wsola.py; host numpy, copied as it is).

Behavioral reference: src/mixer/wsola.rs (527 LoC).

* fixed 20 ms output hops, 2x-hop periodic-Hann COLA windows (rs:29-37,
  77-81);
* within-grain reads at the native step (pitch untouched); only the
  hop-to-hop jump scales by the tempo warp (rs:13-18);
* coarse-to-fine normalized cross-correlation search ±10 ms of source, 64
  coarse steps (rs:34-37, 330-440); wrap-window variant in virtual
  coordinates; loop seam restarts a fresh grain (no cross-seam crossfade).

Output = overlap-add of exactly two windowed grain streams, so a block plan
is two per-sample position streams + Hann weights, which the device reads
with cubic gathers.  The correlation search (control-rate, once per 20 ms)
has two implementations:

* the numpy host search below — the oracle, mirroring the reference search
  including its coarse stride and 1-sample refine;
* a device path (``use_device=True``; ``ops/wsola_search.py``): the coarse
  and fine candidate banks evaluated on the device, returning chosen
  *indices* that the host maps back through its own float64 candidate
  arrays, so the downstream hop state equals the host search's whenever
  the indices agree.
"""

from __future__ import annotations

import numpy as np
import torch

HOP_MS = 20.0
SEARCH_MS = 10.0
COARSE_STEPS = 64

#: Default for new stretchers: run the correlation search on the device
#: (ops/wsola_search.py), one host round trip a hop.  Off by default, as in
#: the JAX package; ``mixer/stream.py``'s batched hop scan engages only
#: when it is on.
USE_DEVICE_SEARCH = False


def _cubic_read_mono(mono: np.ndarray, pos: np.ndarray, wrap: bool) -> np.ndarray:
    """Vectorized cubic read of a mono (L+R) signal at fractional positions."""
    L = len(mono)
    if wrap:
        pos = np.mod(pos, L)
    else:
        pos = np.clip(pos, 0.0, L - 1)
    idx = np.floor(pos).astype(np.int64)
    frac = (pos - idx).astype(np.float32)

    def tap(k):
        i = idx + k
        i = np.mod(i, L) if wrap else np.clip(i, 0, L - 1)
        return mono[i]

    p0, p1, p2, p3 = tap(-1), tap(0), tap(1), tap(2)
    a0 = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    a1 = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    a2 = -0.5 * p0 + 0.5 * p2
    return ((a0 * frac + a1) * frac + a2) * frac + p1


class WsolaHost:
    """Host-side hop scheduler + correlation search; emits device read
    plans.  ``device`` holds the mono signal for the device search."""

    def __init__(self, engine_sample_rate: float, initial_cursor: float,
                 use_device: bool | None = None, *, device):
        if use_device is None:
            use_device = USE_DEVICE_SEARCH
        sr = max(engine_sample_rate, 1.0)
        self.hop = max(int(round(HOP_MS / 1000.0 * sr)), 1)
        self.win = 2 * self.hop
        # periodic Hann: window[i] + window[hop+i] == 1 (COLA)
        i = np.arange(self.win)
        self.window = (np.sin(np.pi * i / self.win) ** 2).astype(np.float32)
        self.drain_idx = self.hop  # force synth before first drain
        self.analysis_cursor = float(initial_cursor)
        self.have_prev = False
        self.prev_start_v = 0.0   # previous grain start (virtual coords)
        self.prev_step = 1.0
        self._mono_cache = None
        self._mono_src = None
        self.use_device = use_device
        self.device = device
        self._mono_dev = None

    def _mono(self, buffer) -> np.ndarray:
        if self._mono_src is not buffer:
            self._mono_src = buffer
            self._mono_cache = (buffer.left + buffer.right).astype(np.float32)
        return self._mono_cache

    def _search(self, mono, window, center, step, max_start, wrap_reads) -> float:
        """Coarse-to-fine NCC search (wsola.rs:330-440), virtual coords."""
        radius = max(round(SEARCH_MS / 1000.0 * self._buffer_sr), 1.0)
        lo_b = max(center - radius, 0.0)
        hi_b = min(center + radius, max_start)
        if hi_b <= lo_b:
            return float(np.clip(center, 0.0, max_start))

        ref = self.prev_tail_mono
        i = np.arange(self.hop)

        def scores(cands):
            pos_v = np.clip(
                cands[:, None] + i[None, :] * step, 0.0, max_start + step
            )
            phys = self._to_physical(pos_v, window)
            cand = _cubic_read_mono(mono, phys.ravel(), wrap_reads).reshape(pos_v.shape)
            num = cand @ ref
            ce = np.einsum("ij,ij->i", cand, cand)
            re = float(ref @ ref)
            out = np.zeros(len(cands), np.float32)
            ok = (ce > np.finfo(np.float32).eps) & (re > np.finfo(np.float32).eps)
            out[ok] = num[ok] / (np.sqrt(re) * np.sqrt(ce[ok]))
            return out

        span = hi_b - lo_b
        stride = max(span / COARSE_STEPS, 1.0)
        coarse = np.arange(lo_b, hi_b + 1e-9, stride)

        if self.use_device:
            # the two stages + argmax on the device; the returned indices
            # map back through the host's own float64 candidate ranges
            ci, fi, fine_won = self._device_search(
                mono, window, lo_b, hi_b, stride, step, max_start,
                wrap_reads, len(coarse))
            ci = min(ci, len(coarse) - 1)
            best = float(coarse[ci])
            fine = np.arange(max(best - stride, lo_b),
                             min(best + stride, hi_b) + 1e-9, 1.0)
            if fine_won and len(fine):
                best = float(fine[min(fi, len(fine) - 1)])
            return best

        sc = scores(coarse)
        best = float(coarse[int(np.argmax(sc))])
        best_score = float(sc.max())
        fine = np.arange(max(best - stride, lo_b), min(best + stride, hi_b) + 1e-9, 1.0)
        sf = scores(fine)
        if sf.max() > best_score:
            best = float(fine[int(np.argmax(sf))])
        return best

    def _device_search(self, mono, window, lo_b, hi_b, stride, step,
                       max_start, wrap_reads, nc_valid):
        """Run ops.wsola_search.search_hop; returns (ci, fi, fine_won), read
        back from the device in one copy."""
        from libgooey_tpu_torch.ops import wsola_search as dws

        if self._mono_dev is None or self._mono_dev.shape[0] != len(mono):
            self._mono_dev = torch.as_tensor(mono, device=self.device)
        nf = 2 * int(np.ceil(max(
            round(SEARCH_MS / 1000.0 * self._buffer_sr) * 2.0 / COARSE_STEPS,
            1.0))) + 3
        wraps = bool(window.wraps)
        win_lo = np.float32(window.lo)
        win_len = np.float32(window.len if wraps else 1.0)
        res = dws.search_hop(
            self._mono_dev, torch.as_tensor(self.prev_tail_mono, device=self.device),
            np.float32(lo_b), np.float32(hi_b), np.float32(stride),
            np.float32(step), np.float32(max_start), win_lo, win_len,
            int(nc_valid), hop=self.hop, wrap=wraps, nc=COARSE_STEPS + 1, nf=nf)
        ci, fi, fw = res.tolist()
        return int(ci), int(fi), bool(fw)

    @staticmethod
    def _to_physical(pos_v, window):
        if window.wraps:
            return np.mod(window.lo + pos_v, window.len)
        return window.lo + pos_v

    def _synthesize_hop(self, buffer, window, sr_ratio, speed, warp):
        """One hop: returns (new_start_v, step) and updates search state."""
        self._buffer_sr = buffer.sample_rate
        mono = self._mono(buffer)
        span = window.span if window.wraps else (window.hi - window.lo)
        step = max(sr_ratio * max(speed, 0.0), 1e-6)
        hop_span = self.hop * step
        grain_span = (self.win - 1.0) * step + 1.0
        max_start = max(span - grain_span, 0.0)

        cursor_v = (
            window.to_virtual(self.analysis_cursor)
            if window.wraps
            else (self.analysis_cursor - window.lo)
        )
        raw_target = cursor_v + hop_span * max(warp, 0.0)
        if raw_target > max_start or max_start <= 0.0:
            search_center, wrapped = 0.0, True
        else:
            search_center, wrapped = max(raw_target, 0.0), False
        if wrapped:
            self.have_prev = False

        if self.have_prev:
            best = self._search(mono, window, search_center, step, max_start,
                                window.wraps)
        else:
            best = search_center

        # update the correlation reference: new grain's windowed second half
        i = np.arange(self.hop)
        pos_v = np.clip(best + (self.hop + i) * step, 0.0, span)
        phys = self._to_physical(pos_v, window)
        tail = _cubic_read_mono(mono, phys, window.wraps)
        self.prev_tail_mono = (tail * self.window[self.hop :]).astype(np.float32)

        self.prev_start_v = getattr(self, "cur_start_v", best)
        self.prev_step = getattr(self, "cur_step", step)
        self.had_prev_for_cur = self.have_prev
        self.cur_start_v = best
        self.cur_step = step
        self.have_prev = True
        self.drain_idx = 0
        self.analysis_cursor = float(self._to_physical(np.array([best]), window)[0])
        return best, step

    def plan_block(self, B: int, buffer, window, sr_ratio, speed, warp):
        """Plan B output samples → (positions[2, B], weights[2, B], cursor).

        Stream 0 = current grain's first half; stream 1 = previous grain's
        second half (the COLA partner).  Positions are physical frames.
        """
        positions = np.zeros((2, B), np.float64)
        weights = np.zeros((2, B), np.float32)
        n = 0
        while n < B:
            if self.drain_idx >= self.hop:
                self._synthesize_hop(buffer, window, sr_ratio, speed, warp)
            take = min(self.hop - self.drain_idx, B - n)
            i = np.arange(self.drain_idx, self.drain_idx + take)
            span = window.span
            cur_v = np.clip(self.cur_start_v + i * self.cur_step, 0.0, span)
            positions[0, n : n + take] = self._to_physical(cur_v, window)
            weights[0, n : n + take] = self.window[i]
            if self.had_prev_for_cur:
                prev_v = np.clip(
                    self.prev_start_v + (self.hop + i) * self.prev_step, 0.0, span
                )
                positions[1, n : n + take] = self._to_physical(prev_v, window)
                weights[1, n : n + take] = self.window[self.hop + i]
            self.drain_idx += take
            n += take
        return positions, weights, self.analysis_cursor
