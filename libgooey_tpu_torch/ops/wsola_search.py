"""Device-side WSOLA correlation search (port of
libgooey_tpu/ops/wsola_search.py, plain PyTorch as the JAX package computes
it outside any kernel).

The coarse-to-fine normalized cross-correlation search
(src/mixer/wsola.rs:330-440) is a batched-dot problem: every candidate
offset's hop-length window against one reference tail,

    num[c] = cand[c, :] @ ref          (correlation)
    ce[c]  = einsum('ij,ij->i', cand, cand)   (candidate energy)

plus an argmax, at fixed shapes: the coarse stage evaluates ``NC =
COARSE_STEPS + 1`` candidates and the fine stage a fixed ``nf`` (invalid
candidates are masked to -inf, so the argmax ignores them, as the host's
variable-length ``np.arange`` ranges do).

It returns the chosen *indices* (coarse index, fine index, which stage
won), not positions: the host rebuilds the exact float64 candidate from its
own ``lo_b + idx * stride``, so the hop state equals the host search's
whenever the indices agree.  The three stay on the device as one int64
tensor, so the caller reads them back in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def _cubic_read(mono, pos, wrap: bool):
    """Catmull-Rom read at fractional positions (wsola._cubic_read_mono)."""
    L = mono.shape[0]
    pos = torch.remainder(pos, float(L)) if wrap else torch.clamp(pos, 0.0, L - 1.0)
    idx = torch.floor(pos).to(torch.int64)
    frac = pos - idx.to(torch.float32)

    def tap(k):
        i = idx + k
        i = torch.remainder(i, L) if wrap else torch.clamp(i, 0, L - 1)
        return mono[i]

    p0, p1, p2, p3 = tap(-1), tap(0), tap(1), tap(2)
    a0 = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    a1 = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    a2 = -0.5 * p0 + 0.5 * p2
    return ((a0 * frac + a1) * frac + a2) * frac + p1


def search_hop(mono, ref, lo_b, hi_b, stride, step, max_start,
               win_lo, win_len, nc_valid, *, hop: int, wrap: bool,
               nc: int, nf: int):
    """One coarse-to-fine NCC search on the device.

    Scalar arguments are float32 host values; ``mono`` is the cached device
    (L+R) signal and ``ref`` the windowed previous-grain tail ``[hop]``.
    ``nc_valid`` is the host's exact coarse candidate count
    (``len(np.arange(lo_b, hi_b + 1e-9, stride))`` in float64): candidate
    validity must NOT be a float32 comparison against ``hi_b + 1e-9``,
    because the 1e-9 tie epsilon vanishes below the float32 ulp at
    audio-buffer offsets and would drop the final candidate the host keeps.
    The fine count replicates ``np.arange``'s ceil semantics via a floor on
    the (small, exactly representable) fine span.  Returns an int64 tensor
    ``[coarse_idx, fine_idx, fine_won]``.
    """
    f32 = np.float32
    dev = mono.device
    i = torch.arange(hop, dtype=torch.float32, device=dev)
    re = ref @ ref
    step_f = float(f32(step))
    hi_clip = float(f32(max_start) + f32(step))
    win_lo_f, win_len_f = float(f32(win_lo)), float(f32(win_len))

    def scores(cands, valid):
        pos_v = torch.clamp(cands[:, None] + i[None, :] * step_f, 0.0, hi_clip)
        phys = (torch.remainder(win_lo_f + pos_v, win_len_f) if wrap
                else win_lo_f + pos_v)
        cand = _cubic_read(mono, phys.reshape(-1), wrap).reshape(pos_v.shape)
        num = cand @ ref
        ce = torch.einsum("ij,ij->i", cand, cand)
        ok = (ce > _EPS) & (re > _EPS)
        sc = torch.where(ok, num / (torch.sqrt(re) * torch.sqrt(ce)), 0.0)
        return torch.where(valid, sc, -torch.inf)

    stride_f = float(f32(stride))
    jc = torch.arange(nc, dtype=torch.float32, device=dev)
    cand_c = float(f32(lo_b)) + jc * stride_f
    sc = scores(cand_c, jc < float(f32(nc_valid)))
    ci = torch.argmax(sc)
    best_c, best_sc = cand_c[ci], sc[ci]

    f_lo = torch.clamp(best_c - stride_f, min=float(f32(lo_b)))
    f_hi = torch.clamp(best_c + stride_f, max=float(f32(hi_b)))
    jf = torch.arange(nf, dtype=torch.float32, device=dev)
    cand_f = f_lo + jf
    nf_valid = torch.floor(f_hi - f_lo + 1e-9) + 1.0
    sf = scores(cand_f, jf < nf_valid)
    fi = torch.argmax(sf)
    return torch.stack([ci, fi, (sf[fi] > best_sc).to(torch.int64)])
