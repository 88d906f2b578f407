"""The granulator's and the sampler's buffer reads, each beside its plain
version.

Counterparts of the JAX package's Pallas wrappers (ops/pallas_grain.py):

===================  ====================================  ===========================
wrapper              replaces (wrapper line, body)         caller in the port
===================  ====================================  ===========================
grain_read_cubic     pallas_grain.py:214, _kernel          instruments/granulator
sampler_read_linear  pallas_grain.py:386, _kernel_lin      instruments/sampler
===================  ====================================  ===========================

Both compute the JAX package's gather path, the semantics its Pallas
kernels are held to (``pallas_grain.gather_read_cubic``; the gather branch
of ``sampler.render_block``), op for op.  The Pallas wrappers also clip the
step to ±``MAX_STEP`` (~7.02) and the increment to ±4, limits of their TPU
window tiers; the gather paths and these reads do not clip, so a grain at
the pitch map's 4x on a 96 kHz buffer (|step| ~8.7) reads where the
reference reads.  Indices never leave the source: a non-finite grain start
maps as the Pallas wrapper maps it (``pallas_grain.py:237``), a NaN
position reads the first sample, and the sampler's arena index is clamped
to ``[0, F-1]`` (JAX clamps an out-of-range gather; PyTorch would fault).

Dispatch as in :mod:`ops.bank_kernels`, with no fallback: a CUDA tensor
launches the hand-written kernel (``csrc/grain_kernels.cu``) or raises; a
CPU tensor takes the ``*_plain`` version.  Each wrapper counts its launches
in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from libgooey_tpu_torch.ops.bank_kernels import _F32, _check, _empty, _launch, _on_cuda, _ptr

KERNELS = ("grain_read_cubic", "sampler_read_linear")
_SRC = "libgooey_tpu_torch/csrc/grain_kernels.cu"
SOURCES = {name: _SRC for name in KERNELS}
REPLACES = {"grain_read_cubic": "libgooey_tpu/ops/pallas_grain.py:214",
            "sampler_read_linear": "libgooey_tpu/ops/pallas_grain.py:386"}

_I32 = torch.int32


def wrap_i32(x: int) -> int:
    """A Python integer as the int32 it wraps to (XLA's and the kernels'
    int32 arithmetic)."""
    return ((int(x) + 2**31) % 2**32) - 2**31


def _nan_to_zero(x):
    """NaN -> 0, as ``fmaxf(x, 0)`` in the kernels treats it."""
    return torch.where(torch.isnan(x), 0.0, x)


# --- grain_read_cubic -----------------------------------------------------------


def grain_read_cubic_plain(buffer, p0, step, *, B: int, age0=None):
    """Plain version: Catmull-Rom reads at ``clip(p0 + step*age, 0, L-1)``
    with ``age = f32(age0 + n)`` (``n`` without ``age0``), each tap clamped
    to the buffer, in the gather path's Horner form
    (pallas_grain.py:263-278, granulator.py:244,271-282)."""
    L = buffer.shape[0]
    n = torch.arange(B, dtype=_I32, device=p0.device)
    age = (n if age0 is None else age0[:, None] + n[None, :]).to(_F32)
    p0 = torch.nan_to_num(p0, nan=0.0, posinf=3e38, neginf=-3e38)
    pos = _nan_to_zero(torch.clamp(p0[:, None] + step[:, None] * age, 0.0, float(L - 1)))
    i1f = torch.floor(pos)
    f = pos - i1f
    i1 = i1f.to(torch.int64)
    t0 = buffer[torch.clamp(i1 - 1, min=0)]
    t1 = buffer[i1]
    t2 = buffer[torch.clamp(i1 + 1, max=L - 1)]
    t3 = buffer[torch.clamp(i1 + 2, max=L - 1)]
    a0 = -0.5 * t0 + 1.5 * t1 - 1.5 * t2 + 0.5 * t3
    a1 = t0 - 2.5 * t1 + 2.0 * t2 - 0.5 * t3
    a2 = -0.5 * t0 + 0.5 * t2
    return ((a0 * f + a1) * f + a2) * f + t1


def grain_read_cubic(buffer, p0, step, *, B: int, age0=None):
    """Per-grain cubic reads of the mono ``buffer`` [L] -> ``[G, B]``.

    ``p0``/``step``: [G] float32 start position and per-sample step;
    ``age0``: [G] int32 samples since each grain's start at the block's
    first sample, or None for ``age = n``.  With ``p0 = src_pos`` and
    ``age0 = block_start - spawn_sample`` this is the granulator's read."""
    if not _on_cuda("grain_read_cubic", p0):
        return grain_read_cubic_plain(buffer, p0, step, B=B, age0=age0)
    L, G = buffer.shape[0], p0.shape[0]
    if buffer.dim() != 1 or L < 1 or G < 1 or B < 1:
        raise ValueError(f"grain_read_cubic: expected a non-empty [L] buffer, [G] grains and "
                         f"B >= 1, got {tuple(buffer.shape)}, {tuple(p0.shape)}, B={B}")
    _check("grain_read_cubic", p0.device, [
        ("buffer", buffer, _F32, (L,)), ("p0", p0, _F32, (G,)), ("step", step, _F32, (G,)),
        ("age0", age0, _I32, (G,))])
    out = _empty((G, B), p0)
    _launch("grain_read_cubic", p0.device, "grain_read_cubic_launch",
            buffer.data_ptr(), p0.data_ptr(), step.data_ptr(), _ptr(age0), out.data_ptr(),
            L, G, B)
    grain_read_cubic.launches += 1
    return out


grain_read_cubic.launches = 0


# --- sampler_read_linear ----------------------------------------------------------


def sampler_read_linear_plain(arena, base, frames, start, inc, block_start, *, B: int):
    """Plain version of the sampler's gather branch (sampler.py:111-132):
    ``age = f32(block_start + n - start)``, ``posc = clip(age*inc, 0,
    end-1)``, taps ``i0 = floor(posc)`` and ``min(i0+1, trunc(end-1))``
    relative to ``base``, ``f0 + (f1 - f0)*frac``."""
    F = arena.shape[0]
    n = torch.arange(B, dtype=_I32, device=arena.device)
    age = ((n + wrap_i32(block_start))[None, :] - start[:, None]).to(_F32)
    em1 = frames[:, None] - 1.0
    posc = torch.minimum(_nan_to_zero(torch.clamp(age * inc[:, None], min=0.0)), em1)
    i0f = torch.floor(posc)
    frac = posc - i0f
    i0 = i0f.to(_I32)
    i1 = torch.minimum(i0 + 1, em1.to(_I32))
    b = base[:, None]
    f0 = arena[torch.clamp(b + i0, 0, F - 1).to(torch.int64)]
    f1 = arena[torch.clamp(b + i1, 0, F - 1).to(torch.int64)]
    return f0 + (f1 - f0) * frac[..., None]


def sampler_read_linear(arena, base, frames, start, inc, block_start, *, B: int):
    """Per-voice stereo linear reads of the interleaved ``arena`` [F, 2] ->
    ``[V, B, 2]``.

    ``base``/``start``: [V] int32 slot offset in the arena and the voice's
    start sample; ``frames``/``inc``: [V] float32 slot length and increment;
    ``block_start``: the block's first sample (a host integer)."""
    if not _on_cuda("sampler_read_linear", arena):
        return sampler_read_linear_plain(arena, base, frames, start, inc, block_start, B=B)
    F, V = arena.shape[0], base.shape[0]
    if arena.dim() != 2 or F < 1 or V < 1 or B < 1:
        raise ValueError(f"sampler_read_linear: expected a non-empty [F, 2] arena, [V] voices "
                         f"and B >= 1, got {tuple(arena.shape)}, {tuple(base.shape)}, B={B}")
    _check("sampler_read_linear", arena.device, [
        ("arena", arena, _F32, (F, 2)), ("base", base, _I32, (V,)),
        ("frames", frames, _F32, (V,)), ("start", start, _I32, (V,)), ("inc", inc, _F32, (V,))])
    out = _empty((V, B, 2), arena)
    _launch("sampler_read_linear", arena.device, "sampler_read_linear_launch",
            arena.data_ptr(), base.data_ptr(), frames.data_ptr(), start.data_ptr(),
            inc.data_ptr(), out.data_ptr(), wrap_i32(block_start), F, V, B)
    sampler_read_linear.launches += 1
    return out


sampler_read_linear.launches = 0
