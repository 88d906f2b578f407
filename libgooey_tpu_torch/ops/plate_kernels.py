"""The plate reverb's kernel beside its plain version.

Counterpart of the JAX package's Pallas wrapper:

===========  ======================================  ======================
wrapper      replaces (wrapper line, body)           caller in the port
===========  ======================================  ======================
plate_block  pallas_fx.py:1270, _plate_kernel        effects/reverb_plate
===========  ======================================  ======================

Dispatch as in :mod:`ops.bank_kernels`, with no fallback: a CUDA tensor
launches the hand-written kernel (``csrc/plate_kernels.cu``) or raises; a
CPU tensor takes ``plate_block_plain``, a sample-sequential PyTorch loop in
the Pallas body's per-sample op order (the Pallas body solves the one-poles
with log-depth scans, so it differs from it at float-noise level).  The
wrapper counts its kernel launches in ``plate_block.launches``.

The kernel is one block of 512 threads on the plain version's work rows:
the one-poles walked on one lane each, then the input diffusion and the
modulated allpasses in chunks of :func:`plate_chunk` samples, a thread a
sample (a chunk whose modulated lags fall below its length walks
serially).  The TPU kernel also takes per-chunk window bases for its
one-hot MXU gather of the modulated reads; a thread on the card reads its
work row at the lag directly, so they have no counterpart here
(tests/test_torch_bus_kernels.py shows the results agree without them).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from libgooey_tpu_torch.ops.bank_kernels import _F32, _check, _empty, _launch, _on_cuda
from libgooey_tpu_torch.ops.bus_kernels import _f32

KERNELS = ("plate_block",)
SOURCES = {"plate_block": "libgooey_tpu_torch/csrc/plate_kernels.cu"}
REPLACES = {"plate_block": "libgooey_tpu/ops/pallas_fx.py:1270"}

#: the kernel's chunk at most: a thread a (branch, sample) of a chunk's
#: modulated allpasses, in a block of 512 (csrc/plate_kernels.cu)
MAX_CHUNK = 256
#: shared memory a block can take on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448


@functools.lru_cache(maxsize=None)
def plate_constants(sample_rate: float):
    """``(floats, lags)`` of the sub-block path at ``sample_rate``, in the
    order of ``PlateConsts`` (csrc/plate_kernels.cu): the bandwidth pole and
    gain, the modulated allpasses' gain, the diffusion's gain product, its
    gains, ``1 - g^2``, the gain products before each section and the lags'
    fractions, each rounded once to float32 from the float64 the TPU
    kernel's static constants are computed in (pallas_fx.py:1302,1212-1224);
    then the lags' whole parts."""
    from libgooey_tpu_torch.effects import reverb_plate as plate

    srs = sample_rate / plate.DATTORRO_SR
    in_lags = [max(d * srs, 1.0) for d in plate.INPUT_AP_DELAYS]
    whole = [int(np.floor(o)) for o in in_lags]
    alpha, sdir = 1.0, []
    for g in plate.INPUT_AP_GAINS:
        sdir.append(alpha)
        alpha = alpha * g
    gains = plate.INPUT_AP_GAINS
    floats = ([_f32(1.0 - plate.INPUT_BANDWIDTH), _f32(plate.INPUT_BANDWIDTH),
               _f32(plate.DECAY_DIFFUSION_1), _f32(alpha)]
              + [_f32(g) for g in gains] + [_f32(1.0 - g * g) for g in gains]
              + [_f32(s) for s in sdir] + [_f32(o - w) for o, w in zip(in_lags, whole)])
    return tuple(floats), tuple(whole)


def plate_chunk(sample_rate: float) -> int:
    """The kernel's chunk: the smallest whole diffusion lag at
    ``sample_rate``, so that no sample of a chunk reads a diffusion column
    written in that chunk, capped at ``MAX_CHUNK`` (158 at 44.1 kHz)."""
    return min(min(plate_constants(sample_rate)[1]), MAX_CHUNK)


def smem_bytes(DIN: int, DMOD: int, B: int) -> int:
    """The kernel's shared memory (``PlateLayout``): the work rows, their
    pitches D + B rounded up to 4, and five [B] rows, four of them padded
    by four floats."""
    b4 = -(-B // 4) * 4
    rows = -(-(4 * (DIN + b4) + 2 * (DMOD + b4)) // 4) * 4
    return 4 * (rows + 5 * b4 + 16)


def plate_block_plain(delayed_in, fb_a_t, fb_b_t, damping_t, d1a_read, d1b_read, mod_off,
                      in_hist, mod_hist, seeds, *, sample_rate):
    """Plain version of the plate's sub-block recurrences
    (pallas_fx.py:1176-1263): the bandwidth and damping one-poles, the input
    diffusion in its affine form with static fractional lags, and the two
    modulated allpasses at the per-sample fractional lags ``mod_off``, on
    ``[4, DIN+B]`` / ``[2, DMOD+B]`` work buffers as the Pallas body lays
    them out."""
    f, lags = plate_constants(sample_rate)
    bw_a, bw_b, g1, alpha = f[:4]
    g, omg, sdir, frac = f[4:8], f[8:12], f[12:16], f[16:20]
    dev = delayed_in.device
    B, DIN, DMOD = delayed_in.shape[0], in_hist.shape[1], mod_hist.shape[1]

    # the three one-poles y = a*y + b: bandwidth, damping a, damping b
    a3 = torch.stack([torch.full_like(damping_t, bw_a), damping_t, damping_t])
    b3 = torch.stack([bw_b * delayed_in, d1a_read * (1.0 - damping_t),
                      d1b_read * (1.0 - damping_t)])
    y, ys = seeds, []
    for n in range(B):
        y = a3[:, n] * y + b3[:, n]
        ys.append(y)
    bw, da, db = torch.stack(ys, dim=1)

    W_in = torch.cat([in_hist, in_hist.new_zeros((4, B))], dim=1)
    rows = torch.arange(4, device=dev)
    lag = torch.as_tensor(lags, device=dev)
    fr = torch.as_tensor(frac, dtype=torch.float32, device=dev)
    g_t = torch.as_tensor(g, dtype=torch.float32, device=dev)
    sdir_t = torch.as_tensor(sdir, dtype=torch.float32, device=dev)
    sigs = []
    for n in range(B):
        av = W_in[rows, DIN + n - lag]
        bv = W_in[rows, DIN + n - lag - 1]
        dv = av + fr * (bv - av)
        beta, sadd = torch.zeros_like(bw[n]), []
        for i in range(4):
            sadd.append(beta)
            beta = g[i] * beta + omg[i] * dv[i]
        sigs.append(alpha * bw[n] + beta)
        W_in[:, DIN + n] = (sdir_t * bw[n] + torch.stack(sadd)) - g_t * dv
    sig = torch.stack(sigs)

    W_mod = torch.cat([mod_hist, mod_hist.new_zeros((2, B))], dim=1)
    whole = torch.floor(mod_off)
    mfrac = mod_off - whole
    mlag = whole.to(torch.int64)
    ins = torch.stack([sig + fb_b_t, sig + fb_a_t])
    rows2 = torch.arange(2, device=dev)
    outs = []
    for n in range(B):
        av = W_mod[rows2, DMOD + n - mlag[:, n]]
        bv = W_mod[rows2, DMOD + n - mlag[:, n] - 1]
        delayed = av + mfrac[:, n] * (bv - av)
        v = ins[:, n] - g1 * delayed
        outs.append(g1 * v + delayed)
        W_mod[:, DMOD + n] = v
    a1, b1 = torch.stack(outs, dim=1)
    return (a1, b1, da, db, W_in[:, B:B + DIN].clone(), W_mod[:, B:B + DMOD].clone(),
            torch.stack([bw[-1], da[-1], db[-1]]))


def plate_block(delayed_in, fb_a_t, fb_b_t, damping_t, d1a_read, d1b_read, mod_off,
                in_hist, mod_hist, seeds, *, sample_rate):
    """The plate's sub-block recurrences over one block.

    ``delayed_in``/``fb_a_t``/``fb_b_t``/``damping_t``/``d1a_read``/
    ``d1b_read``: [B]; ``mod_off``: [2, B] modulated-allpass lags, within
    [1, DMOD-2]; ``in_hist``: [4, DIN] and ``mod_hist``: [2, DMOD]
    right-aligned histories; ``seeds``: [3] = (bandwidth, damp_a, damp_b).
    Returns ``(a1, b1, da, db [B], in_hist', mod_hist', seeds' [3])``."""
    args = (delayed_in, fb_a_t, fb_b_t, damping_t, d1a_read, d1b_read, mod_off, in_hist,
            mod_hist, seeds)
    if not _on_cuda("plate_block", delayed_in):
        return plate_block_plain(*args, sample_rate=sample_rate)
    if delayed_in.dim() != 1 or delayed_in.shape[0] < 1:
        raise ValueError(f"plate_block: expected a non-empty [B] input, got "
                         f"{tuple(delayed_in.shape)}")
    B, DIN, DMOD = delayed_in.shape[0], in_hist.shape[-1], mod_hist.shape[-1]
    floats, lags = plate_constants(sample_rate)
    if max(lags) + 1 > DIN:
        raise ValueError(f"plate_block: diffusion lags {lags} do not fit a history of {DIN}")
    smem = smem_bytes(DIN, DMOD, B)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"plate_block: B={B} with histories of {DIN} and {DMOD} needs {smem} "
                         f"bytes of shared memory, more than a block has ({MAX_SMEM_BYTES})")
    labels = ("delayed_in", "fb_a_t", "fb_b_t", "damping_t", "d1a_read", "d1b_read")
    _check("plate_block", delayed_in.device,
           [(lb, t, _F32, (B,)) for lb, t in zip(labels, args)]
           + [("mod_off", mod_off, _F32, (2, B)), ("in_hist", in_hist, _F32, (4, DIN)),
              ("mod_hist", mod_hist, _F32, (2, DMOD)), ("seeds", seeds, _F32, (3,))])
    outs = tuple(_empty(shape, delayed_in) for shape in
                 ((B,), (B,), (B,), (B,), (4, DIN), (2, DMOD), (3,)))
    ptrs = (ctypes.c_void_p * 17)(*(t.data_ptr() for t in args + outs))
    c_floats = (ctypes.c_float * len(floats))(*floats)
    c_lags = (ctypes.c_int * len(lags))(*lags)
    _launch("plate_block", delayed_in.device, "plate_block_launch", ptrs, c_floats, c_lags,
            DIN, DMOD, B, plate_chunk(sample_rate))
    plate_block.launches += 1
    return outs


plate_block.launches = 0
