"""The eight kernels of the five-family kit and the engine's mix kernel, each
beside its plain version.

Counterparts of the JAX package's Pallas wrappers:

======================  ==============================================  ==========================
wrapper                 replaces (wrapper line, body)                   callers in the port
======================  ==============================================  ==========================
affine1_bank            pallas_fx.py:2275, _affine1_bank_kernel         ops/scan (linrec1, maxlin,
                                                                        cumsum_bank); also
                                                                        pallas_scan.py:60's
                                                                        linrec1_pallas
pink_bank               pallas_fx.py:2003, _pink_bank_kernel            ops/noise.pink_block
svf_bank                pallas_fx.py:1499, _svf_bank_kernel             ops/filters.svf_tpt_block
env_follow_bank         pallas_fx.py:1396, _env_bank_kernel             feedback_waveshaper
fbws_bank               pallas_fx.py:1769, _fbws_bank_kernel            feedback_waveshaper
ws4_bank                pallas_fx.py:1921, _ws4_bank_kernel             effects/waveshaper
linrec2_bank            pallas_fx.py:2201, _linrec2_bank_kernel         ops/scan.linrec2
triangle_additive_bank  pallas_voice.py:127, _tri_bank_kernel           ops/osc.triangle_additive
mix_bank                pallas_fx.py:2102, _mix_bank_kernel             engine._render_all
======================  ==============================================  ==========================

Dispatch, with no fallback: a CUDA tensor launches the hand-written kernel
(``csrc/*.cu``, built at first use by ``ops/_build.py``) or raises; a CPU
tensor takes the ``*_plain`` version, a sample-sequential PyTorch loop in
the Pallas body's op order (an elementwise pass for the triangle, the mix's
sums over voices in the kernel's order).  Every
wrapper counts its kernel launches in a plain int attribute
(``affine1_bank.launches``, read through :mod:`ops.kernels`); a wrapper and
its plain version take the same arguments.

All arrays are float32 in the JAX package's ``[V, B]`` layout; masks are
bool ``[V, B]``.  What bounds each kernel on the card and what its design does
about it is in the header of its CUDA source.  Every recurrence runs one
thread with the state in registers, in the Pallas body's op order.
``affine1_bank``, ``pink_bank``, ``svf_bank``, ``env_follow_bank`` and
``linrec2_bank`` are staged (``csrc/row_stage.cuh``): a block walks up to 32
rows from 64-sample tiles that its other warps copy into shared memory ahead
of the walk (the pink filter's and the SVF's reset masks and the follower's
freeze mask as bytes), and :func:`stage_rows` sizes the blocks so that a
launch spreads over the SMs; ``affine1_bank(None, ...)`` reads no floor
array.  ``ws4_bank`` and ``fbws_bank`` split their 4x chain over the warps
of a block of up to 32 rows: the up-walk, the shaper (``ws4_bank``'s with
the drive's gain), the down-walk (``fbws_bank``'s with the gated DC
blocker).  ``mix_bank`` takes a block per (256-voice chunk, 32-sample
tile), a settled pan's cosine and sine once, and sums each chunk in voice
order.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import pow_table, settle_snap
from libgooey_tpu_torch.ops import _build
from libgooey_tpu_torch.ops.oversample import STAGE1, STAGE2, HalfbandState, _split

#: the eight kernels of the kit's voice banks (all on its per-family path)
#: and the engine's mix
KERNELS = ("affine1_bank", "pink_bank", "svf_bank", "env_follow_bank", "fbws_bank",
           "ws4_bank", "linrec2_bank", "triangle_additive_bank", "mix_bank")

#: Source of each kernel and the TPU kernel it replaces (file:line of the
#: wrapper that reaches ``pl.pallas_call``).
_BANK_SRC = "libgooey_tpu_torch/csrc/bank_kernels.cu"
SOURCES = {name: _BANK_SRC for name in KERNELS}
SOURCES["triangle_additive_bank"] = "libgooey_tpu_torch/csrc/osc_kernels.cu"
REPLACES = {
    "affine1_bank": "libgooey_tpu/ops/pallas_fx.py:2275",
    "pink_bank": "libgooey_tpu/ops/pallas_fx.py:2003",
    "svf_bank": "libgooey_tpu/ops/pallas_fx.py:1499",
    "env_follow_bank": "libgooey_tpu/ops/pallas_fx.py:1396",
    "fbws_bank": "libgooey_tpu/ops/pallas_fx.py:1769",
    "ws4_bank": "libgooey_tpu/ops/pallas_fx.py:1921",
    "linrec2_bank": "libgooey_tpu/ops/pallas_fx.py:2201",
    "triangle_additive_bank": "libgooey_tpu/ops/pallas_voice.py:127",
    "mix_bank": "libgooey_tpu/ops/pallas_fx.py:2102",
}


# --- dispatch and launch helpers ----------------------------------------------


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for tensors on {t.device}")


def _check(name: str, device, specs):
    """Validate ``(label, tensor, dtype, shape)`` specs for a launch; a
    ``None`` tensor is an absent optional input."""
    for label, t, dtype, shape in specs:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _host_floats(values):
    """A float32 host array for a C entry's coefficient pointer."""
    arr = (ctypes.c_float * len(values))(*values)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _launch(name: str, device, entry: str, *args):
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _empty(shape, like: torch.Tensor):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def _vb(name, x):
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name}: expected a non-empty [V, B] tensor, got {tuple(x.shape)}")
    return x.shape


_F32 = torch.float32


def _div(a, b):
    """``a / b`` for a Python number ``b``, a true division on every device
    (PyTorch on the card multiplies by the reciprocal of a Python divisor)."""
    return a / torch.full((), b, dtype=_F32, device=a.device)


# --- the staged kernels' launch geometry ------------------------------------

#: rows a block of a staged kernel walks at most (one warp of walkers;
#: ``csrc/row_stage.cuh`` kStageMaxRows)
STAGE_MAX_ROWS = 32


def stage_rows(R: int, n_sm: int) -> int:
    """Rows per block of a staged kernel (``affine1_bank``, ``pink_bank``,
    ``svf_bank``, ``env_follow_bank``, ``linrec2_bank``) and of the split
    ones (``ws4_bank``, ``fbws_bank``): the fewest that keep a launch of
    ``R`` rows within one block per SM, at most one warp, so the launch
    spreads over ``min(R, n_sm)`` SMs (4 at 512 rows on 132 SMs, 8 at
    1,024, 20 at 2,560, 32 at 4,096; 1 at one row)."""
    return max(1, min(STAGE_MAX_ROWS, -(-R // n_sm)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def copies_16b(B: int, *arrays) -> bool:
    """Whether a staged launch copies 16 bytes at a time: ``B % 4 == 0`` and
    every array (``None``: absent) starts 16-byte aligned, so every row does;
    else it copies 4 bytes at a time."""
    return B % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in arrays if t is not None)


def _stage_args(R: int, B: int, device, *arrays):
    """The staged C entries' ``rc, vec``: rows per block, 16-byte copies."""
    return stage_rows(R, _sm_count(device.index)), int(copies_16b(B, *arrays))


# --- 1. affine1_bank ------------------------------------------------------------

#: the floor that disables the max branch of ``affine1_bank`` (``a = None``)
NO_FLOOR = -3.0e38


def affine1_bank_plain(a, b, c, y0):
    """Plain version: ``y[n] = max(a[n], b[n]*y[n-1] + c[n])``; ``a = None``
    is a floor row of ``NO_FLOOR``, laid out as ``a`` would be so that the
    maximum gives the same bits (PyTorch's CPU maximum returns a NaN's
    payload differently when one side broadcasts)."""
    if a is None:
        a = torch.full_like(b, NO_FLOOR)
    aT, bT, cT = a.t(), b.t(), c.t()
    y = y0
    ys = []
    for n in range(bT.shape[0]):
        y = torch.maximum(aT[n], bT[n] * y + cT[n])
        ys.append(y)
    return torch.stack(ys, dim=1), y


def affine1_bank(a, b, c, y0):
    """Voice-bank ``y[n] = max(a[n], b[n]*y[n-1] + c[n])`` over ``[V, B]``.

    ``a = None`` is the plain first-order recurrence: no floor array is read,
    and the result is that of ``a = NO_FLOOR`` everywhere, bit for bit.
    Returns ``(y [V, B], y_last [V])``."""
    if not _on_cuda("affine1_bank", b):
        return affine1_bank_plain(a, b, c, y0)
    V, B = _vb("affine1_bank", b)
    _check("affine1_bank", b.device, [
        ("a", a, _F32, (V, B)), ("b", b, _F32, (V, B)), ("c", c, _F32, (V, B)),
        ("y0", y0, _F32, (V,))])
    y, y_last = _empty((V, B), b), _empty((V,), b)
    _launch("affine1_bank", b.device, "affine1_bank_launch",
            _ptr(a), b.data_ptr(), c.data_ptr(), y0.data_ptr(),
            y.data_ptr(), y_last.data_ptr(), V, B, *_stage_args(V, B, b.device, a, b, c, y))
    affine1_bank.launches += 1
    return y, y_last


affine1_bank.launches = 0


# --- 2. pink_bank ---------------------------------------------------------------


def pink_bank_plain(w, reset, fstate, *, poles, gains, direct, outg):
    """Plain version: three one-poles (zeroed at resets) plus the direct term."""
    wT = w.t()
    rT = None if reset is None else reset.t()
    ys = [fstate[:, i] for i in range(3)]
    outs = []
    for n in range(wT.shape[0]):
        wn = wT[n]
        for i in range(3):
            fb = poles[i] * ys[i]
            if rT is not None:
                fb = torch.where(rT[n], 0.0, fb)
            ys[i] = fb + gains[i] * wn
        outs.append((ys[0] + ys[1] + ys[2] + direct * wn) * outg)
    return torch.stack(outs, dim=1), torch.stack(ys, dim=1)


def pink_bank(w, reset, fstate, *, poles, gains, direct, outg):
    """Voice-bank Kellet pink-noise filter block.

    ``w``: [V, B] white input; ``reset``: [V, B] bool trigger mask or None;
    ``fstate``: [V, 3] carried one-pole states; ``poles``/``gains``:
    3-tuples from ``noise.coefficients``.  Returns ``(pink [V, B], fstate' [V, 3])``."""
    if not _on_cuda("pink_bank", w):
        return pink_bank_plain(w, reset, fstate, poles=poles, gains=gains,
                               direct=direct, outg=outg)
    V, B = _vb("pink_bank", w)
    _check("pink_bank", w.device, [
        ("w", w, _F32, (V, B)), ("reset", reset, torch.bool, (V, B)),
        ("fstate", fstate, _F32, (V, 3))])
    pink, fout = _empty((V, B), w), _empty((V, 3), w)
    keep, coefs = _host_floats([*poles, *gains, direct, outg])
    _launch("pink_bank", w.device, "pink_bank_launch",
            w.data_ptr(), _ptr(reset), fstate.data_ptr(), pink.data_ptr(),
            fout.data_ptr(), coefs, V, B, *_stage_args(V, B, w.device, w, pink))
    del keep
    pink_bank.launches += 1
    return pink, fout


pink_bank.launches = 0


# --- 3. svf_bank ----------------------------------------------------------------


def svf_bank_plain(x, g, h, reset, ic1, ic2):
    """Plain version of the TPT SVF step (pallas_fx.py:1477-1490 op order)."""
    xT, gT, hT = x.t(), g.t(), h.t()
    rT = None if reset is None else reset.t()
    v1s, v2s = [], []
    for n in range(xT.shape[0]):
        if rT is not None:
            ic1 = torch.where(rT[n], 0.0, ic1)
            ic2 = torch.where(rT[n], 0.0, ic2)
        v1 = (gT[n] * (xT[n] - ic2) + ic1) * hT[n]
        v2 = ic2 + gT[n] * v1
        v1s.append(v1)
        v2s.append(v2)
        ic1 = 2.0 * v1 - ic1
        ic2 = 2.0 * v2 - ic2
    return torch.stack(v1s, dim=1), torch.stack(v2s, dim=1), ic1, ic2


def svf_bank(x, g, h, reset, ic1, ic2):
    """Voice-bank TPT SVF block.

    ``x``/``g``/``h``: [V, B] input and per-sample coefficients;
    ``reset``: [V, B] bool or None; ``ic1``/``ic2``: [V] carried state.
    Returns ``(v1 [V, B], v2 [V, B], ic1' [V], ic2' [V])`` with the
    pre-update band/low taps."""
    if not _on_cuda("svf_bank", x):
        return svf_bank_plain(x, g, h, reset, ic1, ic2)
    V, B = _vb("svf_bank", x)
    _check("svf_bank", x.device, [
        ("x", x, _F32, (V, B)), ("g", g, _F32, (V, B)), ("h", h, _F32, (V, B)),
        ("reset", reset, torch.bool, (V, B)),
        ("ic1", ic1, _F32, (V,)), ("ic2", ic2, _F32, (V,))])
    v1, v2 = _empty((V, B), x), _empty((V, B), x)
    ic1o, ic2o = _empty((V,), x), _empty((V,), x)
    _launch("svf_bank", x.device, "svf_bank_launch",
            x.data_ptr(), g.data_ptr(), h.data_ptr(), _ptr(reset),
            ic1.data_ptr(), ic2.data_ptr(), v1.data_ptr(), v2.data_ptr(),
            ic1o.data_ptr(), ic2o.data_ptr(), V, B,
            *_stage_args(V, B, x.device, x, g, h, v1, v2))
    svf_bank.launches += 1
    return v1, v2, ic1o, ic2o


svf_bank.launches = 0


# --- 4. env_follow_bank ---------------------------------------------------------


def env_follow_bank_plain(rect, freeze, env0, *, att, rel):
    """Plain version: ``env += (1-c)(rect - env)``, c = att if rect > env
    else rel, flush below 1e-15, state held where ``freeze``."""
    rT, fT = rect.t(), freeze.t()
    env = env0
    outs = []
    for n in range(rT.shape[0]):
        r = rT[n]
        c = torch.where(r > env, float(np.float32(att)), float(np.float32(rel)))
        new = env + (1.0 - c) * (r - env)
        new = torch.where(new.abs() < 1e-15, 0.0, new)
        env = torch.where(fT[n], env, new)
        outs.append(env)
    return torch.stack(outs, dim=1), env


def env_follow_bank(rect, freeze, env0, *, att, rel):
    """Voice-bank attack/release envelope follower.

    ``rect``: [V, B] rectified input; ``freeze``: [V, B] bool bypass mask;
    ``env0``: [V]; ``att``/``rel``: scalar retention factors.
    Returns ``(env [V, B], env_last [V])``."""
    if not _on_cuda("env_follow_bank", rect):
        return env_follow_bank_plain(rect, freeze, env0, att=att, rel=rel)
    V, B = _vb("env_follow_bank", rect)
    _check("env_follow_bank", rect.device, [
        ("rect", rect, _F32, (V, B)), ("freeze", freeze, torch.bool, (V, B)),
        ("env0", env0, _F32, (V,))])
    env, env_last = _empty((V, B), rect), _empty((V,), rect)
    _launch("env_follow_bank", rect.device, "env_follow_bank_launch",
            rect.data_ptr(), freeze.data_ptr(), env0.data_ptr(),
            env.data_ptr(), env_last.data_ptr(), float(att), float(rel), V, B,
            *_stage_args(V, B, rect.device, rect, env))
    env_follow_bank.launches += 1
    return env, env_last


env_follow_bank.launches = 0


# --- 5. fbws_bank ---------------------------------------------------------------

#: (name, rows) of the packed ``[S, V]`` state, kernel I/O order (the
#: layout of pallas_fx.py:1572-1599).  u/d = up/down, 1/2 = half-band
#: stage, y/x = section output/input memories, trailing 0/1 = polyphase
#: branch; *x1d = the down-samplers' odd-phase input delay; dc = DC blocker.
FBWS_CORE_LAYOUT = (
    ("u1y0", 4), ("u1x0", 4), ("u1y1", 4), ("u1x1", 4),
    ("u2y0", 2), ("u2x0", 2), ("u2y1", 2), ("u2x1", 2),
    ("d2y0", 2), ("d2x0", 2), ("d2y1", 2), ("d2x1", 2), ("d2x1d", 1),
    ("d1y0", 4), ("d1x0", 4), ("d1y1", 4), ("d1x1", 4), ("d1x1d", 1),
    ("dcx", 1), ("dcy", 1),
)
#: second-to-last section outputs/inputs (HalfbandState.*y2/*x2), appended
#: to the OUTPUT state only.
FBWS_Y2_LAYOUT = (
    ("u1y2_0", 4), ("u1x2_0", 4), ("u1y2_1", 4), ("u1x2_1", 4),
    ("u2y2_0", 2), ("u2x2_0", 2), ("u2y2_1", 2), ("u2x2_1", 2),
    ("d2y2_0", 2), ("d2x2_0", 2), ("d2y2_1", 2), ("d2x2_1", 2),
    ("d1y2_0", 4), ("d1x2_0", 4), ("d1y2_1", 4), ("d1x2_1", 4),
)


def _layout_index(layout):
    idx, k = {}, 0
    for name, n in layout:
        idx[name] = (k, n)
        k += n
    return idx, k


FBWS_IN_IDX, FBWS_S_IN = _layout_index(FBWS_CORE_LAYOUT)
FBWS_OUT_IDX, FBWS_S_OUT = _layout_index(FBWS_CORE_LAYOUT + FBWS_Y2_LAYOUT)

#: phase-split half-band coefficients, cast once to float32
_C1_0, _C1_1 = (tuple(float(np.float32(c)) for c in p) for p in _split(STAGE1))
_C2_0, _C2_1 = (tuple(float(np.float32(c)) for c in p) for p in _split(STAGE2))
_FBWS_COEFS = _C1_0 + _C1_1 + _C2_0 + _C2_1
_DC = 0.995


def _ap_chain_seq(u, ys, xs, coefs):
    """One sample through a chain of allpasses ``y = a*(x - y1) + x1``."""
    ys, xs = list(ys), list(xs)
    for j, a in enumerate(coefs):
        y = a * (u - ys[j]) + xs[j]
        xs[j] = u
        ys[j] = y
        u = y
    return u, ys, xs


def ovs4_plain(uT, packed, shaper, finish):
    """The sample loop shared by the fbws, ws4 and saturation plain versions: 4x
    polyphase up, ``shaper(n, s)`` at each 2x/4x subsample of base sample
    ``n``, down; ``finish(c, n, y)`` turns the chain's base-rate output into
    the kernel's output.  Returns ``(out [V, B], packed' [100, V])``."""
    B = uT.shape[0]

    def ld(name):
        k, n = FBWS_IN_IDX[name]
        return packed[k] if n == 1 else [packed[k + j] for j in range(n)]

    c = {name: ld(name) for name, _ in FBWS_CORE_LAYOUT}

    def phase_a(c, n):
        e1, c["u1y0"], c["u1x0"] = _ap_chain_seq(uT[n], c["u1y0"], c["u1x0"], _C1_0)
        o1, c["u1y1"], c["u1x1"] = _ap_chain_seq(uT[n], c["u1y1"], c["u1x1"], _C1_1)
        s0, c["u2y0"], c["u2x0"] = _ap_chain_seq(e1, c["u2y0"], c["u2x0"], _C2_0)
        s1, c["u2y1"], c["u2x1"] = _ap_chain_seq(e1, c["u2y1"], c["u2x1"], _C2_1)
        t0, t1 = shaper(n, s0), shaper(n, s1)
        a0, c["d2y0"], c["d2x0"] = _ap_chain_seq(t0, c["d2y0"], c["d2x0"], _C2_0)
        a1, c["d2y1"], c["d2x1"] = _ap_chain_seq(c["d2x1d"], c["d2y1"], c["d2x1"], _C2_1)
        c["d2x1d"] = t1
        return o1, 0.5 * (a0 + a1)

    def phase_b(c, n, o1, d0):
        s2, c["u2y0"], c["u2x0"] = _ap_chain_seq(o1, c["u2y0"], c["u2x0"], _C2_0)
        s3, c["u2y1"], c["u2x1"] = _ap_chain_seq(o1, c["u2y1"], c["u2x1"], _C2_1)
        t2, t3 = shaper(n, s2), shaper(n, s3)
        b0, c["d2y0"], c["d2x0"] = _ap_chain_seq(t2, c["d2y0"], c["d2x0"], _C2_0)
        b1, c["d2y1"], c["d2x1"] = _ap_chain_seq(c["d2x1d"], c["d2y1"], c["d2x1"], _C2_1)
        d1 = 0.5 * (b0 + b1)
        c["d2x1d"] = t3
        e0, c["d1y0"], c["d1x0"] = _ap_chain_seq(d0, c["d1y0"], c["d1x0"], _C1_0)
        e1, c["d1y1"], c["d1x1"] = _ap_chain_seq(c["d1x1d"], c["d1y1"], c["d1x1"], _C1_1)
        c["d1x1d"] = d1
        return finish(c, n, 0.5 * (e0 + e1))

    outs = []
    for n in range(B - 1):
        o1, d0 = phase_a(c, n)
        outs.append(phase_b(c, n, o1, d0))
    # final step with second-to-last captures (pallas_fx.py:1697-1713)
    caps = {}
    for tag in ("u1", "d1"):
        for st, cap in (("y0", "y2_0"), ("x0", "x2_0"), ("y1", "y2_1"), ("x1", "x2_1")):
            caps[tag + cap] = list(c[tag + st])
    o1, d0 = phase_a(c, B - 1)
    for tag in ("u2", "d2"):
        for st, cap in (("y0", "y2_0"), ("x0", "x2_0"), ("y1", "y2_1"), ("x1", "x2_1")):
            caps[tag + cap] = list(c[tag + st])
    outs.append(phase_b(c, B - 1, o1, d0))

    vals = {**c, **caps}
    rows = []
    for name, n in FBWS_CORE_LAYOUT + FBWS_Y2_LAYOUT:
        rows += [vals[name]] if n == 1 else list(vals[name])
    return torch.stack(outs, dim=1), torch.stack(rows, dim=0)


def gated_dc(cT):
    """``finish`` for :func:`ovs4_plain`: the bypass-gated DC blocker of
    ``y * cs`` with ``cs = cT[n]`` per row (``cs < 0`` marks a bypassed
    sample: state frozen, output 0), as ``gated_dc`` in csrc/ovs4.cuh."""

    def dc_block(c, n, y):
        cs = cT[n]
        byp = cs < 0.0
        compensated = y * torch.clamp(cs, min=0.0)
        x1_prev = c["dcx"]
        c["dcx"] = torch.where(byp, x1_prev, compensated)
        y1_new = _DC * c["dcy"] + (compensated - x1_prev)
        c["dcy"] = torch.where(byp, c["dcy"], y1_new)
        return torch.where(byp, 0.0, c["dcy"])

    return dc_block


def fbws_bank_plain(u, comp_signed, packed):
    """Plain version of the fused zero-feedback waveshaper (pallas_fx.py:1611-1713):
    4x polyphase up, tanh, down, signed makeup gain, gated DC blocker."""
    return ovs4_plain(u.t(), packed, lambda n, s: torch.tanh(s), gated_dc(comp_signed.t()))


def fbws_bank(u, comp_signed, packed):
    """Fused voice-bank feedback-waveshaper fast path.

    ``u``: [V, B] pre-driven input (drive*x); ``comp_signed``: [V, B]
    makeup gain with bypass as sign (< 0 => bypassed sample); ``packed``:
    [52, V] from :func:`pack_fbws_bank`.  Returns ``(dc [V, B],
    new_packed [100, V])`` for :func:`unpack_fbws_bank`."""
    if not _on_cuda("fbws_bank", u):
        return fbws_bank_plain(u, comp_signed, packed)
    V, B = _vb("fbws_bank", u)
    _check("fbws_bank", u.device, [
        ("u", u, _F32, (V, B)), ("comp_signed", comp_signed, _F32, (V, B)),
        ("packed", packed, _F32, (FBWS_S_IN, V))])
    dc, nst = _empty((V, B), u), _empty((FBWS_S_OUT, V), u)
    keep, coefs = _host_floats(_FBWS_COEFS)
    _launch("fbws_bank", u.device, "fbws_bank_launch",
            u.data_ptr(), comp_signed.data_ptr(), packed.data_ptr(),
            dc.data_ptr(), nst.data_ptr(), coefs, V, B,
            *_stage_args(V, B, u.device, u, comp_signed, dc))
    del keep
    fbws_bank.launches += 1
    return dc, nst


fbws_bank.launches = 0


# --- 6. ws4_bank ----------------------------------------------------------------


_TANH_HALF = float(torch.tanh(torch.tensor(0.5, dtype=torch.float32)))


def _ws4_gain(drive):
    """``(d, comp)``: the drive floored at 1 + 1e-6 and the makeup gain
    ``tanh(0.5) / tanh(0.5 d)`` (pallas_fx.py:1936-1937), as the kernel
    computes them per engine sample (its ``tanh(0.5)`` is this module's
    ``_TANH_HALF``)."""
    d = torch.clamp(drive, min=1.0 + 1e-6)
    # a true division: a Python scalar over a tensor would multiply by the
    # reciprocal and round twice
    comp = torch.full_like(d, _TANH_HALF) / torch.tanh(0.5 * d)
    return d, comp


def ws4_bank_plain(x, drive, packed):
    """Plain version of the 4x waveshaper (pallas_fx.py:1805-1898): the fbws
    chain with ``tanh(v*d)*comp`` held across the four subsamples of each
    engine sample and the packed DC rows passed through."""
    d, comp = _ws4_gain(drive)
    dT, cT = d.t(), comp.t()
    return ovs4_plain(x.t(), packed, lambda n, s: torch.tanh(s * dT[n]) * cT[n],
                       lambda c, n, y: y)


def ws4_bank(x, drive, packed):
    """Fused voice-bank plain waveshaper at 4x (waveshaper.rs semantics,
    mix == 1).

    ``x``: [V, B] undriven input; ``drive``: [V, B] raw drive trajectory;
    ``packed``: [52, V] from :func:`pack_ws4_bank`.  Returns ``(sat [V, B],
    new_packed [100, V])`` for :func:`unpack_ws4_bank`; the caller applies
    the bypass select and the block-granular freeze.  The kernel computes
    the drive's gain itself (:func:`_ws4_gain`'s arithmetic)."""
    if not _on_cuda("ws4_bank", x):
        return ws4_bank_plain(x, drive, packed)
    V, B = _vb("ws4_bank", x)
    _check("ws4_bank", x.device, [
        ("x", x, _F32, (V, B)), ("drive", drive, _F32, (V, B)),
        ("packed", packed, _F32, (FBWS_S_IN, V))])
    y, nst = _empty((V, B), x), _empty((FBWS_S_OUT, V), x)
    keep, coefs = _host_floats([*_FBWS_COEFS, _TANH_HALF])
    _launch("ws4_bank", x.device, "ws4_bank_launch",
            x.data_ptr(), drive.data_ptr(), packed.data_ptr(), y.data_ptr(), nst.data_ptr(),
            coefs, V, B, *_stage_args(V, B, x.device, x, drive, y))
    del keep
    ws4_bank.launches += 1
    return y, nst


ws4_bank.launches = 0


# --- 7. linrec2_bank ------------------------------------------------------------


def _fma(a, b, c):
    """``a*b + c`` rounded once to float32, like C's ``fmaf``: the float32
    product is exact in float64 and the float64 sum rounds once more."""
    return (a.double() * b.double() + c.double()).float()


def linrec2_bank_plain(a11, a12, a21, a22, b1, b2, s1_0, s2_0):
    """Plain version: ``s1' = (a11*s1 + a12*s2) + b1``, ``s2' = (a21*s1 +
    a22*s2) + b2``, both from the old state (pallas_fx.py:2188-2189), with
    the first multiply-add fused as XLA fuses it (see the kernel's note)."""
    A11, A12, A21, A22, B1, B2 = (t.t() for t in (a11, a12, a21, a22, b1, b2))
    s1, s2 = s1_0, s2_0
    s1s, s2s = [], []
    for n in range(A11.shape[0]):
        n1 = _fma(A11[n], s1, A12[n] * s2) + B1[n]
        n2 = _fma(A21[n], s1, A22[n] * s2) + B2[n]
        s1, s2 = n1, n2
        s1s.append(s1)
        s2s.append(s2)
    return torch.stack(s1s, dim=1), torch.stack(s2s, dim=1), s1, s2


def linrec2_bank(a11, a12, a21, a22, b1, b2, s1_0, s2_0):
    """Row-bank 2-state recurrence ``s[n] = A[n] s[n-1] + b[n]`` over [R, B].

    Coefficients are [R, B] (already broadcast); ``s1_0``/``s2_0`` are [R]
    carried state.  Returns ``(s1 [R, B], s2 [R, B], s1' [R], s2' [R])``
    with s1/s2 the post-update trajectories."""
    if not _on_cuda("linrec2_bank", a11):
        return linrec2_bank_plain(a11, a12, a21, a22, b1, b2, s1_0, s2_0)
    R, B = _vb("linrec2_bank", a11)
    coefs = (("a11", a11), ("a12", a12), ("a21", a21), ("a22", a22), ("b1", b1), ("b2", b2))
    _check("linrec2_bank", a11.device,
           [(label, t, _F32, (R, B)) for label, t in coefs]
           + [("s1_0", s1_0, _F32, (R,)), ("s2_0", s2_0, _F32, (R,))])
    s1, s2 = _empty((R, B), a11), _empty((R, B), a11)
    s1l, s2l = _empty((R,), a11), _empty((R,), a11)
    _launch("linrec2_bank", a11.device, "linrec2_bank_launch",
            *(t.data_ptr() for _, t in coefs), s1_0.data_ptr(), s2_0.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), s1l.data_ptr(), s2l.data_ptr(), R, B,
            *_stage_args(R, B, a11.device, *(t for _, t in coefs), s1, s2))
    linrec2_bank.launches += 1
    return s1, s2, s1l, s2l


linrec2_bank.launches = 0


# --- 8. triangle_additive_bank --------------------------------------------------

TWO_PI = float(2.0 * np.pi)


def triangle_additive_bank_plain(idx, freq, sample_rate: float, max_harmonics: int):
    """Plain version of the additive odd-harmonic triangle (osc.py:130-157),
    in its op order: ``sin(h*theta)`` by the Chebyshev recurrence
    ``sin((h+2)t) = 2cos(2t) sin(ht) - sin((h-2)t)``."""
    theta = idx * freq * (TWO_PI / sample_rate)
    # divisions by a device scalar, not a Python one: true divisions as in
    # the kernel and the JAX package
    nyquist = torch.full((), sample_rate / 2.0, dtype=torch.float32, device=idx.device)
    sin1 = torch.sin(theta)
    cos2x2 = 2.0 * torch.cos(2.0 * theta)
    max_h = torch.floor(nyquist / torch.clamp(freq, min=1e-6))
    prev, curr, acc = -sin1, sin1, torch.zeros_like(sin1)
    for k in range((max_harmonics + 1) // 2):
        h = 2.0 * k + 1.0
        hfreq = freq * h
        ratio = hfreq / nyquist
        t = (ratio - 0.75) * 4.0
        taper = torch.where(ratio > 0.75, 1.0 - t * t, 1.0)
        gain = taper / torch.full((), h * h, dtype=torch.float32, device=idx.device)
        active = (h <= max_h) & (hfreq <= nyquist)
        acc = acc + torch.where(active, gain * curr, 0.0)
        prev, curr = curr, cos2x2 * curr - prev
    return acc


@functools.lru_cache(maxsize=None)
def taper_threshold(nyquist: float) -> float:
    """The smallest float32 ``T`` with ``f32(T / nyquist) > 0.75`` (an IEEE
    float32 division, ``nyquist`` rounded to float32).  The division is
    monotone in ``T``, so for every float32 ``x`` the plain version's taper
    test ``x / nyquist > 0.75`` holds exactly where ``x >= T``: the kernels
    (``csrc/triangle.cuh``) test it without dividing.  Found by stepping
    through the float32 bit patterns around ``0.75 * nyquist``."""
    nyq = np.float32(nyquist)
    x = np.float32(np.float32(0.75) * nyq)
    while np.float32(x / nyq) > np.float32(0.75):
        x = np.nextafter(x, np.float32(-np.inf))
    while not np.float32(x / nyq) > np.float32(0.75):
        x = np.nextafter(x, np.float32(np.inf))
    return float(x)


def triangle_additive_bank(idx, freq, sample_rate: float, max_harmonics: int):
    """Voice-bank additive triangle over [V, B]: ``idx`` samples since the
    trigger (float), ``freq`` Hz per sample; ``max_harmonics`` bounds the
    odd harmonics summed.  Returns ``[V, B]``."""
    if not _on_cuda("triangle_additive_bank", idx):
        return triangle_additive_bank_plain(idx, freq, sample_rate, max_harmonics)
    V, B = _vb("triangle_additive_bank", idx)
    _check("triangle_additive_bank", idx.device, [
        ("idx", idx, _F32, (V, B)), ("freq", freq, _F32, (V, B))])
    out = _empty((V, B), idx)
    nyquist = float(np.float32(sample_rate / 2.0))
    _launch("triangle_additive_bank", idx.device, "triangle_additive_bank_launch",
            idx.data_ptr(), freq.data_ptr(), out.data_ptr(),
            float(np.float32(TWO_PI / sample_rate)), nyquist, taper_threshold(nyquist),
            (int(max_harmonics) + 1) // 2, V, B)
    triangle_additive_bank.launches += 1
    return out


triangle_additive_bank.launches = 0


# --- 9. mix_bank ------------------------------------------------------------------

#: voices summed in one partial sum: each chunk in voice order, then the
#: chunks in order (csrc/bank_kernels.cu mix_bank)
MIX_CHUNK = 256
_HALF_PI = float(np.float32(np.pi / 2.0))


def _mix_powers(coeff, B: int, device):
    """``q^(k+1)``, k = 0..B-1, with ``q = f32(1 - coeff)`` as the Pallas
    wrapper rounds it (pallas_fx.py:2137-2138), in XLA's values."""
    return pow_table(float(np.float32(1.0 - coeff)), B, device)


def mix_bank_plain(voices, pan_cur, pan_tgt, gain_cur, gain_tgt, *, coeff):
    """Plain version of the mix (pallas_fx.py:2071-2098): the pan and gain
    smoothers' trajectories with the settle snap, equal-power pan, and the
    three sums over voices, in the kernel's order: sequentially within each
    ``MIX_CHUNK``-voice chunk, then the chunks in turn."""
    V, B = voices.shape
    nc = -(-V // MIX_CHUNK)
    pad = nc * MIX_CHUNK - V

    def chunks(t, tail):
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
        return t.reshape((nc, MIX_CHUNK) + tail)

    pw = _mix_powers(coeff, B, voices.device)
    x = chunks(voices, (B,))
    pc, pt, gc, gt = (chunks(a, (1,)) for a in (pan_cur, pan_tgt, gain_cur, gain_tgt))
    pan = pt + settle_snap((pc - pt) * pw)
    gain = gt + settle_snap((gc - gt) * pw)
    ang = torch.clamp(pan, 0.0, 1.0) * _HALF_PI
    shaped = x * gain
    sums = []
    for term in (shaped * torch.cos(ang), shaped * torch.sin(ang), shaped):
        part = torch.zeros((nc, B), dtype=_F32, device=voices.device)
        for j in range(MIX_CHUNK):
            part = part + term[:, j]
        total = torch.zeros(B, dtype=_F32, device=voices.device)
        for c in range(nc):
            total = total + part[c]
        sums.append(total)
    return tuple(sums)


def mix_bank(voices, pan_cur, pan_tgt, gain_cur, gain_tgt, *, coeff):
    """The engine's fused mix over a ``[V, B]`` voice bank.

    ``pan_*``/``gain_*``: [V] smoother current and target values; ``coeff``:
    the smoothing coefficient.  Returns ``(sum_l, sum_r, sum_mono)``, each
    ``[B]``: the equal-power-panned mixes and the unpanned one.  The caller
    advances the smoothers (``smooth_advance``)."""
    if not _on_cuda("mix_bank", voices):
        return mix_bank_plain(voices, pan_cur, pan_tgt, gain_cur, gain_tgt, coeff=coeff)
    V, B = _vb("mix_bank", voices)
    _check("mix_bank", voices.device, [
        ("voices", voices, _F32, (V, B)), ("pan_cur", pan_cur, _F32, (V,)),
        ("pan_tgt", pan_tgt, _F32, (V,)), ("gain_cur", gain_cur, _F32, (V,)),
        ("gain_tgt", gain_tgt, _F32, (V,))])
    pw = _mix_powers(coeff, B, voices.device)
    part = _empty((-(-V // MIX_CHUNK), 3, B), voices)
    outs = tuple(_empty((B,), voices) for _ in range(3))
    _launch("mix_bank", voices.device, "mix_bank_launch",
            voices.data_ptr(), pan_cur.data_ptr(), pan_tgt.data_ptr(), gain_cur.data_ptr(),
            gain_tgt.data_ptr(), pw.data_ptr(), part.data_ptr(), *(o.data_ptr() for o in outs),
            V, B)
    mix_bank.launches += 1
    return outs


mix_bank.launches = 0


def pack_fbws_bank(state) -> torch.Tensor:
    """FBShaperState ([V]-shaped slices) -> packed ``[52, V]``."""
    o = state.ovs
    rows = []
    for hb in (o.up1, o.up2):
        rows += [hb.ap0.t(), hb.ap0x.t(), hb.ap1.t(), hb.ap1x.t()]
    for hb in (o.down2, o.down1):
        rows += [hb.ap0.t(), hb.ap0x.t(), hb.ap1.t(), hb.ap1x.t(), hb.x1[None]]
    rows += [state.dc_x1[None], state.dc_y1[None]]
    return torch.cat(rows, dim=0).contiguous()


def unpack_fbws_bank(nst, state):
    """Packed ``[100, V]`` -> ``(new OversamplerState, dc_x1, dc_y1)``.

    The up-samplers' ``x1`` fields are untouched by the chain and come from
    ``state``."""

    def g(name):
        k, n = FBWS_OUT_IDX[name]
        return nst[k] if n == 1 else nst[k:k + n].t()

    def hb(tag, x1):
        return HalfbandState(
            ap0=g(f"{tag}y0"), ap0x=g(f"{tag}x0"),
            ap1=g(f"{tag}y1"), ap1x=g(f"{tag}x1"), x1=x1,
            ap0y2=g(f"{tag}y2_0"), ap0x2=g(f"{tag}x2_0"),
            ap1y2=g(f"{tag}y2_1"), ap1x2=g(f"{tag}x2_1"))

    o = state.ovs
    ovs_new = type(o)(
        up1=hb("u1", o.up1.x1),
        up2=hb("u2", o.up2.x1),
        down2=hb("d2", g("d2x1d")),
        down1=hb("d1", g("d1x1d")),
    )
    return ovs_new, g("dcx"), g("dcy")


def pack_ws4_bank(ovs) -> torch.Tensor:
    """``[V]``-batched OversamplerState -> packed ``[52, V]`` for
    :func:`ws4_bank`: the fbws layout with zero DC rows (the waveshaper has
    no DC blocker)."""
    z = torch.zeros_like(ovs.up1.x1)
    return pack_fbws_bank(SimpleNamespace(ovs=ovs, dc_x1=z, dc_y1=z))


def unpack_ws4_bank(nst, ovs):
    """Packed ``[100, V]`` -> the new OversamplerState (DC rows discarded)."""
    new_ovs, _dcx, _dcy = unpack_fbws_bank(nst, SimpleNamespace(ovs=ovs))
    return new_ovs
