"""The plain versions of the port's grain, sampler and mix kernels against
the JAX package (all on the CPU): the gather math the JAX package calls
exact, and its Pallas wrappers run in interpret mode at their own tests'
bars.  Also ``ops/scan.linrec1`` against ``pallas_scan.linrec1_pallas``,
the TPU kernel whose function ``affine1_bank`` computes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libgooey_tpu.ops import pallas_fx, pallas_grain, pallas_scan

from libgooey_tpu_torch.ops import bank_kernels, grain_kernels, scan

B = 512
L = 4096


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grains(rs, G, max_step=2.0):
    """Starts across and beyond the buffer, steps ±[0.5, max_step]."""
    p0 = rs.uniform(-200.0, L + 200.0, G).astype(np.float32)
    step = (rs.uniform(0.5, max_step, G) * rs.choice([-1.0, 1.0], G)).astype(np.float32)
    return p0, step


def _jax_granulator_reads(buf, src_pos, step, spawn, block_start):
    """granulator.py:243-282's gather branch, op for op: the age as int32,
    rounded once, then ``src_pos + step*age``."""
    n_global = jnp.int32(block_start) + jnp.arange(B, dtype=jnp.int32)
    age = (n_global[None, :] - jnp.asarray(spawn)[:, None]).astype(jnp.float32)
    pos = jnp.clip(jnp.asarray(src_pos)[:, None] + jnp.asarray(step)[:, None] * age,
                   0.0, L - 1.0)
    i1 = jnp.floor(pos).astype(jnp.int32)
    frac = pos - jnp.floor(pos)
    buf = jnp.asarray(buf)
    p0 = buf[jnp.clip(i1 - 1, 0, L - 1)]
    p1 = buf[i1]
    p2 = buf[jnp.clip(i1 + 1, 0, L - 1)]
    p3 = buf[jnp.clip(i1 + 2, 0, L - 1)]
    a0 = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    a1 = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    a2 = -0.5 * p0 + 0.5 * p2
    return np.asarray(((a0 * frac + a1) * frac + a2) * frac + p1)


@pytest.mark.parametrize("max_step", [2.0, 8.0])
def test_grain_read_matches_the_gather_path(max_step):
    """``age = n``: ``pallas_grain.gather_read_cubic``, edge holds at both
    ends, reverse steps, and |step| up to 8 (past the Pallas wrapper's
    ~7.02 clip, which the gather path does not apply)."""
    rs = np.random.RandomState(0)
    buf = (0.4 * rs.standard_normal(L)).astype(np.float32)
    p0, step = _grains(rs, 40, max_step)
    step[:4] = [max_step, -max_step, max_step, -max_step]
    p0[:4] = [L - 100.0, 100.0, -50.0, L + 40.0]
    want = np.asarray(pallas_grain.gather_read_cubic(jnp.asarray(buf), jnp.asarray(p0),
                                                     jnp.asarray(step), B=B))
    got = grain_kernels.grain_read_cubic(_t(buf), _t(p0), _t(step), B=B)
    assert got.shape == (40, B) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6
    # the edge holds: runs off the end hold the last sample, off the start the first
    assert float(got[0, -1]) == buf[-1] and float(got[1, -1]) == buf[0]
    # no age is the age-0 form
    zero = torch.zeros(40, dtype=torch.int32)
    assert torch.equal(grain_kernels.grain_read_cubic(_t(buf), _t(p0), _t(step), B=B,
                                                      age0=zero), got)


def test_grain_read_with_ages_matches_the_granulators_gather():
    """``age0 = block_start - spawn``: the granulator's read, the age
    rounded to float32 once, including never-spawned lanes (~2^30)."""
    rs = np.random.RandomState(1)
    buf = (0.4 * rs.standard_normal(L)).astype(np.float32)
    G = 48
    src_pos, step = _grains(rs, G, 8.0)
    block_start = 3 * B
    spawn = rs.randint(-60000, block_start + B, G).astype(np.int32)
    spawn[:3] = -(2**30)
    want = _jax_granulator_reads(buf, src_pos, step, spawn, block_start)
    age0 = torch.from_numpy(block_start - spawn).to(torch.int32)
    got = grain_kernels.grain_read_cubic(_t(buf), _t(src_pos), _t(step), B=B, age0=age0)
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_grain_read_matches_the_pallas_kernel():
    """The Pallas wrapper in interpret mode, inside its step clip: within
    its own test's 1e-4 (its bf16 hi/lo split drops a ~2^-18 residual).
    XLA contracts its position ``p0 + step*n`` into one rounding where the
    gather path, and the port, round twice: an ulp of a position near 4,096
    is 4.9e-4 samples, so the source is audio-like (three partials under 2
    kHz), not white noise, whose sample-to-sample slope would turn that ulp
    into up to 6e-4."""
    rs = np.random.RandomState(2)
    t = np.arange(L) / 44100.0
    buf = sum(0.2 * np.sin(2 * np.pi * f * t + ph)
              for f, ph in ((220.0, 0.3), (710.0, 1.1), (1830.0, 2.0))).astype(np.float32)
    p0, step = _grains(rs, 16, 7.0)
    want = np.asarray(pallas_grain.grain_read_cubic(jnp.asarray(buf), jnp.asarray(p0),
                                                    jnp.asarray(step), B=B, interpret=True))
    got = grain_kernels.grain_read_cubic(_t(buf), _t(p0), _t(step), B=B)
    assert np.abs(got.numpy() - want).max() <= 1e-4


def test_grain_read_maps_non_finite_starts():
    buf = np.linspace(-1.0, 1.0, 64, dtype=np.float32)
    p0 = np.array([np.nan, np.inf, -np.inf, 10.0], np.float32)
    step = np.array([1.0, 1.0, 1.0, np.inf], np.float32)
    got = grain_kernels.grain_read_cubic(_t(buf), _t(p0), _t(step), B=4)
    assert bool(torch.isfinite(got).all())
    assert float(got[1, 0]) == buf[-1] and float(got[2, 0]) == buf[0]
    assert float(got[3, 0]) == buf[0]   # inf * 0: a NaN position reads the first sample


def _sampler_slots(rs, V, F, max_inc=3.0):
    base = (rs.randint(0, 12, V) * 1000).astype(np.int32)
    frames = rs.uniform(400.0, 3000.0, V).astype(np.float32)
    frames[:2] = np.float32([700.5, 64.25])[:V]    # fractional ends
    start = rs.randint(-4000, 2 * B, V).astype(np.int32)
    start[0] = -4000               # past its fractional end from the first block on
    inc = rs.uniform(0.4, max_inc, V).astype(np.float32)
    return base, frames, start, inc


def _jax_sampler_frames(arena, base, frames, start, inc, block_start, n=B):
    """sampler.py:111-132's gather branch, op for op, over ``n`` samples."""
    n_global = jnp.int32(block_start) + jnp.arange(n, dtype=jnp.int32)
    age = (n_global[None, :] - jnp.asarray(start)[:, None]).astype(jnp.float32)
    pos = age * jnp.asarray(inc)[:, None]
    end = jnp.asarray(frames)[:, None]
    posc = jnp.clip(pos, 0.0, end - 1.0)
    i0 = jnp.floor(posc).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, (end - 1.0).astype(jnp.int32))
    frac = (posc - jnp.floor(posc))[..., None]
    arena = jnp.asarray(arena)
    f0 = arena[jnp.asarray(base)[:, None] + i0]
    f1 = arena[jnp.asarray(base)[:, None] + i1]
    return np.asarray(f0 + (f1 - f0) * frac)


@pytest.mark.parametrize("max_inc,V,n,tails", [
    pytest.param(3.0, 24, B, False, id="3.0"),
    pytest.param(6.0, 24, B, False, id="6.0"),
    pytest.param(3.0, 1, B, False, id="V1"),
    pytest.param(6.0, 130, 100, True, id="V130-B100-tails"),
    pytest.param(6.0, 130, 33, True, id="V130-B33-tails"),
])
def test_sampler_read_matches_the_gather_path(max_inc, V, n, tails):
    """Fractional slot ends (the plateau holds ``f0``), voices not started
    yet, voices past their end, increments past the Pallas wrapper's 4.0;
    one voice; at the tails, 130 voices of 100 and 33 samples with negative
    increments (a voice started after the sample reads forward), every
    seventh increment 6, and every tenth slot's base at the arena's end
    (its reads clamp to the last frame)."""
    rs = np.random.RandomState(3)
    F = 1 << 14
    arena = (0.4 * rs.standard_normal((F, 2))).astype(np.float32)
    base, frames, start, inc = _sampler_slots(rs, V, F, max_inc)
    if tails:   # voice 0 keeps its plateau
        inc[1:] *= rs.choice([-1.0, 1.0], V - 1).astype(np.float32)
        inc[::7] = 6.0
        base[10::10] = F - rs.randint(1, 40, len(base[10::10]))
    block_start = B
    want = _jax_sampler_frames(arena, base, frames, start, inc, block_start, n)
    got = grain_kernels.sampler_read_linear(_t(arena), _t(base), _t(frames), _t(start),
                                            _t(inc), block_start, B=n)
    assert got.shape == (V, n, 2)
    assert np.abs(got.numpy() - want).max() <= 1e-6
    # the plateau of a fractional end holds the last whole frame exactly
    hold = arena[base[0] + int(np.floor(frames[0] - 1.0))]
    np.testing.assert_array_equal(got[0].numpy(), np.tile(hold, (n, 1)))


def test_sampler_read_matches_the_pallas_kernel():
    """The Pallas wrapper in interpret mode, inside its increment clip:
    within its own test's 4e-5."""
    rs = np.random.RandomState(4)
    F = 1 << 14
    arena = (0.4 * rs.standard_normal((F, 2))).astype(np.float32)
    base, frames, start, inc = _sampler_slots(rs, 16, F)
    block_start = 2 * B
    age0 = jnp.asarray((block_start - start).astype(np.float32))
    want = np.asarray(pallas_grain.sampler_read_linear(
        jnp.asarray(arena), jnp.asarray(base), jnp.asarray(frames), age0, jnp.asarray(inc),
        B=B, interpret=True))
    got = grain_kernels.sampler_read_linear(_t(arena), _t(base), _t(frames), _t(start),
                                            _t(inc), block_start, B=B)
    assert np.abs(got.numpy() - want).max() <= 4e-5


def test_sampler_read_clamps_the_arena_index():
    """A slot whose base lies past the arena reads its last frame, not
    outside it."""
    arena = np.arange(32, dtype=np.float32).reshape(16, 2)
    got = grain_kernels.sampler_read_linear(
        _t(arena), _t(np.array([20], np.int32)), _t(np.array([8.0], np.float32)),
        _t(np.array([0], np.int32)), _t(np.array([1.0], np.float32)), 0, B=4)
    np.testing.assert_array_equal(got[0].numpy(), np.tile(arena[-1], (4, 1)))


def test_mix_bank_matches_the_pallas_kernel():
    """V = 300 (not a multiple of the 256-voice chunk), B = 128, pan and
    gain moving, some voices within the settle snap: 1e-5."""
    rs = np.random.RandomState(5)
    V, Bm = 300, 128
    x = (0.5 * rs.standard_normal((V, Bm))).astype(np.float32)
    pt = rs.uniform(0.0, 1.0, V).astype(np.float32)
    pc = np.clip(pt + rs.uniform(-0.3, 0.3, V), 0.0, 1.0).astype(np.float32)
    gt = rs.uniform(0.0, 0.2, V).astype(np.float32)
    gc = (gt + rs.uniform(-0.05, 0.05, V)).astype(np.float32)
    pc[:20] = pt[:20] + 5e-5                       # settled from the first sample
    gc[20:40] = gt[20:40] - 1.2e-4                 # settles within the block
    coeff = 0.0015
    want = pallas_fx.mix_bank(jnp.asarray(x), *map(jnp.asarray, (pc, pt, gc, gt)),
                              coeff=coeff, interpret=True)
    got = bank_kernels.mix_bank(*map(_t, (x, pc, pt, gc, gt)), coeff=coeff)
    for w, g in zip(want, got):
        assert g.shape == (Bm,)
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5


def test_linrec1_matches_linrec1_pallas():
    """``scan.linrec1`` (``affine1_bank`` with no floor) against the JAX
    package's ``linrec1_pallas`` in interpret mode, [256, 256], |a| < 1."""
    rs = np.random.RandomState(6)
    a = rs.uniform(-0.99, 0.99, (256, 256)).astype(np.float32)
    b = rs.standard_normal((256, 256)).astype(np.float32)
    y0 = rs.standard_normal(256).astype(np.float32)
    want = np.asarray(pallas_scan.linrec1_pallas(jnp.asarray(a), jnp.asarray(b),
                                                 jnp.asarray(y0), interpret=True))
    got = scan.linrec1(_t(a), _t(b), _t(y0))
    assert np.abs(got.numpy() - want).max() <= 1e-5


def test_wrappers_take_no_other_device():
    """A tensor on neither the CPU nor CUDA raises instead of falling back."""
    m = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        grain_kernels.grain_read_cubic(m, m, m, B=4)
    with pytest.raises(ValueError, match="no kernel"):
        grain_kernels.sampler_read_linear(torch.empty(8, 2, device="meta"), m, m, m, m, 0, B=4)
    with pytest.raises(ValueError, match="no kernel"):
        bank_kernels.mix_bank(torch.empty(8, 4, device="meta"), m, m, m, m, coeff=0.01)
