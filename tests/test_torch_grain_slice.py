"""The granulator-and-sampler slice (``bench_configs.bench_granulator_sampler_4k``,
config ``granulator_lfo_sampler_4k_lanes``) at a small size, the port against
the JAX package's loop of that bench's ``step`` (both gather paths), all on
the CPU: 160 grain lanes (every lane seeded active, in the bench's draw
order), 8 sampler voices on a seeded arena, B = 128, 4 blocks, output
``gout + sout[0]``."""

import jax.numpy as jnp
import numpy as np
import pytest

from libgooey_tpu.instruments import granulator as jgran
from libgooey_tpu.instruments import sampler as jsamp

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.core.smoother import smoothing_coeff
from libgooey_tpu_torch.instruments import granulator as tgran
from libgooey_tpu_torch.instruments import sampler as tsamp

from test_torch_granulator import _leaf_errors

SR = 44100.0
B = 128
N = 4
G_LANES, S_VOICES = 160, 8
COEFF = smoothing_coeff(SR)


def _jax_states(drive):
    """The bench's states (bench_configs.py:470-516) at 160 lanes and 8
    voices; the arena filled from a seed (the bench's is zeros) and the
    voices started at mixed offsets."""
    buf = np.random.RandomState(0).randn(1 << 15).astype(np.float32) * 0.3
    base = jgran.init_state(buf, SR, jgran.GranulatorConfig(drive=drive))
    rng = np.random.RandomState(1)
    gs = base._replace(
        spawn_sample=jnp.zeros(G_LANES, jnp.int32),
        duration=jnp.asarray(rng.uniform(20000, 60000, G_LANES).astype(np.float32)),
        src_pos=jnp.asarray(rng.uniform(0, 1 << 14, G_LANES).astype(np.float32)),
        step=jnp.asarray(rng.uniform(0.5, 2.0, G_LANES).astype(np.float32)),
        shape=jnp.asarray(rng.uniform(0.5, 4.0, G_LANES).astype(np.float32)),
        vel=jnp.asarray(rng.uniform(0.3, 1.0, G_LANES).astype(np.float32)),
        rel_start=jnp.full(G_LANES, -1, jnp.int32),
        rel_total=jnp.zeros(G_LANES, jnp.float32),
    )
    ss = jsamp.init_state(1 << 15)._replace(
        start_sample=jnp.zeros(S_VOICES, jnp.int32),
        base=jnp.zeros(S_VOICES, jnp.int32),
        frames=jnp.full(S_VOICES, 30000.0, jnp.float32),
        increment=jnp.asarray(rng.uniform(0.5, 2.0, S_VOICES).astype(np.float32)),
        velocity=jnp.asarray(rng.uniform(0.3, 1.0, S_VOICES).astype(np.float32)),
    )
    rs = np.random.RandomState(2)
    ss = ss._replace(
        arena=jnp.asarray((0.3 * rs.standard_normal((1 << 15, 2))).astype(np.float32)),
        start_sample=jnp.asarray(rs.randint(0, 2 * B, S_VOICES).astype(np.int32)),
        base=jnp.asarray(rs.randint(0, 1 << 12, S_VOICES).astype(np.int32)))
    return gs, ss


@pytest.mark.parametrize("drive", [0.0, 0.5])
def test_slice_matches_the_jax_bench_step(drive):
    """4 blocks: 1e-5 with the bench's drive (0), 1e-4 with the drive
    engaged; the carried states leaf by leaf (integers exact, floats 4e-4
    relative above 1)."""
    jgs, jss = _jax_states(drive)
    tgs = interop.granulator_state_from_numpy(jgs, "cpu")
    tss = interop.sampler_state_from_numpy(jss, "cpu")
    gev = jgran.SpawnEvents(*(jnp.asarray(a) for a in tgran.SpawnEvents.empty()))
    sev = jsamp.StartEvents.empty()
    tol = 1e-5 if drive == 0.0 else 1e-4
    for i in range(N):
        jgs, gout = jgran.render_block(jgs, gev, np.int32(i * B), sample_rate=SR, block_size=B,
                                       smooth_coeff=COEFF, grain_read="gather")
        jss, sout = jsamp.render_block(jss, sev, np.int32(i * B), sample_rate=SR, block_size=B,
                                       voice_read="gather")
        want = np.asarray(gout + sout[0])
        tgs, tg = tgran.render_block(tgs, tgran.SpawnEvents.empty(), i * B, sample_rate=SR,
                                     block_size=B, smooth_coeff=COEFF)
        tss, ts = tsamp.render_block(tss, tsamp.StartEvents.empty(), i * B, sample_rate=SR,
                                     block_size=B)
        got = (tg + ts[0]).numpy()
        assert np.abs(want).max() > 1e-2
        assert np.abs(got - want).max() <= tol, i
    assert max(_leaf_errors(jgs, tgs)) <= 4e-4
    assert max(_leaf_errors(jss, tss)) <= 4e-4
