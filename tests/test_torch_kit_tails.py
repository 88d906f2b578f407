"""The kit's sources and the bus chain at tail shapes, port against the JAX
package on the CPU.

The shapes the redesigned kernels cut into tiles and chunks: the kit path
(``voice.kit_render_fused``: on the CPU ``kit_sources``' plain version)
with 5/3/7/1/2 voices (kick, snare, hihat2, tom2, bass) at B = 100 (not a
multiple of kit_sources' 128-sample tile) against ``pallas_voice.kit_render_fused``,
whose ``_mega_pallas`` runs its Pallas bodies in interpret mode, jitted
(tom2's double mtof amplifies an ulp of XLA's eager exp2); and a run of one
phase and a run of twelve (two saturations, lowpasses, tilts and
compressors, a delay and the spring) through ``chain.process_run`` (on the
CPU ``bus_chain``'s plain version) at B = 100 (not a multiple of
bus_chain's 32-sample chunk) against ``pallas_chain.process_run`` in
interpret mode.  Three blocks carry state from the same start.

Bounds as tests/test_torch_kit_fused.py (output 3e-5, every state leaf
4e-4) and tests/test_torch_bus_chain.py (output 2e-5, state 1e-4 relative
to the leaf's magnitude where that exceeds 1).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libgooey_tpu.core.smoother import SmootherBank as JSmootherBank
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import bass as jbass
from libgooey_tpu.instruments import hihat2 as jhihat2
from libgooey_tpu.instruments import kick as jkick
from libgooey_tpu.instruments import snare as jsnare
from libgooey_tpu.instruments import tom2 as jtom2
from libgooey_tpu.ops import pallas_chain
from libgooey_tpu.ops import pallas_voice as pv

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.effects import chain
from libgooey_tpu_torch.engine import engine as tengine
from libgooey_tpu_torch.ops import voice

from test_torch_bus import max_state_err
from test_torch_bus_chain import EFFECTS
from test_torch_slice import _max_state_err

SR = 44100.0
B = 100
N = 3
COEFF = smoothing_coeff(SR)

#: voices a family, in the engine's family order
KIT = {"kick": 5, "snare": 3, "hihat2": 7, "tom2": 1, "bass": 2}
JMODS = {"kick": jkick, "snare": jsnare, "hihat2": jhihat2, "tom2": jtom2, "bass": jbass}
KIT_STATIC = dict(kinds=tuple(KIT), sample_rate=SR, block_size=B, smooth_coeff=COEFF,
                  kick_max_harmonics=32, snare_max_harmonics=32, tom2_triangle=True)
#: the snare's Chamberlin kept off its unstable corner (tests/test_torch_kit_fused.py)
SNARE_CLAMPS = {"filter_cutoff": (0.0, 0.7), "filter_resonance": (0.0, 0.6)}


def _kit_states(rng):
    """Random targets with the smoothers moving; tom2's plain 0-100 values."""
    states = {}
    for kind, nv in KIT.items():
        mod = JMODS[kind]
        targets = rng.uniform(0, 1, (nv, mod.NUM_PARAMS)).astype(np.float32)
        if kind == "tom2":
            targets[:, :mod.PARAM_INDEX["tuning"]] *= 100.0
            states[kind] = mod.init_state(nv, targets=targets)
            continue
        cur = np.clip(targets + rng.normal(0, 0.2, targets.shape), 0, 1).astype(np.float32)
        for name, (lo, hi) in (SNARE_CLAMPS.items() if kind == "snare" else ()):
            i = mod.PARAM_INDEX[name]
            targets[:, i] = np.clip(targets[:, i], lo, hi)
            cur[:, i] = np.clip(cur[:, i], lo, hi)
        st = mod.init_state(nv, targets=targets)
        states[kind] = st._replace(params=JSmootherBank(current=jnp.asarray(cur),
                                                        target=jnp.asarray(targets)))
    return states


def test_kit_sources_tail_matches_jax():
    """The five families at 5/3/7/1/2 voices and B = 100: every family's
    output and carried state, three blocks with staggered triggers (one
    voice of each struck at the first sample)."""
    rng = np.random.default_rng(8)
    jst = _kit_states(rng)
    tst = {k: interop.family_state_from_numpy(k, s, "cpu") for k, s in jst.items()}
    jrender = jax.jit(functools.partial(pv.kit_render_fused, interpret=True, **KIT_STATIC))
    peak = 0.0
    for blk in range(N):
        offs = {k: np.where(rng.uniform(size=v) < 0.5, rng.integers(0, B, v), B).astype(np.int32)
                for k, v in KIT.items()}
        offs = {k: np.where(np.arange(v) == 0, 0, o).astype(np.int32) if blk == 0 else o
                for (k, v), o in zip(KIT.items(), offs.values())}
        vels = {k: rng.uniform(0.3, 1.0, v).astype(np.float32) for k, v in KIT.items()}
        start = np.int32(blk * B)
        jres = jrender(jst, offs, vels, start)
        tres = voice.kit_render_fused(tst, offs, vels, start, **KIT_STATIC)
        for kind in KIT:
            jout = np.asarray(jres[kind][1])
            peak = max(peak, float(np.abs(jout).max()))
            err = float(np.abs(tres[kind][1].numpy() - jout).max())
            assert err <= 3e-5, f"{kind} block {blk}: output error {err}"
            worst, where = _max_state_err(jres[kind][0], tres[kind][0])
            assert worst <= 4e-4, f"{kind} block {blk}: {worst} at {where}"
        jst = {k: r[0] for k, r in jres.items()}
        tst = {k: r[0] for k, r in tres.items()}
    assert peak > 1e-3


#: (effects in order, init args, targets of the first block and the later
#: ones, input seed)
RUNS = {
    "one_phase": (("saturation",), [(0.6, 0.5, 1.0)], [(0.6, 0.5, 1.0)], [(0.2, 0.9, 0.0)], 9),
    # twelve phases: every mergeable effect, then a second saturation,
    # lowpass, tilt and compressor (its detector and gain stage twice)
    "twelve_phases": (
        ("saturation", "lowpass", "tilt", "delay", "compressor", "spring",
         "saturation", "lowpass", "tilt", "compressor"),
        [(0.6, 0.5, 1.0), (6000.0, 0.5), (0.3, 0.4), (0.005, 0.5, 0.4, 6000.0),
         (-20.0, 4.0, 5.0, 80.0, 1.0), (0.5, 0.6, 0.4), (0.3, 0.2, 0.5), (9000.0, 0.7),
         (0.7, 0.2), (-30.0, 8.0, 1.0, 30.0, 0.8)],
        [(0.6, 0.5, 1.0), (6000.0, 0.5), (0.3, 0.4), (0.005, 0.5, 0.4, 6000.0),
         (-20.0, 4.0, 5.0, 80.0, 1.0), (0.5, 0.6, 0.4), (0.3, 0.2, 0.5), (9000.0, 0.7),
         (0.7, 0.2), (-30.0, 8.0, 1.0, 30.0, 0.8)],
        [(0.2, 0.9, 0.0), (3000.0, 0.8), (0.75, 0.6), (0.004, 0.6, 0.7, 3000.0),
         (-40.0, 6.0, 2.0, 50.0, 1.0), (0.8, 0.5, 0.2), (0.6, 0.5, 1.0), (2000.0, 0.3),
         (0.25, 0.5), (-10.0, 2.0, 5.0, 80.0, 0.5)], 10),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_bus_chain_tail_matches_jax(case):
    names, init, first, later, seed = RUNS[case]
    n_phases = sum(2 if n == "compressor" else 1 for n in names)
    assert n_phases == (1 if case == "one_phase" else 12)
    rs = np.random.RandomState(seed)
    x = rs.uniform(-0.8, 0.8, (2, N * B)).astype(np.float32)
    jst = [EFFECTS[n][0].init_state(SR, *a) for n, a in zip(names, init)]
    tst = [interop.fx_state_from_numpy(n, s, "cpu") for n, s in zip(names, jst)]
    entries = [(EFFECTS[n][1], False) for n in names]
    options = [{"pingpong": False} if n == "delay" else {} for n in names]
    modules = [tengine.FX_MODULES[n] for n in names]
    worst_out = 0.0
    for i in range(N):
        xb = x[:, i * B:(i + 1) * B]
        tg = [np.asarray(v, np.float32) for v in (first if i == 0 else later)]
        jst, jy = pallas_chain.process_run(entries, jst, jnp.asarray(xb), tg, sample_rate=SR,
                                           interpret=True)
        tst, ty = chain.process_run(modules, tst, torch.from_numpy(xb.copy()), tg,
                                    sample_rate=SR, options=options)
        jy = np.asarray(jy)
        assert np.abs(jy).max() > 0.05
        worst_out = max(worst_out, float(np.abs(jy - ty.numpy()).max()))
    assert worst_out <= 2e-5, f"{case}: output error {worst_out}"
    keys = [f"{n}{i}" for i, n in enumerate(names)]
    worst, where = max_state_err(dict(zip(keys, jst)), dict(zip(keys, tst)))
    assert worst <= 1e-4, f"{case}: state error {worst} at {where}"
