"""The port's snare, hihat2, tom2 and bass banks against their per-sample
numpy oracles (tests/{snare,hihat2,tom2,bass}_oracle.py), as the JAX
package's tests/test_snare.py, tests/test_drums.py and tests/test_bass.py
hold the JAX banks, at their bounds: 1e-4 (snare, hihat2, tom2, the bass's
sine path), 2e-4 (the bass's polyBLEP paths), the tom2's RMS 3e-5.  One
voice, CPU tensors (each kernel wrapper runs its plain version); no JAX
compile."""

import dataclasses

import numpy as np
import pytest

from libgooey_tpu_torch.core.smoother import smoothing_coeff
from libgooey_tpu_torch.instruments import bass as tbass
from libgooey_tpu_torch.instruments import hihat2 as thh2
from libgooey_tpu_torch.instruments import snare as tsnare
from libgooey_tpu_torch.instruments import tom2 as ttom2

from bass_oracle import BassOracle
from hihat2_oracle import HiHat2Oracle
from snare_oracle import SnareOracle
from tom2_oracle import Tom2Oracle

SR = 44100.0
COEFF = smoothing_coeff(SR)


def _render(mod, cfg, n_samples, B, triggers, changes=None, **kw):
    """One voice of ``mod`` on the CPU; ``triggers``: ``[(sample, vel)]``
    (at most one a block); ``changes``: ``{sample: {param: value}}`` staged
    at the start of the block holding ``sample``."""
    state = mod.init_state(1, cfg, device="cpu")
    targets = np.broadcast_to(cfg.as_array(), (1, len(mod.PARAM_NAMES))).copy()
    out = []
    for start in range(0, n_samples, B):
        for s, ch in (changes or {}).items():
            if start <= s < start + B:
                for k, v in ch.items():
                    targets[:, mod.PARAM_NAMES.index(k)] = v
                state = state._replace(params=state.params.with_targets(targets))
        off = np.full(1, B, np.int32)
        vel = np.zeros(1, np.float32)
        for t, v in triggers:
            if start <= t < start + B:
                off[0], vel[0] = t - start, v
        state, y = mod.render_block(state, off, vel, np.int32(start), sample_rate=SR,
                                    block_size=B, **kw)
        out.append(y[0].numpy())
    return np.concatenate(out)[:n_samples]


def _oracle(o, n_samples, triggers, fire, changes=None, B=512):
    trig = dict(triggers)
    out = np.zeros(n_samples, np.float32)
    for n in range(n_samples):
        for s, ch in (changes or {}).items():
            if n == (s // B) * B:
                for k, v in ch.items():
                    o.set_param(k, v)
        if n in trig:
            fire(o, n, trig[n])
        out[n] = o.tick(n) if isinstance(o, SnareOracle) else o.tick()
    return out


@pytest.mark.parametrize("preset, n, trig, vel", [
    ("tight", 1500, 23, 0.7), ("smack", 1500, 0, 1.0), ("hiss", 1200, 5, 0.6)])
def test_snare_matches_oracle(preset, n, trig, vel):
    cfg = getattr(tsnare.SnareConfig, preset)()
    got = _render(tsnare, cfg, n, 128, [(trig, vel)], smooth_coeff=COEFF, max_harmonics=128)
    o = SnareOracle({k: getattr(cfg, k) for k in tsnare.PARAM_NAMES},
                    filter_type=cfg.filter_type, sample_rate=SR)
    want = _oracle(o, n, [(trig, vel)], lambda o, i, v: o.trigger(i, v))
    assert np.abs(got).max() > 1e-3
    assert np.abs(got - want).max() < 1e-4


HIHAT2_CASES = {
    "short": (lambda: thh2.HiHat2Config.short(), [(64, 1.0)]),
    "pink_12db": (lambda: dataclasses.replace(thh2.HiHat2Config.loose(), noise_color=1,
                                              filter_slope=0, tone=0.4), [(0, 0.7)]),
    "retrigger": (lambda: thh2.HiHat2Config.soft(), [(10, 0.9), (1500, 0.5)]),
}


@pytest.mark.parametrize("case", sorted(HIHAT2_CASES))
def test_hihat2_matches_oracle(case):
    make, trigs = HIHAT2_CASES[case]
    cfg = make()
    got = _render(thh2, cfg, 2048, 512, trigs, smooth_coeff=COEFF)
    o = HiHat2Oracle({k: getattr(cfg, k) for k in thh2.PARAM_NAMES}, SR, coeff=COEFF,
                     filter_slope=cfg.filter_slope, noise_color=cfg.noise_color)
    want = _oracle(o, 2048, trigs, lambda o, i, v: o.trigger(v))
    assert np.abs(got).max() > 1e-3
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("preset", ["derp", "ring", "void_preset", "brush"])
def test_tom2_matches_oracle(preset):
    cfg = getattr(ttom2.Tom2Config, preset)()
    got = _render(ttom2, cfg, 3072, 512, [(64, 1.0)])
    o = Tom2Oracle({k: getattr(cfg, k) for k in ttom2.PARAM_NAMES}, SR)
    want = _oracle(o, 3072, [(64, 1.0)], lambda o, i, v: o.trigger())
    d = np.abs(got - want)
    assert np.abs(got).max() > 1e-3
    assert d.max() < 1e-4 and np.sqrt(np.mean(d ** 2)) < 3e-5


BASS_CASES = {
    "acid": (dict(), 2048, 100, 0.9, None, 2e-4),
    "overdriven_square": (dict(osc_shape=1.0, overdrive=0.7, detune_level=0.5,
                               detune_amount=0.6, filter_env_amount=0.8,
                               filter_resonance=0.6), 2048, 37, 1.0, None, 2e-4),
    "sine_path": (dict(sub_level=0.9, osc_level=0.0, detune_level=0.0, overdrive=0.5),
                  2048, 100, 0.9, None, 1e-4),
    "param_smoothing": (dict(), 2560, 10, 0.8,
                        {512: {"filter_cutoff": 0.9, "osc_shape": 0.8},
                         1536: {"volume": 0.3}}, 2e-4),
}


@pytest.mark.parametrize("case", sorted(BASS_CASES))
def test_bass_matches_oracle(case):
    over, n, trig, vel, changes, tol = BASS_CASES[case]
    cfg = dataclasses.replace(tbass.BassConfig.acid(), **over)
    got = _render(tbass, cfg, n, 512, [(trig, vel)], changes, smooth_coeff=COEFF)
    o = BassOracle({k: getattr(cfg, k) for k in tbass.PARAM_NAMES}, SR, coeff=COEFF)
    want = _oracle(o, n, [(trig, vel)], lambda o, i, v: o.trigger(v), changes)
    assert np.abs(got).max() > 1e-3
    assert np.abs(got - want).max() < tol
