"""The port at ``os_mode`` 1 and 2 against the JAX package's XLA path, on the CPU.

At 1x and 2x the JAX package evaluates the effects' curves through
``ops/oversample.process`` (its allpass sections as ``linrec1`` scans)
instead of the 4x kernels; the port does the same on ``scan.linrec1``
(``affine1_bank``).  Held here, each from the same state (carried across
with ``interop``) and the same numpy inputs:

* the saturation, the compressor (self-keyed and keyed from a sidechain),
  the feedback waveshaper's zero-feedback path and the waveshaper's bank
  path (``process_bank``) on a [2, 64] stereo block, 3 blocks, the JAX
  effects op by op with ``impl="xla"``;
* the kick, the snare and the bass ``render_block`` with V = 4 (the four
  presets each, so the drive is on in some voices and bypassed in others),
  B = 64, 3 blocks, the JAX bank jitted with ``fused=False`` (4 voices is
  below ``_MX_MIN_BATCH``, so its chains take the scan form);
* the Engine's kit gate: an ``os_mode`` 2 kick, snare and bass stay off the
  kit path while the hihat2 and tom2 take it.

Bounds: audio 1e-4, every state leaf 4e-4, relative to its magnitude where
that exceeds 1 (tests/test_torch_snare.py's bounds).  XLA:CPU may contract
the allpass input ``a*x + x_prev`` into an FMA and solves ``linrec1`` with
an associative scan, where the port rounds twice and walks the samples in
order; both stay far inside these bounds.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.effects import compressor as jcompressor
from libgooey_tpu.effects import feedback_waveshaper as jfbws
from libgooey_tpu.effects import saturation as jsaturation
from libgooey_tpu.effects import waveshaper as jws
from libgooey_tpu.instruments import bass as jbass
from libgooey_tpu.instruments import kick as jkick
from libgooey_tpu.instruments import snare as jsnare
from libgooey_tpu.ops import oversample as jovs

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.effects import compressor as tcompressor
from libgooey_tpu_torch.effects import feedback_waveshaper as tfbws
from libgooey_tpu_torch.effects import saturation as tsaturation
from libgooey_tpu_torch.effects import waveshaper as tws
from libgooey_tpu_torch.engine import engine as tengine
from libgooey_tpu_torch.instruments import bass as tbass
from libgooey_tpu_torch.instruments import kick as tkick
from libgooey_tpu_torch.instruments import snare as tsnare
from libgooey_tpu_torch.ops import oversample as tovs
from libgooey_tpu_torch.ops import voice

from test_torch_bus import max_state_err

SR = 44100.0
B = 64
N_BLOCKS = 3
OUT_TOL = 1e-4
STATE_TOL = 4e-4
MODES = (1, 2)


def _stereo(seed, scale=0.8):
    rs = np.random.RandomState(seed)
    return rs.uniform(-scale, scale, (2, N_BLOCKS * B)).astype(np.float32)


def _blocks(x):
    return [x[:, i * B:(i + 1) * B] for i in range(N_BLOCKS)]


def _check(name, jouts, touts, jst, tst):
    worst = max(float(np.abs(np.asarray(j) - t.numpy()).max()) for j, t in zip(jouts, touts))
    assert max(float(np.abs(np.asarray(j)).max()) for j in jouts) > 1e-2, name
    assert worst <= OUT_TOL, f"{name}: output error {worst}"
    err, where = max_state_err({"s": jst}, {"s": tst})
    assert err <= STATE_TOL, f"{name}: state error {err} at {where}"


#: (module pair, init args, per-block targets, sidechain seed): the mix
#: falls under the saturation's bypass gate in the last block; the
#: compressor goes harder mid-stream
BUS = {
    "saturation": ((jsaturation, tsaturation), (0.6, 0.5, 1.0),
                   [(0.6, 0.5, 1.0), (0.2, 0.9, 0.7), (0.2, 0.9, 0.0)], None),
    "compressor": ((jcompressor, tcompressor), (-20.0, 4.0, 5.0, 80.0, 1.0),
                   [(-20.0, 4.0, 5.0, 80.0, 1.0), (-35.0, 10.0, 1.0, 30.0, 0.6),
                    (-35.0, 10.0, 1.0, 30.0, 0.6)], None),
    "compressor_keyed": ((jcompressor, tcompressor), (-30.0, 6.0, 2.0, 60.0, 1.0),
                         [(-30.0, 6.0, 2.0, 60.0, 1.0)] * 3, 9),
}


@pytest.mark.parametrize("os_mode", MODES)
@pytest.mark.parametrize("case", sorted(BUS))
def test_bus_effect_matches_jax_xla(case, os_mode):
    (jmod, tmod), init, seq, sc_seed = BUS[case]
    name = case.split("_")[0]
    x = _stereo(3, 1.5 if name == "compressor" else 0.8)
    sc = None if sc_seed is None else _stereo(sc_seed, 1.5)
    jst = jmod.init_state(SR, *init)
    tst = interop.fx_state_from_numpy(name, jst, "cpu")
    jouts, touts = [], []
    for i, xb in enumerate(_blocks(x)):
        tg = np.asarray(seq[i], np.float32)
        kw_j, kw_t = {}, {}
        if sc is not None:
            scb = sc[:, i * B:(i + 1) * B]
            kw_j, kw_t = {"sidechain": jnp.asarray(scb)}, {"sidechain": torch.from_numpy(scb)}
        jst, jy = jmod.process_block(jst, jnp.asarray(xb), tg, sample_rate=SR, os_mode=os_mode,
                                     impl="xla", **kw_j)
        tst, ty = tmod.process_block(tst, torch.from_numpy(xb.copy()), tg, sample_rate=SR,
                                     os_mode=os_mode, **kw_t)
        jouts.append(jy)
        touts.append(ty)
    _check(f"{case}@{os_mode}", jouts, touts, jst, tst)


@pytest.mark.parametrize("os_mode", MODES)
def test_feedback_waveshaper_fast_path_matches_jax(os_mode, monkeypatch):
    """Per-sample drive and mix trajectories; channel 1 bypassed (drive
    under 1) for its second block, so its oversampler history is held."""
    monkeypatch.setattr(jfbws, "IMPL", "xla")
    x = _stereo(5)
    rs = np.random.RandomState(6)
    drive = rs.uniform(2.0, 12.0, x.shape).astype(np.float32)
    drive[1, B:2 * B] = 0.5
    mix = np.linspace(1.0, 0.4, x.shape[1], dtype=np.float32)[None, :].repeat(2, 0)
    fbc = np.float32(0.3)
    jst = jfbws.FBShaperState.init((2,))
    tst = interop.from_numpy(tfbws.FBShaperState.init((2,), "cpu"), jst, "cpu")
    jouts, touts = [], []
    for i, xb in enumerate(_blocks(x)):
        d, m = drive[:, i * B:(i + 1) * B], mix[:, i * B:(i + 1) * B]
        jst, jy = jfbws.process_block(jst, jnp.asarray(xb), jnp.asarray(d), 0.0, fbc,
                                      jnp.asarray(m), SR, feedback_path=False, os_mode=os_mode)
        tst, ty = tfbws.process_block(tst, torch.from_numpy(xb.copy()), torch.from_numpy(d),
                                      0.0, float(fbc), torch.from_numpy(m), SR,
                                      feedback_path=False, os_mode=os_mode)
        jouts.append(jy)
        touts.append(ty)
    _check(f"feedback_waveshaper@{os_mode}", jouts, touts, jst, tst)


@pytest.mark.parametrize("os_mode", MODES)
def test_waveshaper_bank_matches_jax(os_mode):
    """``process_bank`` against the JAX bass/snare XLA branch:
    ``ws.process(x, drive, mix=1.0, oversample=stateful(ovs, os_mode))``,
    no hook at 1x; a row with drive under 1 passes its input through."""
    x = _stereo(7)
    drive = np.random.RandomState(8).uniform(1.0, 10.0, x.shape).astype(np.float32)
    drive[0, :B] = 1.0
    jst = jovs.OversamplerState.init((2,))
    tst = interop.from_numpy(tovs.OversamplerState.init(2, "cpu"), jst, "cpu")
    jouts, touts = [], []
    for i, xb in enumerate(_blocks(x)):
        d = drive[:, i * B:(i + 1) * B]
        wrap, box = jovs.stateful(jst, os_mode)
        jy = jws.process(jnp.asarray(xb), jnp.asarray(d), mix=1.0,
                         oversample=None if os_mode == 1 else wrap)
        jst = box["state"]
        tst, ty = tws.process_bank(tst, torch.from_numpy(xb.copy()), torch.from_numpy(d),
                                   os_mode)
        jouts.append(jy)
        touts.append(ty)
    np.testing.assert_array_equal(touts[0].numpy()[0], x[0, :B])
    _check(f"waveshaper@{os_mode}", jouts, touts, jst, tst)


FAMILIES = {
    "kick": (jkick, tkick, ("tight", "punch_preset", "loose", "dirt"), "KickConfig"),
    "snare": (jsnare, tsnare, ("tight", "loose", "hiss", "smack"), "SnareConfig"),
    "bass": (jbass, tbass, ("acid", "sub", "reese", "stab"), "BassConfig"),
}


def _family_events():
    """3 blocks: staggered triggers, a retrigger, a block without any."""
    offs = [np.full(4, B, np.int32) for _ in range(N_BLOCKS)]
    vels = [np.zeros(4, np.float32) for _ in range(N_BLOCKS)]
    offs[0][:] = [0, 17, 40, 63]
    vels[0][:] = [1.0, 0.5, 0.8, 0.9]
    offs[1][2] = 5
    vels[1][2] = 0.7
    return offs, vels


@pytest.mark.parametrize("os_mode", MODES)
@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_family_render_block_matches_jax(kind, os_mode):
    jmod, tmod, presets, cfg_name = FAMILIES[kind]
    cfg = getattr(jmod, cfg_name)
    targets = np.stack([getattr(cfg, p)().as_array() for p in presets])
    static = dict(sample_rate=SR, block_size=B, smooth_coeff=smoothing_coeff(SR),
                  os_mode=os_mode)
    jrender = jax.jit(functools.partial(jmod.render_block, fused=False, **static))
    jst = jmod.init_state(4, targets=targets)
    tst = interop.family_state_from_numpy(kind, jst, "cpu")
    jouts, touts = [], []
    for blk, (off, vel) in enumerate(zip(*_family_events())):
        start = np.int32(blk * B)
        jst, jout = jrender(jst, jnp.asarray(off), jnp.asarray(vel), start)
        tst, tout = tmod.render_block(tst, off, vel, start, **static)
        jouts.append(jout)
        touts.append(tout)
    _check(f"{kind}@{os_mode}", jouts, touts, jst, tst)


def test_engine_gate_keeps_os2_families_off_the_kit_path(monkeypatch):
    """With the kit path on (``voice.IMPL = "pallas"``: its kernels' plain
    versions on the CPU), an ``os_mode`` 2 kick, snare and bass render on
    their own paths and the hihat2 and tom2 share the kit launch."""
    monkeypatch.setattr(voice, "IMPL", "pallas")
    seen = []
    real = voice.kit_render_fused

    def spy(*args, kinds, **kw):
        seen.append(tuple(kinds))
        return real(*args, kinds=kinds, **kw)

    monkeypatch.setattr(voice, "kit_render_fused", spy)
    eng = tengine.Engine(SR, block_size=B, device="cpu",
                         family_static={k: {"os_mode": 2} for k in ("kick", "snare", "bass")})
    for name in ("kick", "snare", "bass", "hihat2", "tom2"):
        eng.add_instrument(name, name)
        eng.trigger(name, 0.9)
    out = eng.render(B)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3
    assert seen == [("hihat2", "tom2")]
