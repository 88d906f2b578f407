"""The leftover functions of the port, each against its JAX twin on seeded
numpy inputs (the JAX side eager on the CPU).

The functions have no caller on a render path: ``core/dsp.py``'s panned,
mono, downmix, cubic_interpolate, raised_sine_window, normalize and
flush_denormals, ``envelope.adsr``, ``max_curve.segments_value``,
``rng.XorShift64Star``, ``smoother.smooth_block_traj``,
``scan.onepole_const`` and ``scan.nonlinear_scan``, ``ringbuf.read_int`` and
``affine_allpass_reads``, ``limiter.brick_wall``,
``common.fm_snap_block`` and ``saturation.repeat_to_rate``.

Each case states its tolerance: 0 where both sides make the same float32
operations (moves, selects, clamps, the integer generator bit for bit);
1e-6 where a transcendental or XLA's contraction of a product into an add
may move an ulp; the recurrences (``smooth_block_traj``, the associative
scan against the port's sequential one; ``fm_snap_block``, ``jnp.cumsum``'s
tree against a sequential sum) 1e-5.  Measured: 0.0 in 16 of the 23
float cases (also ``cubic_interpolate``, ``normalize``, ``onepole_const``,
``affine_allpass_reads`` and the envelope from ``adsr``), the rest at most
3.6e-7 (``nonlinear_scan``, ``smooth_block_traj``) and 5.4e-7
(``fm_snap_block``); the generator's 1,000 draws equal.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from libgooey_tpu.core import dsp as jdsp
from libgooey_tpu.core import envelope as jenv
from libgooey_tpu.core import max_curve as jmc
from libgooey_tpu.core import rng as jrng
from libgooey_tpu.core import smoother as jsm
from libgooey_tpu.effects import limiter as jlim
from libgooey_tpu.effects import saturation as jsat
from libgooey_tpu.instruments import common as jcommon
from libgooey_tpu.ops import ringbuf as jrb
from libgooey_tpu.ops import scan as jscan

from libgooey_tpu_torch.core import dsp as tdsp
from libgooey_tpu_torch.core import envelope as tenv
from libgooey_tpu_torch.core import max_curve as tmc
from libgooey_tpu_torch.core import rng as trng
from libgooey_tpu_torch.core import smoother as tsm
from libgooey_tpu_torch.effects import limiter as tlim
from libgooey_tpu_torch.effects import saturation as tsat
from libgooey_tpu_torch.instruments import common as tcommon
from libgooey_tpu_torch.ops import oversample as tovs
from libgooey_tpu_torch.ops import ringbuf as trb
from libgooey_tpu_torch.ops import scan as tscan

SR = 44100.0


def _rs(seed=0):
    return np.random.RandomState(seed)


def _f32(*shape, seed=0, lo=-1.0, hi=1.0):
    return _rs(seed).uniform(lo, hi, shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def case_panned():
    x, pan = _f32(4, 64), _f32(4, 1, seed=1, lo=-0.2, hi=1.2)
    return jdsp.panned(x, pan), tdsp.panned(_t(x), _t(pan)), 1e-6


def case_mono():
    x = _f32(3, 64)
    return jdsp.mono(x), tdsp.mono(_t(x)), 0.0


def case_downmix():
    x = _f32(2, 5, 64)
    return jdsp.downmix(x), tdsp.downmix(_t(x)), 0.0


def case_cubic_interpolate():
    p = [_f32(4, 64, seed=s) for s in range(4)]
    t = _f32(4, 64, seed=9, lo=0.0, hi=1.0)
    return (jdsp.cubic_interpolate(*p, t),
            tdsp.cubic_interpolate(*(_t(v) for v in p), _t(t)), 1e-6)


def case_raised_sine_window():
    phase = _f32(3, 128, lo=-0.2, hi=1.2)
    shape = _f32(3, 1, seed=1, lo=0.5, hi=4.0)
    return (jdsp.raised_sine_window(phase, shape),
            tdsp.raised_sine_window(_t(phase), _t(shape)), 1e-6)


def case_raised_sine_window_hann():
    phase = _f32(256, lo=0.0, hi=1.0)
    return jdsp.raised_sine_window(phase, 2.0), tdsp.raised_sine_window(_t(phase), 2.0), 1e-6


def case_normalize():
    v = _f32(64, lo=0.0, hi=2500.0)
    return jdsp.normalize(v, 20.0, 2000.0), tdsp.normalize(_t(v), 20.0, 2000.0), 1e-7


def case_flush_denormals():
    x = _f32(128) * np.float32(10.0) ** _rs(1).randint(-20, 2, 128).astype(np.float32)
    return jdsp.flush_denormals(x), tdsp.flush_denormals(_t(x)), 0.0


def case_adsr():
    args = (_f32(5, lo=-0.01, hi=0.05), _f32(5, seed=1, lo=0.0, hi=0.5),
            _f32(5, seed=2, lo=-0.5, hi=1.5), 0.0005, 2.0, _f32(5, seed=3, lo=0.5, hi=3.0))
    want = jenv.adsr(*args)
    got = tenv.adsr(*(_t(a) if isinstance(a, np.ndarray) else a for a in args))
    return tuple(want), tuple(got), 0.0


def case_adsr_amplitude():
    """The port's envelope from its ``adsr`` against the JAX one's."""
    args = (0.01, 0.2, 0.4, 0.3, 0.7, 2.0)
    e = _f32(4, 256, lo=-0.05, hi=0.5)
    rel = _f32(4, 256, seed=1, lo=-0.1, hi=0.3)
    return (jenv.amplitude(jenv.adsr(*args), e, rel),
            tenv.amplitude(tenv.adsr(*args), _t(e), _t(rel)), 1e-6)


def case_segments_value():
    elapsed = _f32(3, 256, lo=-0.01, hi=0.5)
    mid = _f32(3, 1, seed=1, lo=0.0, hi=0.2)
    args = dict(targets=(1.0, 0.3, 0.0), curves=(0.5, -0.3, 0.0))
    want = jmc.segments_value(elapsed, 0.1, durations=(0.01, mid, 0.2), **args)
    got = tmc.segments_value(_t(elapsed), 0.1, durations=(0.01, _t(mid), 0.2), **args)
    return want, got, 1e-6


def case_xorshift64star():
    j, t = jrng.XorShift64Star(0xDEADBEEF12345), trng.XorShift64Star(0xDEADBEEF12345)
    want = [j.next_u64() for _ in range(500)] + [j.next_white() for _ in range(500)]
    got = [t.next_u64() for _ in range(500)] + [t.next_white() for _ in range(500)]
    assert jrng.XorShift64Star().next_u64() == trng.XorShift64Star().next_u64()
    return want, got, "bits"


def case_smooth_block_traj():
    cur, tgt = _f32(4), _f32(4, 128, seed=1)
    c = jsm.smoothing_coeff(SR)
    return (jsm.smooth_block_traj(cur, tgt, c),
            tsm.smooth_block_traj(_t(cur), _t(tgt), c), 1e-5)


def case_smooth_block_traj_axis0():
    cur, tgt = _f32(4), _f32(96, 4, seed=1)
    return (jsm.smooth_block_traj(cur, tgt, 0.05, axis=0),
            tsm.smooth_block_traj(_t(cur), _t(tgt), 0.05, axis=0), 1e-5)


def case_onepole_const():
    x, y0 = _f32(5), _f32(5, seed=1)
    c = tsm.smoothing_coeff(SR)
    return jscan.onepole_const(c, x, y0, 64), tscan.onepole_const(c, _t(x), _t(y0), 64), 1e-6


def case_onepole_const_axis0():
    x, y0 = _f32(2, 3), _f32(2, 3, seed=1)
    return (jscan.onepole_const(0.2, x, y0, 32, axis=0),
            tscan.onepole_const(0.2, _t(x), _t(y0), 32, axis=0), 1e-6)


def case_nonlinear_scan():
    """A feedback tanh (the feedback waveshaper's form) written once in jnp
    and once in torch, a tree of inputs and of outputs."""
    x, g = _f32(6, 128), _f32(6, 128, seed=1, lo=0.5, hi=3.0)
    s0 = _f32(6, seed=2)

    def step_j(s, xs):
        xi, gi = xs
        s = jnp.tanh(gi * xi + 0.5 * s)
        return s, {"y": 2.0 * s, "d": s - xi}

    def step_t(s, xs):
        xi, gi = xs
        s = torch.tanh(gi * xi + 0.5 * s)
        return s, {"y": 2.0 * s, "d": s - xi}

    js, jy = jscan.nonlinear_scan(step_j, s0, (x, g))
    ts, ty = tscan.nonlinear_scan(step_t, _t(s0), (_t(x), _t(g)))
    return (js, jy["y"], jy["d"]), (ts, ty["y"], ty["d"]), 1e-6


def case_nonlinear_scan_axis0():
    x = _f32(64, 3)
    js, jy = jscan.nonlinear_scan(lambda s, xi: (0.9 * s + xi, s * xi), np.float32(0.25) +
                                  np.zeros(3, np.float32), x, axis=0)
    ts, ty = tscan.nonlinear_scan(lambda s, xi: (0.9 * s + xi, s * xi),
                                  torch.full((3,), 0.25), _t(x), axis=0)
    return (js, jy), (ts, ty), 1e-6


def _rings(seed, batch=()):
    buf = _f32(*batch, 64, seed=seed)
    pos = int(_rs(seed + 1).randint(0, 64))
    jring = jrb.Ring(buf=jnp.asarray(buf), pos=jnp.int32(pos))
    tring = trb.Ring(buf=_t(buf), pos=torch.tensor(pos, dtype=torch.int64))
    return jring, tring


def case_read_int():
    jring, tring = _rings(0, (2,))
    lags = _rs(3).randint(1, 50, (2, 16)).astype(np.int32)
    return jrb.read_int(jring, lags), trb.read_int(tring, _t(lags)), 0.0


def case_read_int_flat():
    """A ``[L]`` buffer read at lags of more axes."""
    jring, tring = _rings(4)
    lags = _rs(5).randint(1, 60, (3, 16)).astype(np.int32)
    return jrb.read_int(jring, lags), trb.read_int(tring, _t(lags)), 0.0


def case_affine_allpass_reads():
    pairs = [_rings(10 + 2 * i) for i in range(3)]
    gains = (0.6, -0.5, 0.7)
    offs = [_f32(16, seed=20 + i, lo=20.0, hi=40.0) for i in range(3)]
    want = jrb.affine_allpass_reads([p[0] for p in pairs], gains, offs)
    got = trb.affine_allpass_reads([p[1] for p in pairs], gains, [_t(o) for o in offs])
    assert want[0] == got[0] and want[2] == got[2]      # the Python products
    return (want[1], *want[3][1:], *want[4]), (got[1], *got[3][1:], *got[4]), 1e-6


def case_brick_wall():
    x = _f32(2, 256, lo=-3.0, hi=3.0)
    return jlim.brick_wall(x, 0.8), tlim.brick_wall(_t(x), 0.8), 0.0


def case_fm_snap_block():
    B = 256
    offs = np.array([0, 17, 200, 300], np.float32)
    elapsed = ((np.arange(B, dtype=np.float32)[None, :] - offs[:, None]) / np.float32(SR))
    phase0 = _f32(4, lo=0.0, hi=6.0)
    jp, jy = jcommon.fm_snap_block(phase0, elapsed, SR)
    tp, ty = tcommon.fm_snap_block(_t(phase0), _t(elapsed), SR)
    return (jp, jy), (tp, ty), 1e-5


def case_repeat_to_rate():
    assert tsat.repeat_to_rate is tovs.repeat_to_rate
    p, v = _f32(3, 64), np.zeros((3, 256), np.float32)
    return (jsat.repeat_to_rate(p, v, 64), tsat.repeat_to_rate(_t(p), _t(v), 64), 0.0)


CASES = {name[5:]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _flat(item)]
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(x)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_leftover_matches_jax(name):
    want, got, tol = CASES[name]()
    if tol == "bits":
        assert want == got
        return
    want, got = _flat(want), _flat(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape, (name, w.shape, g.shape)
        assert g.dtype == w.dtype, (name, w.dtype, g.dtype)
        w64, g64 = w.astype(np.float64), g.astype(np.float64)
        assert np.isfinite(w64).all()
        err = float(np.max(np.abs(w64 - g64), initial=0.0))
        assert err <= tol, f"{name}: max error {err} (tol {tol})"
