"""The five drum families of the configurations, in plain NumPy: one row per
voice, ticked sample by sample.

Each family is the per-voice oracle of upstream's instrument (kick.rs,
snare.rs, hihat2.rs, tom2.rs, bass.rs, as this repository's numpy oracles
``tests/*_oracle.py`` state them), written over a row of voices, with its
constants written in.  Float32 where the oracle rounds to float32, float64
where it computes in Python floats.  Nothing of the program is imported.

A family's state is a dict of arrays named by what they mean (nested dicts
for the oversampler and the smoothers); ``render(state, off, vel,
block_start)`` takes the block's trigger offsets (``block_size`` for none)
and velocities ``[V]`` and returns ``(new_state, out [V, B] float32)``.
A voice never struck holds ``trig_sample == NEVER``.
"""

from __future__ import annotations

import copy

import numpy as np

F32, F64 = np.float32, np.float64
NEVER = -(2 ** 30)
M32 = 0xFFFFFFFF
TWO_PI = float(np.float32(2.0 * np.pi))
DEFAULT_SEED = 0x9ABCDEF0
RAND_SEED = 0x12345678
#: the parameter smoothers' time (ms) and the settle snap
SMOOTH_MS = 15.0
SETTLE = 1e-4


def f32(x):
    return np.asarray(x, dtype=F32)


def f64(x):
    return np.asarray(x, dtype=F64)


def smoothing_coeff(sample_rate: float, ms: float = SMOOTH_MS) -> float:
    """``1 - exp(-1 / (ms * sr / 1000))``."""
    return float(1.0 - np.exp(-1.0 / (ms / 1000.0 * sample_rate)))


# --- counter-based noise ------------------------------------------------------

def _mix32(x):
    x = x & M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    x ^= x >> 16
    return x


def _seed_mix(seed: int) -> int:
    return int(_mix32(np.array([(seed * 0x9E3779B9 + 0x85EBCA6B) & M32], np.uint64))[0])


_SEEDS = {s: _seed_mix(s) for s in (DEFAULT_SEED, RAND_SEED)}


def white(counter, seed: int = DEFAULT_SEED):
    """White noise in [-1, 1] (float32) from integer counters (their low 32
    bits): the top 24 bits of a murmur-style hash of counter and seed."""
    c = (np.asarray(counter).astype(np.int64) & M32).astype(np.uint64)
    bits = _mix32(c ^ np.uint64(_SEEDS[seed])) >> np.uint64(8)
    return bits.astype(F32) / F32(2 ** 24 - 1) * F32(2.0) - F32(1.0)


#: pink noise: three one-poles at 44.1 kHz (pink_noise.rs), the direct and
#: output gains
PINK_POLES = (0.99765, 0.963, 0.57)
PINK_GAINS = (0.0990460, 0.2965164, 1.0526913)
PINK_DIRECT, PINK_OUTPUT = 0.1848, 0.11


def pink_coefficients(sample_rate: float):
    ratio = 44100.0 / max(sample_rate, 1.0)
    p0 = np.array(PINK_POLES, F64)
    poles = p0 ** ratio
    gains = np.array(PINK_GAINS, F64) * np.sqrt((1.0 - poles * poles) / (1.0 - p0 * p0))
    return [float(F32(p)) for p in poles], [float(F32(g)) for g in gains]


# --- shared shapes --------------------------------------------------------------

def denorm(x, lo, hi):
    return f32(lo + np.clip(f64(x), 0.0, 1.0) * (hi - lo))


def tuning_mult(x):
    return f32(2.0 ** (((np.clip(f64(x), 0.0, 1.0) - 0.5) * 24.0) / 12.0))


def adsr(elapsed, attack, decay, sustain, a_curve=1.0, d_curve=1.0):
    """Attack-decay-sustain amplitude with power curves (envelope.rs)."""
    el = f64(elapsed)
    attack = np.maximum(f64(attack), 0.001)
    decay = np.maximum(f64(decay), 0.001)
    ac = np.clip(f64(a_curve), 0.1, 10.0)
    dc = np.clip(f64(d_curve), 0.1, 10.0)
    pa = np.clip(el / attack, 0.0, None) ** ac
    pd = np.clip((el - attack) / decay, 0.0, None) ** dc
    out = np.where(el < attack + decay, 1.0 - (1.0 - sustain) * pd, sustain)
    out = np.where(el < attack, pa, out)
    return f32(np.where(el < 0.0, 0.0, out))


def max_curve(p, c: float):
    """Max/MSP's curve~ shape of ``p`` in [0, 1] with curvature ``c``."""
    p = np.clip(f64(p), 0.0, 1.0)
    cabs = abs(c)
    if cabs < 1e-6:
        return f32(p)
    hp = ((cabs + 1e-20) * 1.2) ** 0.41 * 0.91
    fp = hp / (1.0 - hp)

    def one_sided(q):
        return q if abs(fp) < 1e-6 else np.expm1(fp * q) / np.expm1(fp)

    return f32(1.0 - one_sided(1.0 - p)) if c < 0 else f32(one_sided(p))


def smoother_tick_add(sm, coeff):
    """``cur += coeff * (tgt - cur)`` where they differ, snapped at 1e-4
    (the kick's and the snare's smoothers)."""
    cur, tgt = sm["current"], sm["target"]
    new = f32(cur + coeff * (tgt - cur))
    new = np.where(np.abs(new - tgt) < SETTLE, tgt, new)
    sm["current"] = np.where(cur != tgt, new, cur).astype(F32)
    return sm["current"]


def smoother_tick_decay(sm, q):
    """``cur = tgt + (cur - tgt) * q``, snapped at 1e-4 (the hihat2's and
    the bass's smoothers)."""
    cur, tgt = sm["current"], sm["target"]
    delta = f32((cur - tgt) * q)
    sm["current"] = f32(tgt + np.where(np.abs(delta) < SETTLE, F32(0.0), delta))
    return sm["current"]


# --- the 4x polyphase oversampler (hiir-style halfbands) ------------------------

#: allpass coefficients of the two halfband stages (float32 values)
STAGE1 = (0.040633462369441986, 0.15050512552261353, 0.3007570505142212, 0.4607745110988617,
          0.6095243096351624, 0.7385038137435913, 0.849223792552948, 0.9497427940368652)
STAGE2 = (0.04955103620886803, 0.1935703307390213, 0.4267366826534271, 0.7670700550079346)
_STAGES = (("up1", STAGE1), ("up2", STAGE2), ("down2", STAGE2), ("down1", STAGE1))


def ovs_init(V: int) -> dict:
    """Each halfband: its two allpass chains' last inputs ``x`` and outputs
    ``y`` ``[V, 2, n]`` (chain 0 on the even coefficients, chain 1 on the
    odd), and the decimators' one-sample odd-phase delay ``x1``."""
    return {name: {"x": np.zeros((V, 2, len(coefs) // 2), F32),
                   "y": np.zeros((V, 2, len(coefs) // 2), F32), "x1": np.zeros(V, F32)}
            for name, coefs in _STAGES}


def _chains(coefs, h, s):
    """The halfband's two allpass chains side by side on ``s [V, 2]``."""
    a = np.array([coefs[0::2], coefs[1::2]], F32)          # [2, n]
    x, y = h["x"], h["y"]
    for i in range(a.shape[1]):
        out = f32(a[:, i] * s + x[:, :, i] - a[:, i] * y[:, :, i])
        x[:, :, i] = s
        y[:, :, i] = out
        s = out
    return s


def _up(coefs, h, v):
    s = _chains(coefs, h, np.stack([v, v], axis=1))
    return s[:, 0], s[:, 1]


def _down(coefs, h, even, odd):
    s = _chains(coefs, h, np.stack([f32(even), h["x1"]], axis=1))
    h["x1"] = f32(odd).copy()
    return f32(0.5 * (s[:, 0] + s[:, 1]))


def ovs_process(st: dict, x, fn):
    """One engine-rate sample through ``fn`` at 4x."""
    e, o = _up(STAGE1, st["up1"], f32(x))
    hi = _up(STAGE2, st["up2"], e) + _up(STAGE2, st["up2"], o)
    y = [f32(fn(v)) for v in hi]
    d0 = _down(STAGE2, st["down2"], y[0], y[1])
    d1 = _down(STAGE2, st["down2"], y[2], y[3])
    return _down(STAGE1, st["down1"], d0, d1)


def _additive(idx, freq, nyq: float, sr: float, max_harmonics: int):
    """Odd harmonics ``1/i^2`` up to Nyquist and ``max_harmonics``, with the
    quadratic Gibbs taper over the top quarter of the band."""
    i = np.arange(1, max_harmonics + 1, 2, dtype=F32)[None, :]
    hf = f32(freq[:, None] * i)
    ratio = f64(hf) / nyq
    taper = np.where(ratio > 0.75, 1.0 - ((ratio - 0.75) / 0.25) ** 2, 1.0)
    arg = f32(f32(idx[:, None] * hf) * F32(TWO_PI)) / F32(sr)
    term = f32((1.0 / f64(i) ** 2) * taper * f64(np.sin(arg)))
    max_h = np.floor(f64(nyq) / f64(freq))[:, None]
    active = (i <= max_h) & (f64(hf) <= nyq)
    return np.where(active, term, F32(0.0)).sum(axis=1, dtype=F32)


def _take(state, rows):
    return {k: _take(v, rows) if isinstance(v, dict) else v[rows] for k, v in state.items()}


def _put(state, rows, sub):
    for k, v in sub.items():
        if isinstance(v, dict):
            _put(state[k], rows, v)
        else:
            state[k][rows] = v


class Family:
    """What the families share: a preset of normalized params, a voice
    count, the block's triggers."""

    PARAMS: tuple = ()

    def __init__(self, sample_rate: float, block_size: int, **static):
        self.sr, self.B = float(sample_rate), int(block_size)
        self.static = static
        self.P = {n: i for i, n in enumerate(self.PARAMS)}

    #: fields that mean nothing until a voice is first struck
    STRUCK_ONLY: tuple = ()

    @classmethod
    def meaningful(cls, state: dict) -> dict:
        """``{field: rows}``: the voices on which a field means something
        (fields not named mean something on every voice)."""
        struck = state["trig_sample"] != NEVER
        return {k: struck for k in cls.STRUCK_ONLY}

    #: a voice never struck is silent and its state still (the kick's and
    #: the snare's oracles), so such rows need no ticking
    STILL_UNTIL_STRUCK = False

    def render(self, state: dict, off, vel, block_start: int):
        st = copy.deepcopy(state)
        off = np.asarray(off).astype(np.int64)
        vel = f32(vel)
        outs = np.zeros((len(off), self.B), F32)
        rows = None
        if self.STILL_UNTIL_STRUCK:
            live = (st["trig_sample"] != NEVER) | (off < self.B)
            if not live.all():
                rows = np.flatnonzero(live)
        sub = st if rows is None else _take(st, rows)
        o, v = (off, vel) if rows is None else (off[rows], vel[rows])
        for j in range(self.B):
            y = self.tick(sub, o == j, v, int(block_start) + j, j)
            if rows is None:
                outs[:, j] = y
            else:
                outs[rows, j] = y
        if rows is not None:
            _put(st, rows, sub)
            # the still voices' parameter smoothers tick all the same
            idle = np.ones(len(off), bool)
            idle[rows] = False
            sm = _take(st["params"], np.flatnonzero(idle))
            for _ in range(self.B):
                smoother_tick_add(sm, smoothing_coeff(self.sr))
            _put(st["params"], np.flatnonzero(idle), sm)
        return st, outs


# --- kick ---------------------------------------------------------------------------

class Kick(Family):
    PARAMS = ("frequency", "punch", "sub", "click", "oscillator_decay", "pitch_envelope_amount",
              "pitch_envelope_curve", "volume", "pitch_start_ratio", "phase_mod_amount",
              "noise_amount", "noise_cutoff", "noise_resonance", "overdrive", "feedback",
              "feedback_cutoff", "amp_decay", "amp_decay_curve", "tuning")
    #: fields a voice never struck holds without meaning (the oracle keeps
    #: such a voice silent and still)
    STRUCK_ONLY = ("velocity", "pitch_mult", "pitch_curve", "amp_decay", "amp_curve",
                   "pm_active", "click", "svf", "pink", "shaper")
    STILL_UNTIL_STRUCK = True

    def init(self, preset, V: int) -> dict:
        p = np.broadcast_to(f32(preset), (V, len(self.PARAMS))).copy()
        z = lambda: np.zeros(V, F32)
        return {"params": {"current": p, "target": p.copy()},
                "trig_sample": np.full(V, NEVER, np.int64), "velocity": np.ones(V, F32),
                "pitch_mult": np.ones(V, F32), "pitch_curve": np.ones(V, F32),
                "amp_decay": np.full(V, 0.5, F32), "amp_curve": np.ones(V, F32),
                "pm_active": np.zeros(V, bool), "click": z(),
                "svf": {"ic1": z(), "ic2": z()}, "pink": np.zeros((V, 3), F32),
                "shaper": {"last": z(), "filt": z(), "dcx": z(), "dcy": z(), "env": z(),
                           "ovs": ovs_init(V)}}

    def tick(self, st, trig, vel_in, n, j):
        P, sr = self.P, self.sr
        cur = st["params"]["current"]
        if trig.any():
            v = np.clip(vel_in, 0.0, 1.0)
            scale = 1.0 - 0.5 * f64(v) * v
            pea = cur[:, P["pitch_envelope_amount"]]
            psr = denorm(cur[:, P["pitch_start_ratio"]], 1.0, 10.0)
            pc = denorm(cur[:, P["pitch_envelope_curve"]], 0.1, 4.0)
            ad = f32(denorm(cur[:, P["amp_decay"]], 0.0, 4.0) * scale)
            ac = denorm(cur[:, P["amp_decay_curve"]], 0.1, 10.0)
            sets = {"velocity": v, "trig_sample": np.full_like(st["trig_sample"], n),
                    "pitch_mult": f32(1.0 + (psr - 1.0) * pea),
                    "pitch_curve": np.where(np.abs(pc - 1.0) < 0.01, F32(1.0), pc),
                    "amp_decay": ad, "amp_curve": np.where(np.abs(ac - 1.0) < 0.01, F32(1.0), ac),
                    "pm_active": cur[:, P["phase_mod_amount"]] > 0.001}
            for k, val in sets.items():
                st[k] = np.where(trig, val, st[k]).astype(st[k].dtype)
            st["click"] = np.where(trig, F32(0.0), st["click"])
            for k in ("ic1", "ic2"):
                st["svf"][k] = np.where(trig, F32(0.0), st["svf"][k])
            st["pink"] = np.where(trig[:, None], F32(0.0), st["pink"])
        vals = smoother_tick_add(st["params"], smoothing_coeff(sr))
        val = lambda name: vals[:, P[name]]
        struck = st["trig_sample"] != NEVER
        ei = n - st["trig_sample"]
        idx = f32(ei)
        elapsed = f32(idx / F32(sr))
        vel = st["velocity"]
        scale = f32(1.0 - 0.5 * f64(vel) * vel)
        base_decay = f32(denorm(val("oscillator_decay"), 0.01, 4.0) * scale)
        semis = (np.clip(f64(val("tuning")), 0.0, 1.0) - 0.5) * 24.0
        base_freq = f32(denorm(val("frequency"), 30.0, 120.0) * 2.0 ** (semis / 12.0))
        pitch_env = adsr(elapsed, 0.001, base_decay, 0.0, 1.0, st["pitch_curve"])
        fmult = f32(1.0 + (st["pitch_mult"] - 1.0) * pitch_env)
        pm_amt = f64(val("phase_mod_amount"))
        el = f64(elapsed)
        pm = np.where(el < 0.001, np.clip(el / 0.001, 0.0, None) ** 0.3,
                      1.0 - np.clip((el - 0.001) / 0.005, 0.0, None) ** 0.4)
        pm_on = (pm_amt > 0.001) & st["pm_active"] & (el >= 0.0) & (el <= 0.006)
        fmult = np.where(pm_on, f32(fmult * (1.0 + pm * pm_amt * 2.0)), fmult)
        osc_env = adsr(elapsed, 0.001, base_decay, 0.0)
        sub = f32(np.sin(f32(f32(idx * f32(base_freq * fmult)) * F32(TWO_PI)) / F32(sr)))
        sub = sub * osc_env * val("sub")
        punch = F32(0.0)
        mh = int(self.static.get("max_harmonics", 256))
        if mh > 0:
            acc = _additive(idx, f32(base_freq * F32(2.5) * fmult), sr / 2, sr, mh)
            punch = acc * osc_env * f32(val("punch") * 0.7)
        click_env = adsr(elapsed, 0.001, base_decay * 0.2, 0.0)
        cvs = 0.6 + 0.4 * f64(vel)
        click_raw = white(np.floor(idx).astype(np.int64)) * click_env * f32(val("click") * 0.15 * cvs)
        alpha = float(F32(1.0 - np.exp(-2.0 * np.pi * 8000.0 / sr)))
        hp = f32(click_raw - st["click"])
        st["click"] = f32(st["click"] + alpha * hp)
        click_out = f32(hp * (1.0 + 4.0 * 0.1))
        poles, gains = pink_coefficients(sr)
        w = white(ei)
        for k in range(3):
            st["pink"][:, k] = f32(poles[k] * st["pink"][:, k] + gains[k] * w)
        pink = f32((st["pink"].sum(axis=1, dtype=F32) + w * PINK_DIRECT) * PINK_OUTPUT)
        cut = denorm(val("noise_cutoff"), 20.0, 10000.0)
        res = denorm(val("noise_resonance"), 0.0, 5.0)
        g = f32(np.tan(np.pi * np.clip(f64(cut), 20.0, sr * 0.45) / sr))
        r = f32(1.0 / np.clip(f64(res), 0.5, 10.0))
        h = f32(1.0 / (1.0 + f64(r) * g + f64(g) * g))
        svf = st["svf"]
        v1 = f32((g * (pink - svf["ic2"]) + svf["ic1"]) * h)
        v2 = f32(svf["ic2"] + g * v1)
        svf["ic1"] = f32(2 * v1 - svf["ic1"])
        svf["ic2"] = f32(2 * v2 - svf["ic2"])
        nf = np.where(np.abs(v2) < 1e-15, F32(0.0), v2)
        noise_env = adsr(elapsed, 0.001, base_decay, 0.0)
        noise_amt = val("noise_amount")
        noise_out = np.where(noise_amt > 0.001, f32(nf * noise_env * noise_amt * 0.5), F32(0.0))
        total = f32(sub + punch + click_out + noise_out)
        shaped = self._shaper(st["shaper"], total, val)
        amp_env = adsr(elapsed, 0.001, np.maximum(f64(st["amp_decay"]), 0.001), 0.0, 0.5,
                       st["amp_curve"])
        out = f32(shaped * amp_env * f32(np.sqrt(f64(vel))) * val("volume"))
        return np.where(struck, out, F32(0.0))

    def _shaper(self, s, total, val):
        """The feedback waveshaper at mix 1 (feedback_waveshaper.rs)."""
        sr = self.sr
        drive = f32(1.0 + f64(val("overdrive")) ** 3 * 40.0)
        fb = f32(val("feedback") * 0.98)
        fc = np.clip(200.0 + f64(val("feedback_cutoff")) * 3800.0, 200.0, 20000.0)
        gcoef = f32(np.clip(1.0 - np.exp(-2.0 * np.pi * fc / sr), 0.0, 0.9))
        att = float(F32(np.exp(-1.0 / (0.001 * sr))))
        rel = float(F32(np.exp(-1.0 / (0.120 * sr))))
        shaped = ovs_process(s["ovs"], f32(drive * total + fb * s["last"]), np.tanh)
        on = drive > 1.0
        rect = np.abs(total)
        c = np.where(rect > s["env"], att, rel)
        env = f32(s["env"] + (1.0 - c) * (rect - s["env"]))
        ref = np.maximum(f64(env), 0.05)
        driven = np.maximum(np.abs(np.tanh(ref * drive)), 1e-6)
        comp_no_fb = f32(np.tanh(ref) / driven)
        dn = np.clip((f64(drive) - 1.0) / 99.0, 0.0, 1.0)
        fn_ = np.clip(f64(fb) / 0.98, 0.0, 1.0)
        makeup = 10.0 ** (5.1 * (dn ** 1.35 * fn_ ** 2.0) / 20.0)
        taming = 1.0 / (1.0 + comp_no_fb * f64(fb) * 0.25)
        comp = f32(np.minimum(comp_no_fb * taming * makeup, 3.0))
        compensated = f32(shaped * comp)
        dc_out = f32(compensated - s["dcx"] + 0.995 * s["dcy"])
        filt = f32(s["filt"] + gcoef * (dc_out - s["filt"]))
        for k, v in (("env", env), ("dcx", compensated), ("dcy", dc_out), ("filt", filt),
                     ("last", filt)):
            s[k] = np.where(on, v, s[k]).astype(F32)
        return np.where(on, dc_out, total)


# --- snare --------------------------------------------------------------------------

class Snare(Family):
    PARAMS = ("frequency", "tonal", "noise", "brightness", "decay", "pitch_drop", "volume",
              "tonal_decay", "tonal_decay_curve", "noise_decay", "noise_tail_decay",
              "filter_cutoff", "filter_resonance", "xfade", "phase_mod_amount", "overdrive",
              "amp_decay", "amp_decay_curve", "tuning")
    STRUCK_ONLY = ("velocity", "pitch_mult", "amp_curve", "tonal_curve", "amp_decay",
                   "pm_active", "noise_svf")
    STILL_UNTIL_STRUCK = True

    @classmethod
    def meaningful(cls, state):
        """The shaper's oversampler history only where the shaper drives
        (overdrive above 0); bypassed, it is never heard."""
        rows = super().meaningful(state)
        drives = state["params"]["current"][:, cls.PARAMS.index("overdrive")] > 0.0
        rows["ovs"] = rows["velocity"] & drives
        return rows

    def init(self, preset, V: int, filter_type: int = 1) -> dict:
        p = np.broadcast_to(f32(preset), (V, len(self.PARAMS))).copy()
        z = lambda: np.zeros(V, F32)
        return {"params": {"current": p, "target": p.copy()},
                "filter_type": np.full(V, filter_type, np.int64),
                "trig_sample": np.full(V, NEVER, np.int64), "velocity": np.full(V, 0.5, F32),
                "pitch_mult": np.ones(V, F32), "amp_curve": np.ones(V, F32),
                "tonal_curve": np.ones(V, F32), "amp_decay": np.full(V, 0.5, F32),
                "pm_active": np.zeros(V, bool), "noise_svf": {"low": z(), "band": z()},
                "ovs": ovs_init(V)}

    def tick(self, st, trig, vel_in, n, j):
        P, sr = self.P, self.sr
        cur = st["params"]["current"]
        if trig.any():
            v = np.clip(vel_in, 0.0, 1.0)
            scale = 1.0 - 0.45 * f64(v) ** 2
            sets = {"velocity": v, "trig_sample": np.full_like(st["trig_sample"], n),
                    "pitch_mult": f32(1.0 + f64(cur[:, P["pitch_drop"]]) * 1.5),
                    "tonal_curve": denorm(cur[:, P["tonal_decay_curve"]], 0.1, 10.0),
                    "amp_decay": f32(denorm(cur[:, P["amp_decay"]], 0.0, 4.0) * scale),
                    "amp_curve": denorm(cur[:, P["amp_decay_curve"]], 0.1, 10.0),
                    "pm_active": cur[:, P["phase_mod_amount"]] > 0.001}
            for k, val in sets.items():
                st[k] = np.where(trig, val, st[k]).astype(st[k].dtype)
            for k in ("low", "band"):
                st["noise_svf"][k] = np.where(trig, F32(0.0), st["noise_svf"][k])
        vals = smoother_tick_add(st["params"], smoothing_coeff(sr))
        val = lambda name: vals[:, P[name]]
        struck = st["trig_sample"] != NEVER
        ei = n - st["trig_sample"]
        idx = f32(ei)
        elapsed = f32(idx / F32(sr))
        el = f64(elapsed)
        vel2 = f64(st["velocity"]) ** 2
        decay_scale = f32(1.0 - 0.45 * vel2)
        pitch_scale = f32(1.0 - 0.5 * vel2)
        scaled_decay = f32(denorm(val("decay"), 0.05, 3.5) * decay_scale)
        pitch_decay = np.minimum(f64(scaled_decay) * 0.3 * pitch_scale, f64(scaled_decay) * 0.25)
        semis = (np.clip(f64(val("tuning")), 0.0, 1.0) - 0.5) * 24.0
        base_freq = f32(denorm(val("frequency"), 100.0, 600.0) * 2.0 ** (semis / 12.0))
        pitch_env = adsr(elapsed, 0.001, pitch_decay, 0.0)
        fmult = f32(1.0 + (st["pitch_mult"] - 1.0) * pitch_env)
        pm_amt = f64(val("phase_mod_amount"))
        pm = np.where(el < 0.001, np.clip(el / 0.001, 0.0, None) ** 0.3,
                      1.0 - np.clip((el - 0.001) / 0.005, 0.0, None) ** 0.4)
        pm_on = (pm_amt > 0.001) & st["pm_active"] & (el >= 0.0) & (el <= 0.006)
        fmult = np.where(pm_on, f32(fmult * (1.0 + pm * pm_amt)), fmult)
        hold_env = adsr(elapsed, 0.001, 0.001, 1.0)
        acc = _additive(idx, f32(base_freq * fmult), sr / 2, sr,
                        int(self.static.get("max_harmonics", 256)))
        tonal_env = adsr(elapsed, 0.001, denorm(val("tonal_decay"), 0.0, 3.5) * decay_scale, 0.0,
                         1.0, st["tonal_curve"])
        xf = val("xfade")
        tonal_out = acc * hold_env * val("tonal") * tonal_env * (1 - xf)
        w = white(np.floor(idx).astype(np.int64))
        noise_raw = f32(w * hold_env * val("noise") * 0.8)
        cutoff = denorm(val("filter_cutoff"), 100.0, 10000.0)
        res = denorm(val("filter_resonance"), 0.5, 10.0)
        f = f32(2.0 * np.sin(np.pi * np.minimum(f64(cutoff) / sr, 0.45)))
        q = f32(1.0 / np.maximum(f64(res), 0.5))
        s = st["noise_svf"]
        high = np.zeros_like(f)
        for _ in range(2):
            s["low"] = f32(s["low"] + f * s["band"])
            high = f32(noise_raw - s["low"] - q * s["band"])
            s["band"] = f32(f * high + s["band"])
        ft = st["filter_type"]
        filtered = np.where(ft == 0, s["low"], np.where(ft == 2, high, np.where(
            ft == 3, f32(s["low"] + high), s["band"])))
        noise_env = adsr(elapsed, 0.001, denorm(val("noise_decay"), 0.0, 3.5) * decay_scale, 0.0)
        tail_env = adsr(elapsed, 0.001, denorm(val("noise_tail_decay"), 0.0, 3.5) * decay_scale,
                        0.0)
        noise_out = f32(filtered * (noise_env * 0.7 + tail_env * 0.3) * xf)
        crack_env = adsr(elapsed, 0.001, f64(scaled_decay) * 0.2, 0.0)
        crack_out = f32(w * crack_env * val("brightness") * 0.4
                        * (0.7 + 0.3 * f64(st["velocity"])))
        total = f32(tonal_out + noise_out + crack_out)
        drive = f32(1.0 + f64(val("overdrive")) * 9.0)
        d_eff = np.maximum(f64(drive), 1.0 + 1e-6)
        comp = f32(np.tanh(0.5) / np.tanh(0.5 * d_eff))
        shaped_os = ovs_process(st["ovs"], total, lambda x: np.tanh(x * d_eff) * comp)
        shaped = np.where(drive <= 1.0, total, shaped_os)
        amp_env = adsr(elapsed, 0.001, np.maximum(f64(st["amp_decay"]), 0.001), 0.0, 1.0,
                       st["amp_curve"])
        out = f32(shaped * amp_env * f32(np.sqrt(f64(st["velocity"]))) * val("volume"))
        return np.where(struck, out, F32(0.0))


# --- hihat2 -------------------------------------------------------------------------

class HiHat2(Family):
    PARAMS = ("pitch", "decay", "attack", "tone", "volume", "tuning")
    SALT_MULT = 0x9E3779B9

    @classmethod
    def meaningful(cls, state):
        """The pink filter only on voices of pink noise colour."""
        return {"pink": state["noise_color"] == 1}

    def init(self, preset, V: int, filter_slope: int = 1, noise_color: int = 0) -> dict:
        p = np.broadcast_to(f32(np.clip(preset, 0.0, 1.0)), (V, len(self.PARAMS))).copy()
        z = lambda: np.zeros(V, F32)
        bq = lambda: {"x1": z(), "x2": z(), "y1": z(), "y2": z()}
        return {"params": {"current": p, "target": p.copy()},
                "noise_color": np.full(V, noise_color, np.int64),
                "filter_slope": np.full(V, filter_slope, np.int64),
                "trig_sample": np.full(V, NEVER, np.int64), "velocity": np.ones(V, F32),
                "mod_phase": np.zeros(V, F64), "main_phase": np.zeros(V, F64),
                "env": z(), "hp1": bq(), "hp2": bq(), "svf": {"ic1": z(), "ic2": z()},
                "pink": np.zeros((V, 3), F32),
                "voice_salt": np.arange(V, dtype=np.int64)}

    @staticmethod
    def _biquad(s, x, b, reset):
        b0, b1, b2, a1, a2 = b
        for k in ("x1", "x2", "y1", "y2"):
            s[k] = np.where(reset, F32(0.0), s[k])
        y = f32(b0 * x + b1 * s["x1"] + b2 * s["x2"] - a1 * s["y1"] - a2 * s["y2"])
        out = np.where(np.abs(y) < 1e-15, F32(0.0), y)
        s["x2"], s["x1"], s["y2"], s["y1"] = s["x1"], f32(x), s["y1"], y
        return out

    def tick(self, st, trig, vel_in, n, j):
        sr = self.sr
        reset = trig
        st["velocity"] = np.where(reset, np.clip(vel_in, 0.0, 1.0), st["velocity"]).astype(F32)
        st["trig_sample"] = np.where(reset, n, st["trig_sample"])
        q = float(F32(1.0 - smoothing_coeff(sr)))
        p = smoother_tick_decay(st["params"], q)
        val = lambda name: p[:, self.P[name]]
        elapsed = (n - st["trig_sample"]) / sr
        attack_s = f64(denorm(val("attack"), 0.5, 200.0)) * 0.001
        decay_s = f64(denorm(val("decay"), 0.5, 4000.0)) * 0.001
        pitch_hz = f32(denorm(f32(val("pitch") * val("pitch")), 3500.0, 10000.0)
                       * tuning_mult(val("tuning")))
        salt = (st["voice_salt"] * self.SALT_MULT) & M32
        w = white((n + salt) & M32)
        poles, gains = pink_coefficients(sr)
        for k in range(3):
            st["pink"][:, k] = np.where(st["noise_color"] == 1,
                                        f32(poles[k] * st["pink"][:, k] + gains[k] * w),
                                        st["pink"][:, k])
        pink = f32((st["pink"].sum(axis=1, dtype=F32) + w * PINK_DIRECT) * PINK_OUTPUT)
        noise = np.where(st["noise_color"] == 1, pink, w)
        mod_inc = f32(pitch_hz * 0.1 / sr)
        main_inc = f32(pitch_hz / sr)
        st["mod_phase"] = (f64(mod_inc) + np.where(reset, 0.0, st["mod_phase"])) % 1.0
        st["main_phase"] = (f64(main_inc) + np.where(reset, 0.0, st["main_phase"])) % 1.0
        mod_out = f32(np.sin(TWO_PI * ((st["mod_phase"] + f64(f32(noise * F32(0.25)))) % 1.0)))
        main_out = f32(np.sin(TWO_PI * ((st["main_phase"] + f64(f32(mod_out * F32(0.75)))) % 1.0)))
        omega = 2.0 * np.pi * f64(pitch_hz) / sr
        sin_o, cos_o = np.sin(omega), np.cos(omega)
        alpha = sin_o / 2.0
        a0 = 1.0 + alpha
        b = (f32((1.0 + cos_o) / 2.0 / a0), f32(-(1.0 + cos_o) / a0),
             f32((1.0 + cos_o) / 2.0 / a0), f32(-2.0 * cos_o / a0), f32((1.0 - alpha) / a0))
        y1 = self._biquad(st["hp1"], main_out, b, reset)
        y2 = self._biquad(st["hp2"], y1, b, reset)
        filtered = np.where(st["filter_slope"] == 1, f32(y2 * F32(0.8)), y1)
        prog_a = np.where(attack_s > 0, elapsed / np.maximum(attack_s, 1e-9), 1.0)
        prog_d = np.where(decay_s > 0, (elapsed - attack_s) / np.maximum(decay_s, 1e-9), 1.0)
        env_raw = np.where(elapsed < attack_s, max_curve(prog_a, -0.3),
                           f32(1.0 - max_curve(np.clip(prog_d, 0.0, 1.0), -0.8)))
        env_raw = np.where(elapsed < 0.0, F32(0.0), env_raw)
        down_k = float(F32(1.0 - np.exp(-1.0 / 100.0)))
        prev = np.where(reset, F32(0.0), st["env"])
        st["env"] = f32(np.maximum(env_raw, (1.0 - down_k) * prev + down_k * env_raw))
        output = f32(filtered * st["env"] * st["velocity"] * F32(0.35))
        tone = np.clip(f64(denorm(val("tone"), 500.0, 10000.0)), 20.0, sr * 0.45)
        g = f32(np.tan(np.pi * tone / sr))
        r = F32(2.0)
        h = f32(1.0 / (1.0 + r * f64(g) + f64(g) * g))
        svf = st["svf"]
        for k in ("ic1", "ic2"):
            svf[k] = np.where(reset, F32(0.0), svf[k])
        v1 = f32((g * (output - svf["ic2"]) + svf["ic1"]) * h)
        v2 = f32(svf["ic2"] + g * v1)
        hp = f32(output - (r * v1 + v2))
        svf["ic1"] = f32(2.0 * v1 - svf["ic1"])
        svf["ic2"] = f32(2.0 * v2 - svf["ic2"])
        return f32(hp * val("volume"))


# --- tom2 ---------------------------------------------------------------------------

#: the click impulse (the Max patch's table), one value a sample from the strike
TOM_IMPULSE = (
    0.884058, 0.942029, 0.913043, 0.869565, 0.833333, 0.797101, 0.772947, 0.748792,
    0.724638, 0.695652, 0.666667, 0.637681, 0.619565, 0.601449, 0.583333, 0.565217,
    0.536232, 0.507246, 0.478261, 0.449275, 0.42029, 0.391304, 0.371981, 0.352657,
    0.333333, 0.304348, 0.275362, 0.23913, 0.202899, 0.181159, 0.15942, 0.137681,
    0.115942, 0.101449, 0.086957, 0.072464, 0.057971, 0.043478, 0.028986, 0.014493,
    0.009662, 0.004831, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.014493, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
#: the membrane's five modes: (gain, Hz, Q)
MEMBRANE = ((275.0, 165.0, 376.0), (220.0, 228.0, 205.0), (79.0, 294.0, 143.0),
            (65.0, 320.0, 129.0), (57.0, 326.0, 141.0))


def _triangle(phase):
    t = phase % 1.0
    return f32(np.where(t < 0.5, 4.0 * t - 1.0, 3.0 - 4.0 * t))


def _bp_coeffs(freq, q, gain, sr):
    freq = np.clip(f64(freq), 20.0, sr * 0.5 * 0.95)
    q = np.clip(f64(q), 0.1, 100.0)
    omega = 2.0 * np.pi * freq / sr
    alpha = np.sin(omega) / (2.0 * q)
    a0 = 1.0 + alpha
    return (f32(q * alpha * gain / a0), F32(0.0), f32(-q * alpha * gain / a0),
            f32(-2.0 * np.cos(omega) / a0), f32((1.0 - alpha) / a0))


class Tom2(Family):
    PARAMS = ("tune", "bend", "tone", "color", "decay", "membrane", "membrane_q", "volume",
              "tuning")

    def init(self, preset, V: int) -> dict:
        z = lambda: np.zeros(V, F32)
        bq = lambda shape=(V,): {k: np.zeros(shape, F32) for k in ("x1", "x2", "y1", "y2")}
        return {"params": np.broadcast_to(f32(preset), (V, len(self.PARAMS))).copy(),
                "trig_sample": np.full(V, NEVER, np.int64), "decay_s": np.full(V, 2.0, F32),
                "tri_phase": np.zeros(V, F64),
                "morph": {"main": np.zeros(V, F64), "tri": np.zeros(V, F64),
                          "fixed": np.zeros(V, F64), "gated": np.zeros(V, F64),
                          "rand_seg": np.zeros(V, np.int64), "rand_frac": z()},
                "bandpass": bq(), "membrane": bq((V, 5)), "ring": z()}

    @staticmethod
    def _biquad(s, x, b, reset):
        b0, b1, b2, a1, a2 = b
        for k in ("x1", "x2", "y1", "y2"):
            s[k] = np.where(reset, F32(0.0), s[k])
        y = f32(b0 * x + b1 * s["x1"] + b2 * s["x2"] - a1 * s["y1"] - a2 * s["y2"])
        out = np.where(np.abs(y) < 1e-15, F32(0.0), y)
        s["x2"], s["x1"], s["y2"], s["y1"] = s["x1"], f32(x), s["y1"], y
        return out

    def tick(self, st, trig, vel_in, n, j):
        sr = self.sr
        p = st["params"]
        val = lambda name: f64(p[:, self.P[name]])
        reset = trig
        st["trig_sample"] = np.where(reset, n, st["trig_sample"])
        st["decay_s"] = np.where(reset, f32((0.5 + (val("decay") / 100.0) * (4000.0 - 0.5)) * 0.001),
                                 st["decay_s"]).astype(F32)
        elapsed_i = n - st["trig_sample"]
        elapsed = f64(f32(f32(elapsed_i) * F32(1.0 / sr)))
        attack_s, decay_s = 0.001, f64(st["decay_s"])
        prog = np.clip((elapsed - attack_s) / decay_s, 0.0, 1.0)
        env = np.where(elapsed < attack_s, max_curve(elapsed / attack_s, 0.8),
                       f32(1.0 - max_curve(prog, -0.83)))
        env = np.where(elapsed < 0.0, F32(0.0), env).astype(F32)
        env_complete = elapsed >= (attack_s + decay_s)
        base_freq = f32((40.0 + (val("tune") / 100.0) ** 2 * (600.0 - 40.0))
                        * tuning_mult(val("tuning")))
        bend = f32((val("bend") / 100.0) * 2.0)
        raw_freq = f32(base_freq * (1.0 + f64(f32(env * bend)) ** 2))
        past_attack = (elapsed >= attack_s) | (env > 0.9)
        main_done = env_complete | (past_attack & (raw_freq < 20.0))
        fade_factor = np.where(past_attack & (raw_freq < 40.0),
                               f32((f64(raw_freq) - 20.0) / (40.0 - 20.0)), F32(1.0)).astype(F32)
        mod_freq = f32(np.maximum(raw_freq, 40.0))
        imp = f32(TOM_IMPULSE)
        inside = (elapsed_i >= 0) & (elapsed_i < len(TOM_IMPULSE))
        click = np.where(inside, f32(imp[np.clip(elapsed_i, 0, len(imp) - 1)] * 1.1), F32(0.0))
        inc = f32(mod_freq / sr)
        st["tri_phase"] = (f64(inc) + np.where(reset, 0.0, st["tri_phase"])) % 1.0
        tri = f32(_triangle((st["tri_phase"] - f64(inc)) % 1.0) * 0.5)
        mix_control = f32((val("tone") / 100.0) * 2.0 - 1.0)
        color_midi = f32(30.0 + (val("color") / 100.0) * 20.0)
        m = st["morph"]
        for k in ("main", "tri", "gated"):
            m[k] = (f64(inc) + np.where(reset, 0.0, m[k])) % 1.0
        fixed_inc = float(F32(190.0 / sr))
        m["fixed"] = (fixed_inc + np.where(reset, 0.0, m["fixed"])) % 1.0
        used = lambda ph, i: f32((ph - f64(i)) % 1.0)
        main_sine = f32(np.sin(TWO_PI * f64(used(m["main"], inc))) * 0.5)
        m_tri = f32(_triangle(f64(used(m["tri"], inc))) * 0.5)
        fixed_sine = f32(np.sin(TWO_PI * f64(used(m["fixed"], fixed_inc))) * 0.5)
        gated = np.where(val("tone") < 99.0,
                         f32(np.sin(TWO_PI * f64(used(m["gated"], inc))) * 0.2), F32(0.0))
        w = f32(white(elapsed_i) * 0.2)
        mtof = lambda midi: f64(f32(440.0 * 2.0 ** ((f64(midi) - 69.0) / 12.0)))
        rr = mtof(mtof(color_midi))
        m["rand_seg"] = np.where(reset, 0, m["rand_seg"])
        m["rand_frac"] = np.where(reset, F32(0.0), m["rand_frac"])
        t = f32(m["rand_frac"] + f32(rr / sr))
        ft = np.floor(t)
        m["rand_seg"] = m["rand_seg"] + ft.astype(np.int64)
        m["rand_frac"] = f32(t - ft)
        seg = m["rand_seg"]
        tgt = np.where(seg >= 1, white(seg, RAND_SEED), F32(0.0))
        cur = np.where(seg >= 2, white(seg - 1, RAND_SEED), F32(0.0))
        rand_value = f32(cur + (tgt - cur) * m["rand_frac"])
        noise_combined = f32((w + rand_value) * 0.4)
        ch1 = f32(main_sine * fixed_sine)
        ch2 = f32(m_tri + noise_combined)
        ch3 = f32(noise_combined + gated)
        mc = f64(mix_control)
        morph_out = f32(ch1 * np.clip(-mc, 0.0, 1.0) + ch2 * np.clip(1.0 - np.abs(mc), 0.0, 1.0)
                        + ch3 * np.clip(mc, 0.0, 1.0))
        mixed = f32(click + tri + morph_out)
        color_n = val("color") / 100.0
        filtered = self._biquad(st["bandpass"], mixed,
                                _bp_coeffs(np.maximum(f64(mod_freq), 20.0), 1.0 + color_n ** 2,
                                           1.1, sr), reset)
        q_scale = f32(0.005 + (val("membrane_q") / 100.0) * 0.015)
        membrane_mix = f32(val("membrane") / 100.0)
        mem_in = np.where(main_done | (membrane_mix <= 0.0), F32(0.0), f32(filtered * env))
        mem = st["membrane"]
        for k in ("x1", "x2", "y1", "y2"):
            mem[k] = np.where(reset[:, None], F32(0.0), mem[k])
        total = np.zeros_like(mem_in)
        for i, (gain, freq, qm) in enumerate(MEMBRANE):
            b = _bp_coeffs(np.full_like(f64(mem_in), freq),
                           np.clip(qm * f64(q_scale), 0.1, 100.0), gain * 0.003, sr)
            s = {k: mem[k][:, i] for k in ("x1", "x2", "y1", "y2")}
            total = f32(total + self._biquad(s, mem_in, b, np.zeros_like(reset)))
            for k in s:
                mem[k][:, i] = s[k]
        mem_out = f32(np.tanh(total))
        prev_ring = np.where(reset, F32(0.0), st["ring"])
        st["ring"] = f32(0.999 * prev_ring + 0.001 * np.abs(mem_out))
        mem_out = np.where(membrane_mix <= 0.0, F32(0.0), mem_out)
        fade = f32(np.clip((f64(st["ring"]) - 0.0001) / (0.005 - 0.0001), 0.0, 1.0))
        vol = f32(val("volume") / 100.0)
        dry = f32(filtered * env)
        mixed_out = f32(dry * (1.0 - membrane_mix) + mem_out * membrane_mix)
        done_out = np.where(st["ring"] <= 0.0001, F32(0.0),
                            f32(mem_out * membrane_mix * fade * 0.7 * vol))
        out = np.where(main_done, done_out, f32(mixed_out * fade_factor * 0.7 * vol))
        return np.where(elapsed_i < 0, F32(0.0), out).astype(F32)


# --- bass ---------------------------------------------------------------------------

def _poly_blep(t, dt):
    dt = np.maximum(f64(dt), 1e-12)
    t = f64(t)
    e = t / dt
    l = (t - 1.0) / dt
    return f32(np.where(t < dt, 2.0 * e - e * e - 1.0,
                        np.where(t > 1.0 - dt, l * l + 2.0 * l + 1.0, 0.0)))


def _env_amp(elapsed, attack, decay, curve):
    """Sustain-0 power-curve envelope."""
    el = f64(elapsed)
    decay = f64(decay)
    c = np.clip(f64(curve), 0.1, 10.0)
    rise = np.clip(el / attack, 0.0, None)
    fall = 1.0 - np.clip((el - attack) / decay, 0.0, None) ** c
    out = np.where(el < attack, rise, np.where(el < attack + decay, fall, 0.0))
    return f32(np.where(el < 0.0, 0.0, out))


class Bass(Family):
    PARAMS = ("frequency", "sub_level", "osc_level", "detune_level", "detune_amount",
              "osc_shape", "filter_cutoff", "filter_resonance", "filter_env_amount",
              "filter_env_decay", "filter_env_curve", "amp_decay", "amp_decay_curve",
              "overdrive", "volume", "tuning")
    PHASES = ("sub", "osc", "det")

    def init(self, preset, V: int) -> dict:
        p = np.broadcast_to(f32(np.clip(preset, 0.0, 1.0)), (V, len(self.PARAMS))).copy()
        z = lambda: np.zeros(V, F32)
        freq0 = denorm(p[:, self.P["frequency"]], 30.0, 200.0)
        return {"params": {"current": p, "target": p.copy()},
                "trig_sample": np.full(V, NEVER, np.int64), "velocity": np.ones(V, F32),
                "freq0": freq0, "amp_decay": np.ones(V, F32), "amp_curve": np.ones(V, F32),
                "fenv_decay": np.full(V, 0.3, F32), "fenv_curve": np.ones(V, F32),
                "phase": {k: z() for k in self.PHASES},
                "svf": {"ic1": z(), "ic2": z()}, "ovs": ovs_init(V)}

    def render(self, state, off, vel, block_start):
        self._blk = {}
        return super().render(state, off, vel, block_start)

    def _phase(self, st, name, inc, reset, j):
        """The split-increment mod-1 phase of a block (the carry is the
        phase at the end of the last block); a strike restarts the phase."""
        b = self._blk.setdefault(name, {})
        if j == 0:
            b["inc0"] = inc
            b["hi"] = f32(np.floor(f32(inc * F32(2048.0))) * F32(1.0 / 2048.0))
            b["lo"] = f32(inc - b["hi"])
            b["resid"] = np.zeros_like(inc)
            b["base"] = f32(-st["phase"][name])
            b["p_prev"] = np.zeros_like(inc)
        b["resid"] = f32(b["resid"] + f32(inc - b["inc0"]))
        n1 = F32(j + 1)
        ramp_hi = f32(b["hi"] * n1)
        ramp_hi = f32(ramp_hi - np.floor(ramp_hi))
        ramp = f32(ramp_hi + f32(b["lo"] * n1))
        pp = f32(np.mod(f32(ramp + b["resid"]), F32(1.0)))
        b["base"] = np.where(reset, b["p_prev"], b["base"])
        b["p_prev"] = pp
        phase = f32(np.mod(f32(pp - b["base"]), F32(1.0)))
        if j == self.B - 1:
            st["phase"][name] = phase
        return phase

    def tick(self, st, trig, vel_in, n, j):
        sr, P = self.sr, self.P
        reset = trig
        cur = st["params"]["current"]
        sets = {"velocity": np.clip(vel_in, 0.0, 1.0),
                "freq0": denorm(cur[:, P["frequency"]], 30.0, 200.0),
                "amp_decay": denorm(cur[:, P["amp_decay"]], 0.05, 4.0),
                "amp_curve": denorm(cur[:, P["amp_decay_curve"]], 0.1, 10.0),
                "fenv_decay": denorm(cur[:, P["filter_env_decay"]], 0.01, 2.0),
                "fenv_curve": denorm(cur[:, P["filter_env_curve"]], 0.1, 8.0)}
        if reset.any():
            for k, v in sets.items():
                st[k] = np.where(reset, v, st[k]).astype(F32)
            st["trig_sample"] = np.where(reset, n, st["trig_sample"])
        q = float(F32(1.0 - smoothing_coeff(sr)))
        p = smoother_tick_decay(st["params"], q)
        val = lambda name: p[:, P[name]]
        elapsed = (n - st["trig_sample"]) / sr
        freq = f32(st["freq0"] * tuning_mult(val("tuning")))
        det_freq = f32(freq * 2.0 ** (f64(denorm(val("detune_amount"), 0.0, 30.0)) / 1200.0))
        sub_inc = f32(freq / sr)
        det_inc = f32(det_freq / sr)
        sub_ph = self._phase(st, "sub", sub_inc, reset, j)
        osc_ph = self._phase(st, "osc", sub_inc, reset, j)
        det_ph = self._phase(st, "det", det_inc, reset, j)
        sub_out = f32(np.sin(f64(sub_ph) * TWO_PI))
        shape = val("osc_shape")

        def blep_pair(phase, inc):
            saw = f32((2.0 * f64(phase) - 1.0) - _poly_blep(phase, inc))
            sq = f32(np.where(phase < 0.5, 1.0, -1.0) + _poly_blep(phase, inc)
                     - _poly_blep((f64(phase) + 0.5) % 1.0, inc))
            return saw, sq

        saw_m, sq_m = blep_pair(osc_ph, sub_inc)
        saw_d, sq_d = blep_pair(det_ph, det_inc)
        osc_out = f32(saw_m * (1.0 - shape) + sq_m * shape)
        det_out = f32(saw_d * (1.0 - shape) + sq_d * shape)
        mix = f32(sub_out * val("sub_level") + osc_out * val("osc_level")
                  + det_out * val("detune_level"))
        od = val("overdrive")
        drive = f32(1.0 + f64(od) * 9.0)
        d_eff = f32(np.maximum(f64(drive), 1.0 + 1e-6))
        comp = f32(np.tanh(0.5) / np.tanh(0.5 * f64(d_eff)))
        shaped = ovs_process(st["ovs"], mix, lambda x: np.tanh(x * d_eff) * comp)
        saturated = np.where((od > 0.001) & (drive > 1.0), shaped, mix)
        fenv = _env_amp(elapsed, 0.001, st["fenv_decay"], st["fenv_curve"])
        lo, hi = 20.0, 18000.0
        base_cut = f32(lo * (hi / lo) ** np.clip(f64(val("filter_cutoff")), 0.0, 1.0))
        cutoff = np.clip(f64(base_cut) + (hi - f64(base_cut)) * f64(val("filter_env_amount"))
                         * f64(fenv), lo, hi)
        cutoff = np.clip(cutoff, 20.0, sr * 0.45)
        g = f32(np.tan(np.pi * cutoff / sr))
        r = f32(1.0 / np.maximum(f64(denorm(val("filter_resonance"), 0.5, 15.0)), 0.5))
        hcoef = f32(1.0 / (1.0 + f64(r) * g + f64(g) * g))
        svf = st["svf"]
        for k in ("ic1", "ic2"):
            svf[k] = np.where(reset, F32(0.0), svf[k])
        v1 = f32((g * (saturated - svf["ic2"]) + svf["ic1"]) * hcoef)
        v2 = f32(svf["ic2"] + g * v1)
        svf["ic1"] = f32(2.0 * v1 - svf["ic1"])
        svf["ic2"] = f32(2.0 * v2 - svf["ic2"])
        amp = _env_amp(elapsed, 0.002, st["amp_decay"], st["amp_curve"])
        return f32(v2 * amp * np.sqrt(f64(st["velocity"])) * val("volume"))


FAMILIES = {"kick": Kick, "snare": Snare, "hihat2": HiHat2, "tom2": Tom2, "bass": Bass}
