"""The bus's and the chain's effects and the soft limiter, in plain NumPy,
sample by sample over a stereo block.

Each effect is the per-sample oracle of upstream's effect (delay.rs,
reverb.rs, plate_reverb.rs, compressor.rs, saturation.rs, lowpass_filter.rs,
tilt_filter.rs, waveshaper.rs, feedback_waveshaper.rs, as this repository's
numpy oracles in ``tests/test_effects*.py`` and ``tests/test_plate.py`` state
them) at settled parameters: the configurations start every effect at its
targets, so its smoothers never move.  An effect built with parameters it
does not hold here (a tilt off its centre, a waveshaper that drives)
raises.  Nothing of the program is imported.

``make(name, params, sample_rate)`` gives an object whose
``process(x [2, B]) -> y [2, B]`` carries its state from block to block.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference.voices import F32, F64, f32, f64, ovs_init, ovs_process


class Saturation:
    """Asymmetric atan saturation at 4x, DC-blocked, dry/wet."""

    def __init__(self, params, sr):
        drive, warmth, self.mix = (float(v) for v in params)
        self.drive, self.bias = 1.0 + drive * 7.0, warmth * 0.4
        self.ovs = ovs_init(2)
        self.dc_x1 = np.zeros(2, F32)
        self.dc_y1 = np.zeros(2, F32)

    def _fn(self, v):
        driven = f32(v * self.drive)
        biased = f32(driven + self.bias * np.abs(driven))
        soft = f32(np.arctan(biased) * F32(2.0 / np.pi))
        return f32(soft + soft * soft * np.sign(soft) * 0.15 * self.bias)

    def process(self, x):
        y = np.empty_like(x)
        for n in range(x.shape[1]):
            xn = f32(x[:, n])
            sat = ovs_process(self.ovs, xn, self._fn)
            prev = self.dc_x1
            self.dc_x1 = f32(sat)
            self.dc_y1 = f32(0.995 * self.dc_y1 + (sat - prev))
            y[:, n] = xn if self.mix < 1e-4 else xn * (1.0 - self.mix) + self.dc_y1 * self.mix
        return y


class Lowpass:
    """Two one-poles with a tanh-limited resonance feedback, tanh out."""

    def __init__(self, params, sr):
        cutoff, res = (float(v) for v in params)
        cutoff = min(max(cutoff, 20.0), 20000.0)
        self.g = min(max(1.0 - math.exp(-2.0 * math.pi * cutoff / sr), 0.0), 0.9)
        fr = min(cutoff / 5000.0, 1.0)
        self.fb = min(max(res, 0.0), 0.95) * (1.0 - fr * fr * 0.7) * 3.5
        self.s1 = np.zeros(2, F64)
        self.s2 = np.zeros(2, F64)

    def process(self, x):
        y = np.empty_like(x)
        g, fb = self.g, self.fb
        for n in range(x.shape[1]):
            infb = f64(x[:, n]) - np.tanh(self.s2 * fb) * min(fb, 1.0)
            self.s1 = self.s1 + g * (infb - self.s1)
            self.s2 = self.s2 + g * (self.s1 - self.s2)
            y[:, n] = np.tanh(self.s2)
        return y


class Delay:
    """A fractional delay line with a two-pole darkening filter in its
    feedback, dry/wet."""

    MAX_S = 5.0

    def __init__(self, params, sr):
        time_s, self.feedback, self.mix, cutoff = (float(v) for v in params)
        self.L = int(sr * self.MAX_S) + 1
        self.buf = np.zeros((2, self.L), F32)
        self.w = 0
        ds = time_s * sr
        self.di = int(ds)
        self.frac = ds - self.di
        self.g = 1.0 - math.exp(-2.0 * math.pi * cutoff / sr)
        self.z1 = np.zeros(2, F64)
        self.z2 = np.zeros(2, F64)

    def process(self, x):
        y = np.empty_like(x)
        L, di, frac, g = self.L, self.di, self.frac, self.g
        for n in range(x.shape[1]):
            xn = f64(x[:, n])
            i1, i2 = (self.w + L - di) % L, (self.w + L - di - 1) % L
            delayed = f64(self.buf[:, i1]) * (1 - frac) + f64(self.buf[:, i2]) * frac
            rfb = 0.3 * (self.z1 - self.z2)
            self.z1 = self.z1 + g * (delayed + rfb - self.z1)
            self.z2 = self.z2 + g * (self.z1 - self.z2)
            ws = xn + self.z2 * self.feedback
            self.buf[:, self.w] = np.where(np.abs(ws) > 1e-15, ws, 0.0)
            self.w = (self.w + 1) % L
            y[:, n] = xn * (1 - self.mix) + self.z2 * self.mix
        return y


class Compressor:
    """Peak envelope, soft 6 dB knee, smoothed gain, tube colour through
    the 4x oversampler (fed always, used while it reduces), DC blocker,
    dry/wet."""

    def __init__(self, params, sr):
        self.thr, self.ratio, att_ms, rel_ms, self.mix = (float(v) for v in params)
        self.att = math.exp(-1.0 / (att_ms * 0.001 * sr))
        self.rel = math.exp(-1.0 / (rel_ms * 0.001 * sr))
        self.env = np.zeros(2, F64)
        self.gain = np.ones(2, F64)
        self.dcx = np.zeros(2, F64)
        self.dcy = np.zeros(2, F64)
        self.ovs = ovs_init(2)

    def process(self, x):
        y = np.empty_like(x)
        slope = 1.0 - 1.0 / self.ratio
        for n in range(x.shape[1]):
            xn = f64(x[:, n])
            r = np.abs(xn)
            c = np.where(r > self.env, self.att, self.rel)
            self.env = c * self.env + (1 - c) * r
            over = 20.0 * np.log10(self.env + 1e-20) - self.thr
            gr = np.where(over <= -3.0, 0.0, np.where(over >= 3.0, over * slope,
                                                       (over + 3.0) ** 2 / 12.0 * slope))
            self.gain = self.gain + 0.05 * (10.0 ** (-gr * 0.05) - self.gain)
            comp = xn * self.gain
            colored_os = ovs_process(self.ovs, f32(comp),
                                     lambda v: np.arctan(v) * (2 / np.pi) * 1.1)
            colored = np.where(self.gain < 0.99, f64(colored_os), comp)
            out = colored - self.dcx + 0.995 * self.dcy
            self.dcx, self.dcy = colored, out
            y[:, n] = xn if self.mix < 1e-4 else xn * (1.0 - self.mix) + out * self.mix
        return y


class Spring:
    """Six allpasses a channel (their own lengths left and right) in a
    damped feedback loop, dry/wet."""

    DELAYS = ((131, 251, 389, 521, 617, 787), (127, 263, 397, 541, 631, 797))
    GAINS = (0.70, 0.68, 0.65, 0.62, 0.60, 0.58)

    def __init__(self, params, sr):
        decay, self.mix, self.damping = (float(v) for v in params)
        scale = sr / 44100.0
        self.delays = [[max(int(d * scale), 1) for d in ch] for ch in self.DELAYS]
        self.feedback = decay ** 0.4 * 0.95
        self.bufs = [[np.zeros(d, F32) for d in ch] for ch in self.delays]
        self.idx = [[0] * 6, [0] * 6]
        self.fb = [0.0, 0.0]
        self.damp = [0.0, 0.0]

    def process(self, x):
        y = np.empty_like(x)
        mix, damping = self.mix, self.damping
        for ch in range(2):
            bufs, idxs, delays = self.bufs[ch], self.idx[ch], self.delays[ch]
            fb, damp = self.fb[ch], self.damp[ch]
            for n in range(x.shape[1]):
                xn = float(x[ch, n])
                signal = xn + fb
                for i in range(6):
                    g = self.GAINS[i]
                    delayed = float(bufs[i][idxs[i]])
                    v = signal - g * delayed
                    signal = g * v + delayed
                    bufs[i][idxs[i]] = v
                    idxs[i] = (idxs[i] + 1) % delays[i]
                damp = signal * (1 - damping) + damp * damping
                fb = damp * self.feedback
                y[ch, n] = xn * (1 - mix) + signal * mix
            self.fb[ch], self.damp[ch] = fb, damp
        return y


class _Line:
    def __init__(self, capacity):
        self.buf = np.zeros(max(capacity, 4), F32)
        self.idx = 0

    def write(self, x):
        self.buf[self.idx] = x
        self.idx = (self.idx + 1) % len(self.buf)

    def read_frac(self, offset):
        ln = len(self.buf)
        offset = min(max(offset, 1.0), ln - 2)
        whole = int(offset)
        frac = offset - whole
        a = float(self.buf[(self.idx + ln - whole) % ln])
        b = float(self.buf[(self.idx + ln - whole - 1) % ln])
        return a + frac * (b - a)

    def tap_frac(self, offset):
        ln = len(self.buf)
        offset = min(max(offset, 0.0), ln - 2)
        whole = int(offset)
        frac = offset - whole
        a = float(self.buf[(self.idx + ln - 1 - whole) % ln])
        b = float(self.buf[(self.idx + ln - 2 - whole) % ln])
        return a + frac * (b - a)

    def allpass(self, x, gain, delay):
        d = self.read_frac(delay)
        v = x - gain * d
        self.write(v)
        return gain * v + d


class Plate:
    """Dattorro's plate: predelay, input bandwidth, four input allpasses,
    the two-sided tank with modulated allpasses, damping and decay, seven
    output taps a side, mid/side width, dry/wet (plate_reverb.rs)."""

    DATTORRO_SR = 29761.0
    EXCURSION = 16.0
    BANDWIDTH = 0.9995
    INPUT_AP = ((142.0, 0.750), (107.0, 0.750), (379.0, 0.625), (277.0, 0.625))
    LFO_A, LFO_B = 0.5, 0.71

    def __init__(self, params, sr):
        decay, self.mix, damping, predelay, self.width, size = (float(v) for v in params)
        self.sr = sr
        srs = sr / self.DATTORRO_SR
        self.srs = srs
        self.exc = self.EXCURSION * srs
        self.sz = 4.0 ** (2 * size - 1) if size <= 0.5 else 2.0 ** (2 * size - 1)
        fixed = lambda b: _Line(int(np.ceil(b * srs)) + 4)
        sized = lambda b, h: _Line(int(np.ceil(b * 2.0 * srs + h)) + 4)
        self.pre = _Line(int(np.ceil(0.2 * sr)) + 8)
        self.predelay = predelay * 0.2 * sr
        self.iaps = [fixed(d) for d, _ in self.INPUT_AP]
        self.map_a, self.d1a = sized(672, self.exc), sized(4453, 0)
        self.ap2a, self.d2a = sized(1800, 0), sized(3720, 0)
        self.map_b, self.d1b = sized(908, self.exc), sized(4217, 0)
        self.ap2b, self.d2b = sized(2656, 0), sized(3163, 0)
        self.bw = self.da = self.db = self.fba = self.fbb = 0.0
        self.pa = self.pb = 0.0
        self.decay_g = decay * 0.95
        self.dd2 = min(max(self.decay_g + 0.15, 0.25), 0.5)
        self.damp = damping * 0.95

    def process(self, x):
        y = np.empty_like(x)
        srs, sz, exc, sr, damp, dg = self.srs, self.sz, self.exc, self.sr, self.damp, self.decay_g
        ts = srs * sz
        for n in range(x.shape[1]):
            xl, xr = float(x[0, n]), float(x[1, n])
            self.pre.write(0.5 * (xl + xr))
            din = self.pre.tap_frac(self.predelay)
            self.bw += self.BANDWIDTH * (din - self.bw)
            sig = self.bw
            for ap, (d, g) in zip(self.iaps, self.INPUT_AP):
                sig = ap.allpass(sig, g, max(d * srs, 1.0))
            self.pa = (self.pa + self.LFO_A / sr) % 1.0
            self.pb = (self.pb + self.LFO_B / sr) % 1.0
            lfa, lfb = math.sin(2 * math.pi * self.pa), math.sin(2 * math.pi * self.pb)
            in_a, in_b = sig + self.fbb, sig + self.fba
            a1 = self.map_a.allpass(in_a, 0.70, 672 * srs * sz + lfa * exc)
            ra = self.d1a.read_frac(4453 * srs * sz)
            self.d1a.write(a1)
            self.da = ra * (1 - damp) + self.da * damp
            a2 = self.ap2a.allpass(self.da * dg, self.dd2, 1800 * srs * sz)
            rda = self.d2a.read_frac(3720 * srs * sz)
            self.d2a.write(a2)
            b1 = self.map_b.allpass(in_b, 0.70, 908 * srs * sz + lfb * exc)
            rb = self.d1b.read_frac(4217 * srs * sz)
            self.d1b.write(b1)
            self.db = rb * (1 - damp) + self.db * damp
            b2 = self.ap2b.allpass(self.db * dg, self.dd2, 2656 * srs * sz)
            rdb = self.d2b.read_frac(3163 * srs * sz)
            self.d2b.write(b2)
            self.fba, self.fbb = rda * dg, rdb * dg
            yl = 0.6 * (self.d1b.tap_frac(266 * ts) + self.d1b.tap_frac(2974 * ts)
                        - self.ap2b.tap_frac(1913 * ts) + self.d2b.tap_frac(1996 * ts)
                        - self.d1a.tap_frac(1990 * ts) - self.ap2a.tap_frac(187 * ts)
                        - self.d2a.tap_frac(1066 * ts))
            yr = 0.6 * (self.d1a.tap_frac(353 * ts) + self.d1a.tap_frac(3627 * ts)
                        - self.ap2a.tap_frac(1228 * ts) + self.d2a.tap_frac(2673 * ts)
                        - self.d1b.tap_frac(2111 * ts) - self.ap2b.tap_frac(335 * ts)
                        - self.d2b.tap_frac(121 * ts))
            mid, side = 0.5 * (yl + yr), 0.5 * (yl - yr) * self.width
            y[0, n] = xl * (1.0 - self.mix) + (mid + side) * self.mix
            y[1, n] = xr * (1.0 - self.mix) + (mid - side) * self.mix
        return y


class Passthrough:
    """An effect whose parameters leave the signal as it is: a tilt at its
    centre (mix ``|2k - 1| < 0.001``), a waveshaper or a feedback
    waveshaper at drive 1 or mix 0."""

    def __init__(self, name, params, sr):
        p = [float(v) for v in params]
        neutral = {"tilt": lambda: abs(2.0 * p[0] - 1.0) < 0.001,
                   "waveshaper": lambda: p[0] <= 1.0 or p[-1] < 1e-4,
                   "feedback_waveshaper": lambda: p[0] <= 1.0 or p[-1] < 1e-4}[name]
        if not neutral():
            raise NotImplementedError(f"the reference holds {name} only where it passes the "
                                      f"signal through; parameters {p}")

    def process(self, x):
        return x


EFFECTS = {"saturation": Saturation, "lowpass": Lowpass, "delay": Delay,
           "compressor": Compressor, "spring": Spring, "plate": Plate}


def make(name: str, params, sample_rate: float):
    if name in EFFECTS:
        return EFFECTS[name](params, sample_rate)
    return Passthrough(name, params, sample_rate)


def soft_limit(x, threshold: float):
    """``tanh(x / t) * t``, the threshold clamped to [0.001, 1]."""
    t = min(max(float(threshold), 0.001), 1.0)
    return np.tanh(f64(x) / t) * t
