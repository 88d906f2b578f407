"""The benchmark's plain reference: a configuration's blocks in NumPy,
written apart from the program and importing nothing of it.

* the banks: ``reference/voices.py``, every voice of every family in the
  configuration's order, each at the preset and flags its configuration
  file states;
* the mix: each voice times its gain, panned by equal power
  (``cos``/``sin`` of ``pan * pi/2``), summed left, right and mono, the pan
  and gain smoothers ticked per sample;
* the master gain (a smoother) on the stereo and on the mono sum; the mono
  sum through the soft limiter (the mono the program returns beside its
  stereo);
* the stereo through the configuration's bus in its order, the soft
  limiter, then the configuration's chain in its order
  (``reference/effects.py``, each effect at the targets the configuration
  states).

``Reference(cfg).init_state()`` gives the state by meaning: one dict per
family (``reference/voices.py``) and the ``pan``, ``gain`` and ``master``
smoothers.  The bus and the chain are objects that carry their own state
(``Reference.bus()``), since the checks follow them only from the start.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import effects
from portbench.reference.voices import F32, F64, FAMILIES, SETTLE, f32, f64, smoothing_coeff

FLAGS = {"snare": ("filter_type",), "hihat2": ("filter_slope", "noise_color")}


class Bus:
    """The stereo path after the master gain: the bus, the limiter, the
    chain; state carried from block to block."""

    def __init__(self, cfg):
        sr = float(cfg["sample_rate"])
        bus = cfg.get("bus") or {}
        self.bus = [effects.make(n, bus["targets"][n], sr) for n in bus.get("order", [])]
        chain = cfg.get("chain") or {}
        self.chain = [effects.make(n, chain["targets"][n], sr) for n in chain.get("order", [])]
        self.threshold = float(cfg["limiter_threshold"])

    def process(self, x):
        for fx in self.bus:
            x = fx.process(x)
        x = effects.soft_limit(x, self.threshold)
        for fx in self.chain:
            x = fx.process(x)
        return x


def _smooth(sm, q, B):
    """A smoother's per-sample trajectory over a block (``cur = tgt + (cur
    - tgt) * q``, snapped at 1e-4) and the smoother after it."""
    cur, tgt = f64(sm["current"]), f64(sm["target"])
    traj = np.empty(cur.shape + (B,), F64)
    for j in range(B):
        delta = (cur - tgt) * q
        cur = tgt + np.where(np.abs(delta) < SETTLE, 0.0, delta)
        traj[..., j] = cur
    return {"current": f32(cur), "target": f32(tgt)}, traj


class Reference:
    def __init__(self, cfg):
        self.cfg = cfg
        self.sr, self.B = float(cfg["sample_rate"]), int(cfg["block_size"])
        static = cfg.get("family_static", {})
        self.families = {k: FAMILIES[k](self.sr, self.B, **static.get(k, {}))
                         for k in cfg["voices"]}
        self.q = 1.0 - smoothing_coeff(self.sr)

    def init_state(self) -> dict:
        cfg = self.cfg
        state = {}
        for kind, V in cfg["voices"].items():
            preset = cfg["presets"][kind]
            flags = {f: int(preset[f]) for f in FLAGS.get(kind, ()) if f in preset}
            state[kind] = self.families[kind].init(np.asarray(preset["params"], F32), V, **flags)
        mix, nv = cfg["mix"], sum(cfg["voices"].values())
        pan = (np.linspace(mix["pan"][0], mix["pan"][1], nv) if isinstance(mix["pan"], list)
               else np.full(nv, mix["pan"]))
        gain = np.full(nv, 1.0 / nv) if mix["gain"] == "1/V" else np.full(nv, float(mix["gain"]))
        for name, v in (("pan", pan), ("gain", gain), ("master", np.float32(mix["master"]))):
            state[name] = {"current": f32(v), "target": f32(v)}
        return state

    def bus(self) -> Bus:
        return Bus(self.cfg)

    def render_block(self, state: dict, events: dict, bus: Bus = None):
        """One block from ``state`` -> ``(new_state, stereo [2, B] or None,
        mono [B])``; the stereo only where ``bus`` is given."""
        new = dict(state)
        start = int(np.asarray(events["block_start"]))
        outs = []
        for kind, fam in self.families.items():
            new[kind], y = fam.render(state[kind], events[kind + "_off"], events[kind + "_vel"],
                                      start)
            outs.append(f64(y))
        voices = np.concatenate(outs, axis=0)
        new["pan"], pan = _smooth(state["pan"], self.q, self.B)
        new["gain"], gain = _smooth(state["gain"], self.q, self.B)
        new["master"], master = _smooth(state["master"], self.q, self.B)
        ang = np.clip(pan, 0.0, 1.0) * (np.pi / 2.0)
        shaped = voices * gain
        left = (shaped * np.cos(ang)).sum(axis=0)
        right = (shaped * np.sin(ang)).sum(axis=0)
        mono = effects.soft_limit(shaped.sum(axis=0) * master, self.cfg["limiter_threshold"])
        stereo = None
        if bus is not None:
            stereo = bus.process(np.stack([left, right]) * master[None, :])
        return new, stereo, mono
