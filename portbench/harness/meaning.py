"""The program's state read by meaning into the reference's terms, and two
such states compared.

``read(state)`` takes a state of the port (a dict of its banks' and
mixer's NamedTuples) and returns the reference's dict
(``reference/voices.py``, ``reference/render.py``): each quantity the
reference names, taken from the program's field that holds it, on the host.
What the program keeps beside those for its own arithmetic (the
oversampler's second-to-last samples, the kernels' packed copies) is not
read.  The bus's and the chain's states are not read: the checks follow
them from the start only.

``gap(prog, ref)`` compares two such dicts leaf by leaf: an integer or
boolean leaf exactly (any difference is infinite), a phase in cycles by
its distance around the circle, any other float as ``|p - r| / max(1,
|r|)``; a family's field only on the voices where it means something
(``meaningful``: not before a voice is first struck, not a bypassed
shaper's history, not an unused noise filter).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.voices import FAMILIES

#: leaves that hold a phase in cycles
CYCLIC = {"hihat2": ("mod_phase", "main_phase"),
          "tom2": ("tri_phase", "morph.main", "morph.tri", "morph.fixed", "morph.gated"),
          "bass": ("phase.sub", "phase.osc", "phase.det")}


def _h(t):
    return t.detach().to("cpu").numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _f(t):
    return _h(t).astype(np.float32)


def _smoother(sb):
    return {"current": _f(sb.current), "target": _f(sb.target)}


def _ovs(o):
    return {name: {"x": np.stack([_f(h.ap0x), _f(h.ap1x)], axis=-2),
                   "y": np.stack([_f(h.ap0), _f(h.ap1)], axis=-2), "x1": _f(h.x1)}
            for name, h in (("up1", o.up1), ("up2", o.up2), ("down2", o.down2),
                            ("down1", o.down1))}


def _biquad(b):
    return {k: _f(getattr(b, k)) for k in ("x1", "x2", "y1", "y2")}


def _kick(s):
    sh = s.shaper
    return {"params": _smoother(s.params), "trig_sample": _h(s.trig_sample).astype(np.int64),
            "velocity": _f(s.velocity), "pitch_mult": _f(s.pitch_mult),
            "pitch_curve": _f(s.pitch_curve), "amp_decay": _f(s.amp_decay),
            "amp_curve": _f(s.amp_curve), "pm_active": _h(s.pm_active) > 0.5,
            "click": _f(s.click_hp.y), "svf": {"ic1": _f(s.noise_svf.ic1),
                                               "ic2": _f(s.noise_svf.ic2)},
            "pink": _f(s.pink.fstate),
            "shaper": {"last": _f(sh.last_out), "filt": _f(sh.filter_state), "dcx": _f(sh.dc_x1),
                       "dcy": _f(sh.dc_y1), "env": _f(sh.env), "ovs": _ovs(sh.ovs)}}


def _snare(s):
    return {"params": _smoother(s.params), "filter_type": _h(s.filter_type).astype(np.int64),
            "trig_sample": _h(s.trig_sample).astype(np.int64), "velocity": _f(s.velocity),
            "pitch_mult": _f(s.pitch_mult), "amp_curve": _f(s.amp_curve),
            "tonal_curve": _f(s.tonal_curve), "amp_decay": _f(s.amp_decay),
            "pm_active": _h(s.pm_active) > 0.5,
            "noise_svf": {"low": _f(s.noise_svf.low), "band": _f(s.noise_svf.band)},
            "ovs": _ovs(s.ovs)}


def _hihat2(s):
    return {"params": _smoother(s.params), "noise_color": _h(s.noise_color).astype(np.int64),
            "filter_slope": _h(s.filter_slope).astype(np.int64),
            "trig_sample": _h(s.trig_sample).astype(np.int64), "velocity": _f(s.velocity),
            "mod_phase": _h(s.mod_phase).astype(np.float64),
            "main_phase": _h(s.main_phase).astype(np.float64), "env": _f(s.env_smooth),
            "hp1": _biquad(s.hpf1), "hp2": _biquad(s.hpf2),
            "svf": {"ic1": _f(s.svf.ic1), "ic2": _f(s.svf.ic2)}, "pink": _f(s.pink.fstate),
            "voice_salt": _h(s.voice_salt).astype(np.int64)}


def _tom2(s):
    m = s.morph
    return {"params": _f(s.params), "trig_sample": _h(s.trig_sample).astype(np.int64),
            "decay_s": _f(s.decay_s), "tri_phase": _h(s.tri_phase).astype(np.float64),
            "morph": {"main": _h(m.main_phase).astype(np.float64),
                      "tri": _h(m.tri_phase).astype(np.float64),
                      "fixed": _h(m.fixed_phase).astype(np.float64),
                      "gated": _h(m.gated_phase).astype(np.float64),
                      "rand_seg": _h(m.rand_seg).astype(np.int64), "rand_frac": _f(m.rand_frac)},
            "bandpass": _biquad(s.bandpass), "membrane": _biquad(s.membrane.biquads),
            "ring": _f(s.membrane.ring_level)}


def _bass(s):
    return {"params": _smoother(s.params), "trig_sample": _h(s.trig_sample).astype(np.int64),
            "velocity": _f(s.velocity), "freq0": _f(s.trig_freq), "amp_decay": _f(s.amp_decay_s),
            "amp_curve": _f(s.amp_curve), "fenv_decay": _f(s.fenv_decay_s),
            "fenv_curve": _f(s.fenv_curve),
            "phase": {"sub": _f(s.sub_phase), "osc": _f(s.osc_phase), "det": _f(s.det_phase)},
            "svf": {"ic1": _f(s.svf.ic1), "ic2": _f(s.svf.ic2)}, "ovs": _ovs(s.ovs)}


READERS = {"kick": _kick, "snare": _snare, "hihat2": _hihat2, "tom2": _tom2, "bass": _bass}


def read(state: dict, kinds) -> dict:
    """The program's ``state`` in the reference's terms (a state that is
    already the reference's, as the control's is, passes through)."""
    out = {}
    for kind in kinds:
        s = state[kind]
        out[kind] = s if isinstance(s, dict) else READERS[kind](s)
    for name in ("pan", "gain", "master"):
        s = state[name]
        out[name] = s if isinstance(s, dict) else _smoother(s)
    return out


def _leaf_gap(p, r, cyclic: bool, rows) -> float:
    p, r = np.asarray(p), np.asarray(r)
    if p.shape != r.shape:
        return math.inf
    if rows is not None and r.ndim >= 1 and r.shape[0] == rows.shape[0]:
        p, r = p[rows], r[rows]
    if not r.size:
        return 0.0
    if r.dtype.kind in "biu":
        return 0.0 if np.array_equal(p, r) else math.inf
    p, r = np.atleast_1d(p).astype(np.float64), np.atleast_1d(r).astype(np.float64)
    d = np.abs(p - r)
    if cyclic:
        d = np.minimum(d % 1.0, 1.0 - d % 1.0)
    else:
        d = d / np.maximum(np.abs(r), 1.0)
    d[np.isnan(p) & np.isnan(r)] = 0.0
    d[np.isnan(d)] = math.inf
    return float(d.max())


def gap(prog: dict, ref: dict) -> tuple:
    """``(worst leaf gap, its path)`` of two states in the reference's terms."""
    worst = [0.0, "none"]

    def note(g, path):
        if g > worst[0] or math.isnan(g):
            worst[:] = [g, path]

    def walk(p, r, path, cyclic, rows):
        if isinstance(r, dict):
            if not isinstance(p, dict) or set(p) != set(r):
                note(math.inf, path)
                return
            for k in r:
                walk(p[k], r[k], f"{path}.{k}", cyclic, rows)
            return
        note(_leaf_gap(p, r, path in cyclic, rows), path)

    for kind, r in ref.items():
        p = prog.get(kind)
        if kind not in FAMILIES:
            walk(p, r, kind, (), None)
            continue
        if not isinstance(p, dict) or set(p) != set(r):
            note(math.inf, kind)
            continue
        rows = FAMILIES[kind].meaningful(r)
        cyclic = {f"{kind}.{c}" for c in CYCLIC.get(kind, ())}
        for k in r:
            walk(p[k], r[k], f"{kind}.{k}", cyclic, rows.get(k))
    return worst[0], worst[1]
