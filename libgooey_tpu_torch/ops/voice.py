"""The kit path: small voice banks through the two kit kernels a block
(port of the host glue of libgooey_tpu/ops/pallas_voice.py).

At product voice counts (a 4- to 16-voice strip a family) the stage path of
a bank is launch-bound: every family's block is a few hundred small kernels.
Here every eligible family's block is two launches of
:mod:`ops.voice_kernels`, shared by all families of the kit
(``kit_render_fused``, pallas_voice.py:1892):

    kit_sources:  kick A, snare A, hihat2, bass, tom2 sources -> per family
    middles:      kick: env_follow_bank + gain_compensation; snare: the
                  Chamberlin (linrec2_bank); bass: the swept SVF (svf_bank);
                  tom2: the bandpass and membrane (tom2.finish_fused)
    kit_drive:    kick B, snare B (the 4x drives)

The middles run the port's bank kernels, as the JAX package runs its bank
kernels between its two merged calls.  The per-family wrappers
(``kick_render_fused`` ...) run the same kernels with one phase.

``IMPL`` has the JAX meaning: ``"auto"`` takes the kit kernels for an
eligible bank on a CUDA tensor and the stage path on a CPU tensor (the JAX
package takes its fused path on the TPU only); ``"pallas"`` forces the kit
path (on the CPU: the kernels' plain versions); ``"xla"`` takes the stage
path.  The row padding of the TPU (``Vp``, a sublane artefact) and its
``[2Vp, K]`` oversampler packing are not ported: the drive kernels take the
port's ``pack_fbws_bank`` layout.
"""

from __future__ import annotations

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank
from libgooey_tpu_torch.effects import feedback_waveshaper as fbws
from libgooey_tpu_torch.effects import freeze as frz
from libgooey_tpu_torch.ops import bank_kernels, filters, morph, voice_kernels
from libgooey_tpu_torch.ops.voice_kernels import BLAT, KFST, KLAT, KP, SLAT, SP, VoicePhase

#: "auto", "pallas" or "xla" (see the module docstring)
IMPL = "auto"

#: largest bank the kit kernels take (pallas_voice.MAX_FUSED_VOICES)
MAX_FUSED_VOICES = 128

_I32 = torch.int32
_F32 = torch.float32


def use_kit(t: torch.Tensor) -> bool:
    """Whether the kit path is on for a bank whose tensors lie where ``t``
    lies (the JAX gate's ``IMPL != "xla" and (on TPU or IMPL == "pallas")``)."""
    if IMPL == "xla":
        return False
    return IMPL == "pallas" or t.device.type == "cuda"


def eligible(trig_offset, num_voices: int) -> bool:
    """The shape half of every family's gate: ``[V]`` offsets (one trigger
    slot) and V <= MAX_FUSED_VOICES."""
    return np.ndim(trig_offset) == 1 and num_voices <= MAX_FUSED_VOICES


class _Block:
    """One block's shared inputs on the bank's device."""

    def __init__(self, dev, block_start, B, sr, coeff):
        self.B, self.sr = B, float(sr)
        q = np.float32(1.0 - coeff)
        self.powq = voice_kernels.powq_table(float(q), B, dev)
        self.qB = float(q ** np.float32(B))
        self.bs = torch.as_tensor(block_start, device=dev).to(_I32).reshape(())
        self.dev = dev

    def ints(self, v):
        return torch.as_tensor(v, device=self.dev).to(_I32).contiguous()

    def floats(self, v):
        return torch.as_tensor(v, device=self.dev).to(_F32).contiguous()

    def traj(self, cur, tgt, i):
        """The XLA-twin trajectory of param ``i``, ``[V, B]``."""
        d = (cur[:, i, None] - tgt[:, i, None]) * self.powq[1:][None, :]
        return tgt[:, i, None] + torch.where(d.abs() < 1e-4, 0.0, d)

    def at_trig(self, off):
        n = torch.arange(self.B, dtype=_I32, device=self.dev)[None, :]
        return (n == off[:, None]) & (off[:, None] < self.B)


def _cols(*vs):
    return torch.stack(vs, dim=1).contiguous()


# --- per-family phases: sources, middle, drive, finish ---------------------------


def _kick_phase_a(st, off, vel, blk, max_harmonics):
    ins = (st.params.current.contiguous(), st.params.target.contiguous(), off, vel,
           st.trig_sample.contiguous(),
           _cols(st.velocity, st.pitch_mult, st.pitch_curve, st.amp_decay, st.amp_curve,
                 st.pm_active),
           torch.cat([_cols(st.click_hp.y, st.noise_svf.ic1, st.noise_svf.ic2),
                      st.pink.fstate], dim=1).contiguous(),
           blk.bs, blk.powq)
    return VoicePhase("kick_a", ins, dict(sample_rate=blk.sr, qB=blk.qB,
                                          max_harmonics=int(max_harmonics)))


def _kick_phase_m(st, outs_a, blk):
    """Envelope follower and makeup gain between the launches; returns the
    kick's drive phase and what its finish needs."""
    total, ampsc = outs_a[0], outs_a[1]
    cur, tgt = st.params.current, st.params.target
    od = blk.traj(cur, tgt, KP["overdrive"])
    drive = 1.0 + od * od * od * 40.0
    fb = blk.traj(cur, tgt, KP["feedback"]) * 0.98
    bypass = drive <= 1.0          # mix is 1: bypass iff drive <= 1
    att, rel = fbws.env_coeffs(blk.sr)
    env, env_last = bank_kernels.env_follow_bank(total.abs(), bypass, st.shaper.env,
                                                 att=float(att), rel=float(rel))
    comp_signed = torch.where(bypass, -1.0, fbws.gain_compensation(env, drive, fb))
    ins = (total, comp_signed.contiguous(), ampsc, cur.contiguous(), tgt.contiguous(),
           bank_kernels.pack_fbws_bank(st.shaper), st.shaper.filter_state.contiguous(),
           blk.powq)
    return VoicePhase("kick_b", ins, dict(sample_rate=blk.sr)), (bypass, env_last)


def _kick_finish(st, outs_a, mctx, outs_b):
    from libgooey_tpu_torch.instruments import kick

    _total, _ampsc, ncur, nlat, ntrig, nfst = outs_a
    bypass, env_last = mctx
    out, nst, nfilt = outs_b
    new_ovs, dc_x1, dc_y1 = bank_kernels.unpack_fbws_bank(nst, st.shaper)
    # the drive oversampler's exact bypass freeze at block granularity
    # (feedback_waveshaper.rs:117-118 early return; effects/freeze.py)
    new_ovs = frz.hold_where(torch.all(bypass, dim=-1), st.shaper.ovs, new_ovs)
    return kick.KickState(
        params=SmootherBank(current=ncur, target=st.params.target),
        trig_sample=ntrig,
        velocity=nlat[:, KLAT["velocity"]],
        pitch_mult=nlat[:, KLAT["pitch_mult"]],
        pitch_curve=nlat[:, KLAT["pitch_curve"]],
        amp_decay=nlat[:, KLAT["amp_decay"]],
        amp_curve=nlat[:, KLAT["amp_curve"]],
        pm_active=nlat[:, KLAT["pm_active"]],
        click_hp=filters.OnePoleState(y=nfst[:, KFST["click"]]),
        noise_svf=filters.SVFState(ic1=nfst[:, KFST["ic1"]], ic2=nfst[:, KFST["ic2"]]),
        pink=st.pink._replace(fstate=nfst[:, KFST["p0"]:KFST["p0"] + 3]),
        shaper=fbws.FBShaperState(last_out=nfilt, filter_state=nfilt, dc_x1=dc_x1,
                                  dc_y1=dc_y1, env=env_last, ovs=new_ovs),
    ), out


def _snare_lat(st):
    return _cols(st.velocity, st.pitch_mult, st.amp_curve, st.tonal_curve, st.amp_decay,
                 st.pm_active)


def _snare_phase_a(st, off, vel, blk, max_harmonics):
    ins = (st.params.current.contiguous(), st.params.target.contiguous(), off, vel,
           st.trig_sample.contiguous(), _snare_lat(st), blk.bs, blk.powq)
    return VoicePhase("snare_a", ins, dict(sample_rate=blk.sr, qB=blk.qB,
                                           max_harmonics=int(max_harmonics)))


def _snare_phase_m(st, off, vel, outs_a, blk):
    """The Chamberlin (linrec2_bank) and the tap select between the
    launches; returns the snare's drive phase."""
    from libgooey_tpu_torch.instruments import snare

    dry, nraw = outs_a[0], outs_a[1]
    cur, tgt = st.params.current, st.params.target
    cutoff = 100.0 + torch.clamp(blk.traj(cur, tgt, SP["filter_cutoff"]), 0.0, 1.0) * (
        10_000.0 - 100.0)
    res = 0.5 + torch.clamp(blk.traj(cur, tgt, SP["filter_resonance"]), 0.0, 1.0) * (10.0 - 0.5)
    svf_state, lo, bp, hp, notch = filters.chamberlin_block(
        st.noise_svf, nraw, cutoff, res, blk.sr, reset=blk.at_trig(off))
    ft = st.filter_type[:, None]
    filtered = torch.where(ft == snare.FILTER_LP, lo,
                           torch.where(ft == snare.FILTER_HP, hp,
                                       torch.where(ft == snare.FILTER_NOTCH, notch, bp)))
    ins = (cur.contiguous(), tgt.contiguous(), off, vel, st.trig_sample.contiguous(),
           _snare_lat(st), dry, filtered.contiguous(), bank_kernels.pack_ws4_bank(st.ovs),
           blk.bs, blk.powq)
    od = blk.traj(cur, tgt, SP["overdrive"])
    return VoicePhase("snare_b", ins, dict(sample_rate=blk.sr)), (svf_state, od)


def _snare_finish(st, outs_a, mctx, outs_b):
    from libgooey_tpu_torch.instruments import snare

    _dry, _nraw, ncur, nlat, ntrig = outs_a
    svf_state, od = mctx
    out, nst = outs_b
    new_ovs = bank_kernels.unpack_ws4_bank(nst, st.ovs)
    # exact bypass freeze of the overdrive oversampler (waveshaper.rs:55-57
    # early return at drive <= 1, i.e. od <= 0; effects/freeze.py)
    new_ovs = frz.hold_where(torch.all(od <= 0.0, dim=-1), st.ovs, new_ovs)
    return snare.SnareState(
        params=SmootherBank(current=ncur, target=st.params.target),
        ovs=new_ovs,
        filter_type=st.filter_type,
        trig_sample=ntrig,
        velocity=nlat[:, SLAT["velocity"]],
        pitch_mult=nlat[:, SLAT["pitch_mult"]],
        amp_curve=nlat[:, SLAT["amp_curve"]],
        tonal_curve=nlat[:, SLAT["tonal_curve"]],
        amp_decay=nlat[:, SLAT["amp_decay"]],
        pm_active=nlat[:, SLAT["pm_active"]],
        noise_svf=svf_state,
    ), out


def _bass_phase_a(st, off, vel, note_freq, blk):
    V = st.trig_sample.shape[0]
    nf = (torch.zeros(V, dtype=_F32, device=blk.dev) if note_freq is None
          else blk.floats(note_freq))
    ins = (st.params.current.contiguous(), st.params.target.contiguous(), off, vel, nf,
           st.trig_sample.contiguous(),
           _cols(st.velocity, st.trig_freq, st.amp_decay_s, st.amp_curve, st.fenv_decay_s,
                 st.fenv_curve),
           _cols(st.sub_phase, st.osc_phase, st.det_phase), bank_kernels.pack_ws4_bank(st.ovs),
           blk.bs, blk.powq)
    return VoicePhase("bass", ins, dict(sample_rate=blk.sr, qB=blk.qB))


def _bass_finish(st, off, outs, blk):
    from libgooey_tpu_torch.instruments import bass

    satur, cut, res, ampsc, ncur, nlat, ntrig, nph, nst = outs
    # the swept low-pass: svf_bank (filters.svf_tpt_outputs)
    svf_state, filtered, _bp, _hp = filters.svf_tpt_outputs(
        st.svf, satur, cut, res, blk.sr, reset=blk.at_trig(off))
    new_ovs = bank_kernels.unpack_ws4_bank(nst, st.ovs)
    # exact bypass freeze of the drive oversampler (bass.rs:846 ticks the
    # shaper only when od > 0.001; effects/freeze.py)
    od = blk.traj(st.params.current, st.params.target, bass.PARAM_INDEX["overdrive"])
    new_ovs = frz.hold_where(torch.all(od <= 0.001, dim=-1), st.ovs, new_ovs)
    return bass.BassState(
        ovs=new_ovs,
        params=SmootherBank(current=ncur, target=st.params.target),
        trig_sample=ntrig,
        velocity=nlat[:, BLAT["velocity"]],
        trig_freq=nlat[:, BLAT["trig_freq"]],
        amp_decay_s=nlat[:, BLAT["amp_decay"]],
        amp_curve=nlat[:, BLAT["amp_curve"]],
        fenv_decay_s=nlat[:, BLAT["fenv_decay"]],
        fenv_curve=nlat[:, BLAT["fenv_curve"]],
        sub_phase=nph[:, 0],
        osc_phase=nph[:, 1],
        det_phase=nph[:, 2],
        svf=svf_state,
    ), filtered * ampsc


def _hihat2_phase_a(st, off, vel, blk):
    ins = (st.params.current.contiguous(), st.params.target.contiguous(), off, vel,
           st.trig_sample.contiguous(), st.velocity[:, None].contiguous(),
           st.noise_color.to(_I32).contiguous(), st.filter_slope.to(_I32).contiguous(),
           _cols(st.mod_phase, st.main_phase, st.env_smooth),
           _cols(st.hpf1.x1, st.hpf1.x2, st.hpf1.y1, st.hpf1.y2,
                 st.hpf2.x1, st.hpf2.x2, st.hpf2.y1, st.hpf2.y2),
           _cols(st.svf.ic1, st.svf.ic2), st.pink.fstate.contiguous(),
           st.voice_salt.to(_I32).contiguous(), blk.bs, blk.powq)
    return VoicePhase("hihat2", ins, dict(sample_rate=blk.sr, qB=blk.qB))


def _hihat2_finish(st, outs):
    out, ncur, nlat, ntrig, nph, nhpf, nsvf, npink = outs
    return st._replace(
        params=SmootherBank(current=ncur, target=st.params.target),
        trig_sample=ntrig,
        velocity=nlat[:, 0],
        mod_phase=nph[:, 0],
        main_phase=nph[:, 1],
        env_smooth=nph[:, 2],
        hpf1=filters.BiquadState(x1=nhpf[:, 0], x2=nhpf[:, 1], y1=nhpf[:, 2], y2=nhpf[:, 3]),
        hpf2=filters.BiquadState(x1=nhpf[:, 4], x2=nhpf[:, 5], y1=nhpf[:, 6], y2=nhpf[:, 7]),
        svf=filters.SVFState(ic1=nsvf[:, 0], ic2=nsvf[:, 1]),
        pink=st.pink._replace(fstate=npink),
    ), out


def _tom2_phase_a(st, off, blk, triangle_enabled):
    m = st.morph
    ins = (st.params.contiguous(), off, st.trig_sample.contiguous(), st.decay_s.contiguous(),
           _cols(st.tri_phase, m.main_phase, m.tri_phase, m.fixed_phase, m.gated_phase,
                 m.rand_frac),
           m.rand_seg.to(_I32).contiguous(), blk.bs)
    return VoicePhase("tom2", ins, dict(sample_rate=blk.sr, B=blk.B,
                                        triangle_enabled=bool(triangle_enabled)))


def _tom2_finish(outs):
    """``(front, mixed, env, main_done, fade, freq)`` as
    pallas_voice._tom2_finish gives them."""
    mixed, env, done, fade, freq, ntrig, ndec, nph, nseg = outs
    front = (ntrig, ndec, nph[:, 0],
             morph.MorphState(main_phase=nph[:, 1], tri_phase=nph[:, 2],
                              fixed_phase=nph[:, 3], gated_phase=nph[:, 4],
                              rand_seg=nseg, rand_frac=nph[:, 5]))
    return front, mixed, env, done > 0.5, fade, freq


# --- the kit ------------------------------------------------------------------------


KINDS = ("kick", "snare", "hihat2", "bass", "tom2")


def kit_render_fused(states, offs, vels, block_start, *, kinds, sample_rate, block_size,
                     smooth_coeff, kick_max_harmonics=256, snare_max_harmonics=256,
                     tom2_triangle=True, bass_note_freq=None):
    """Render several families through the two kit launches.

    ``kinds``: the families to render, each present in ``states``/``offs``/
    ``vels`` (``[V]`` trigger offsets, ``block_size`` = none, and
    velocities); callers gate eligibility as the per-family wrappers do
    (one trigger slot, no overrides, kick ``feedback_path=False``, os_mode
    4, V <= MAX_FUSED_VOICES).  Returns ``{kind: (new_state, out [V, B])}``."""
    from libgooey_tpu_torch.instruments import tom2

    dev = states[kinds[0]].trig_sample.device
    blk = _Block(dev, block_start, block_size, sample_rate, smooth_coeff)
    off = {k: blk.ints(offs[k]) for k in kinds}
    vel = {k: blk.floats(vels[k]) for k in kinds}

    phases_a = []
    for kind in kinds:
        st = states[kind]
        if kind == "kick":
            phases_a.append(_kick_phase_a(st, off[kind], vel[kind], blk, kick_max_harmonics))
        elif kind == "snare":
            phases_a.append(_snare_phase_a(st, off[kind], vel[kind], blk, snare_max_harmonics))
        elif kind == "hihat2":
            phases_a.append(_hihat2_phase_a(st, off[kind], vel[kind], blk))
        elif kind == "bass":
            phases_a.append(_bass_phase_a(st, off[kind], vel[kind], bass_note_freq, blk))
        elif kind == "tom2":
            phases_a.append(_tom2_phase_a(st, off[kind], blk, tom2_triangle))
        else:
            raise KeyError(f"kit_render_fused: unsupported family {kind!r}")
    outs_a = dict(zip(kinds, voice_kernels.kit_sources(phases_a)))

    # the middles on the bank kernels, then the drive launch
    phases_b, b_order, mctx = [], [], {}
    if "kick" in kinds:
        ph, mctx["kick"] = _kick_phase_m(states["kick"], outs_a["kick"], blk)
        phases_b.append(ph)
        b_order.append("kick")
    if "snare" in kinds:
        ph, mctx["snare"] = _snare_phase_m(states["snare"], off["snare"], vel["snare"],
                                           outs_a["snare"], blk)
        phases_b.append(ph)
        b_order.append("snare")
    outs_b = dict(zip(b_order, voice_kernels.kit_drive(phases_b))) if phases_b else {}

    results = {}
    for kind in kinds:
        st = states[kind]
        if kind == "kick":
            results[kind] = _kick_finish(st, outs_a[kind], mctx[kind], outs_b[kind])
        elif kind == "snare":
            results[kind] = _snare_finish(st, outs_a[kind], mctx[kind], outs_b[kind])
        elif kind == "hihat2":
            results[kind] = _hihat2_finish(st, outs_a[kind])
        elif kind == "bass":
            results[kind] = _bass_finish(st, off[kind], outs_a[kind], blk)
        else:
            results[kind] = tom2.finish_fused(st, off[kind], blk.bs, *_tom2_finish(outs_a[kind]),
                                              sample_rate=blk.sr, block_size=blk.B)
    return results


def _one(kind, state, trig_offset, trig_velocity, block_start, **kw):
    return kit_render_fused({kind: state}, {kind: trig_offset}, {kind: trig_velocity},
                            block_start, kinds=(kind,), **kw)[kind]


def kick_render_fused(state, trig_offset, trig_velocity, block_start, *, sample_rate,
                      block_size, smooth_coeff, max_harmonics=128):
    """The kick bank's block through the kit kernels (pallas_voice.py:839);
    the stage twin is ``kick.render_block``.  Returns ``(new_state, out)``."""
    return _one("kick", state, trig_offset, trig_velocity, block_start,
                sample_rate=sample_rate, block_size=block_size, smooth_coeff=smooth_coeff,
                kick_max_harmonics=max_harmonics)


def snare_render_fused(state, trig_offset, trig_velocity, block_start, *, sample_rate,
                       block_size, smooth_coeff, max_harmonics=128):
    """The snare bank's block through the kit kernels (pallas_voice.py:1122)."""
    return _one("snare", state, trig_offset, trig_velocity, block_start,
                sample_rate=sample_rate, block_size=block_size, smooth_coeff=smooth_coeff,
                snare_max_harmonics=max_harmonics)


def bass_render_fused(state, trig_offset, trig_velocity, block_start, *, sample_rate,
                      block_size, smooth_coeff, note_freq=None):
    """The bass bank's block through the kit kernels (pallas_voice.py:1362)."""
    return _one("bass", state, trig_offset, trig_velocity, block_start,
                sample_rate=sample_rate, block_size=block_size, smooth_coeff=smooth_coeff,
                bass_note_freq=note_freq)


def hihat2_render_fused(state, trig_offset, trig_velocity, block_start, *, sample_rate,
                        block_size, smooth_coeff):
    """The hihat2 bank's block through the kit kernels (pallas_voice.py:1622)."""
    return _one("hihat2", state, trig_offset, trig_velocity, block_start,
                sample_rate=sample_rate, block_size=block_size, smooth_coeff=smooth_coeff)


def tom2_sources_fused(state, trig_offset, block_start, *, sample_rate, block_size,
                       triangle_enabled=True):
    """tom2's source stage through ``kit_sources`` (pallas_voice.py:1868).
    Returns ``(front, mixed, env, main_done, fade_factor, modulated_freq)``
    with ``front = (trig_sample, decay_s, tri_phase, MorphState)``; the
    caller runs the bandpass and the membrane."""
    dev = state.trig_sample.device
    blk = _Block(dev, block_start, block_size, sample_rate, 0.0)
    (outs,) = voice_kernels.kit_sources(
        [_tom2_phase_a(state, blk.ints(trig_offset), blk, triangle_enabled)])
    return _tom2_finish(outs)
