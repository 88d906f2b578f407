"""What can stand in the window's place: the program, the control (the
reference computed a precision lower) and the program with a fault
planted.  The benchmark's own runs drive only the program; the control
and the faults are for ``portbench/tests`` and the runs that set the
limits (PERF.md)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.harness.program import Program

FAULTS = ("stale_state", "half_voices", "altered_sample")


def bf16(a):
    """``a`` rounded to the nearest bfloat16 (ties to even), held in its own
    float type."""
    a = np.asarray(a)
    x = a.astype(np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    r = np.where(np.isfinite(x), u.view(np.float32), x)
    return r.astype(a.dtype)


def _round(x):
    if isinstance(x, dict):
        return {k: _round(v) for k, v in x.items()}
    a = np.asarray(x)
    return bf16(a) if a.dtype.kind == "f" else x


class Control:
    """The reference in the program's place, its state, its stereo and its
    mono rounded to bfloat16 after every block (the nearest precision below
    the configurations' float32)."""

    has_chain = False

    def __init__(self, cfg, device):
        from portbench.reference.render import Reference

        self.ref = Reference(cfg)
        self._bus = None

    def initial_state(self):
        self._bus = self.ref.bus()
        return self.ref.init_state()

    def upload(self, events):
        return events                     # the reference takes host arrays

    def render(self, state, events):
        events = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                  for k, v in events.items()}
        state, out, mono = self.ref.render_block(state, events, self._bus)
        return (_round(state), torch.from_numpy(bf16(out).astype(np.float32)),
                torch.from_numpy(bf16(mono).astype(np.float32)))


class Faulty(Program):
    """The program with one fault planted in its timed path:
    ``stale_state`` (a block returns its state unchanged), ``half_voices``
    (the mix takes the first half of the voices and scales their sum to the
    whole: the mean over the rest), ``altered_sample`` (one sample of every
    block's stereo moved by 1e-3 where it is produced)."""

    def __init__(self, cfg, device, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")
        super().__init__(cfg, device)
        self.fault = fault

    def render(self, state, events):
        if self.fault == "half_voices":
            with _half_mix():
                return super().render(state, events)
        new_state, out, mono = super().render(state, events)
        if self.fault == "stale_state":
            return state, out, mono
        if self.fault == "altered_sample":
            out = out.clone()
            out[0, out.shape[-1] // 3] += 1e-3
        return new_state, out, mono


@contextlib.contextmanager
def _half_mix():
    from libgooey_tpu_torch.ops import bank_kernels

    real = bank_kernels.mix_bank

    def half(voices, pan_cur, pan_tgt, gain_cur, gain_tgt, *, coeff):
        V = voices.shape[0]
        h = max(1, V // 2)
        sums = real(voices[:h].contiguous(), pan_cur[:h].contiguous(), pan_tgt[:h].contiguous(),
                    gain_cur[:h].contiguous(), gain_tgt[:h].contiguous(), coeff=coeff)
        return tuple(s * np.float32(V / h) for s in sums)

    bank_kernels.mix_bank = half
    try:
        yield
    finally:
        bank_kernels.mix_bank = real


def make(name: str, cfg, device):
    """``"program"``, ``"control"`` or ``"fault:<name>"``."""
    if name == "program":
        return Program(cfg, device)
    if name == "control":
        return Control(cfg, device)
    if name.startswith("fault:"):
        return Faulty(cfg, device, name[len("fault:"):])
    raise ValueError(f"unknown system {name!r}")
