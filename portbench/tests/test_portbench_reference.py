"""The plain reference against the port at a tiny size on the CPU: every
family's bank (the stage path, and for the product kit the kit path, the
kit kernels' plain versions), the mix, the master, both configurations'
bus and chain and the limiter, block after block; the state read by
meaning; and one block from the program's state read by meaning, as the
step check renders it."""

import copy

import numpy as np
import pytest
import torch

from portbench.harness import meaning, spec
from portbench.harness.program import Program
from portbench.harness.traffic import EventTable
from portbench.reference.render import Reference
from small import CPU, OVERRIDES

N_BLOCKS = 6


def _setup(config):
    cfg = spec.config(config)
    cfg.update(OVERRIDES["config"])
    mix = spec.traffic("wide")
    mix.update(OVERRIDES["traffic"])
    return cfg, EventTable(cfg, mix, 11)


@pytest.mark.parametrize("config,kit_path", [("drum_kit_bus7", False),
                                             ("product_kit_chain9", True)])
def test_reference_follows_the_port(config, kit_path, monkeypatch):
    from libgooey_tpu_torch.ops import voice

    monkeypatch.setattr(voice, "IMPL", "pallas" if kit_path else "auto")
    torch.set_num_threads(2)
    cfg, table = _setup(config)
    kinds = list(cfg["voices"])
    prog, ref = Program(cfg, CPU), Reference(cfg)
    ps, rs, bus = prog.initial_state(), ref.init_state(), ref.bus()
    assert meaning.gap(meaning.read(ps, kinds), rs)[0] <= 1e-6
    loud = 0.0
    with torch.no_grad():
        for b in range(N_BLOCKS):
            ev = table.block(b)
            ps, py, pm = prog.render(ps, ev)
            if prog.has_chain:
                ps, py = prog.process_chain(ps, py)
            rs, ry, rm = ref.render_block(rs, ev, bus)
            np.testing.assert_allclose(py.numpy(), ry, rtol=0, atol=2e-5)
            np.testing.assert_allclose(pm.numpy(), rm, rtol=0, atol=2e-5)
            loud = max(loud, float(np.abs(ry).max()))
        assert loud > 1e-3
        g, where = meaning.gap(meaning.read(ps, kinds), rs)
        assert g <= 1e-4, where
        # the step check: one block from the program's state read by meaning
        ev = table.block(N_BLOCKS)
        ss, _y, sm = ref.render_block(meaning.read(ps, kinds), ev)
        ps, py, pm = prog.render(ps, ev)
    np.testing.assert_allclose(pm.numpy(), sm, rtol=0, atol=2e-5)
    g, where = meaning.gap(meaning.read(ps, kinds), ss)
    assert g <= 1e-4, where


def test_gap_compares_by_meaning():
    cfg, _table = _setup("drum_kit_bus7")
    ref = Reference(cfg)
    a = ref.init_state()
    b = copy.deepcopy(a)
    assert meaning.gap(a, b)[0] == 0.0
    b["hihat2"]["main_phase"][0] = 1.0 - 1e-6          # a phase: around the circle
    assert meaning.gap(a, b)[0] < 2e-6
    b["kick"]["pitch_mult"][0] = 9.0                    # never struck: means nothing yet
    assert meaning.gap(a, b)[0] < 2e-6
    b["kick"]["trig_sample"][0] = 3                     # an integer: exactly
    g, where = meaning.gap(a, b)
    assert g == float("inf") and where == "kick.trig_sample"
