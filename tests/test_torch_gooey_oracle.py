"""The port's ``GooeyEngine`` against tests/test_pipeline_oracle.py's
per-sample oracle of the whole FFI pipeline (ffi.rs:1043-1380: triggers,
an LFO route, the four kit voices, panned strips, the graph's Drums track,
the master gain, the saturation and the soft limiter), on the per-block and
the span paths, on the CPU.  The oracle and its configuration are imported
from that file; the engine is built as its ``_mk_engine`` builds the JAX
one.  Bound: 1e-4 a sample.
"""

import numpy as np
import pytest

import test_pipeline_oracle as po

from libgooey_tpu_torch.gooey import GooeyEngine
from libgooey_tpu_torch.mixer import chain as chain_mod

TOL = 1e-4


def _mk_engine(span: bool) -> GooeyEngine:
    g = GooeyEngine(po.SR, po.B, device="cpu")
    g.span_rendering = span
    for strip in range(4):
        seq = g.sequencers[strip]
        seq.set_bpm(po.BPM)
        seq.set_pattern_string(po.PATTERNS[strip] * 4)
        seq.start()
        g.strip_gain[strip] = po.STRIP_GAIN[strip]
        g.strip_pan[strip] = po.STRIP_PAN[strip]
    g.graph.set_track_gain(0, po.TRACK_GAIN)
    g.graph.set_track_pan(0, po.TRACK_PAN)
    g.set_master_gain(po.MASTER)
    g.engine.set_lfo(0, frequency_hz=po.LFO_HZ, amount=po.LFO_AMOUNT)
    g.engine.lfos[0].enabled = True
    g.engine.add_lfo_route(0, "ch0_kick", "volume", po.LFO_DEPTH)
    g.set_effect_enabled(chain_mod.EFFECT_SATURATION, True)
    return g


@pytest.fixture(scope="module")
def oracle():
    return po._oracle_render()


@pytest.mark.parametrize("span", [False, True], ids=["per-block", "span"])
def test_pipeline_matches_per_sample_oracle(oracle, span):
    g = _mk_engine(span)
    got = g.render(po.N_BLOCKS * po.B)
    assert g.error is None, g.error
    err = float(np.abs(got - oracle).max())
    assert err <= TOL, err
    assert float(np.abs(oracle).max()) > 1e-3
