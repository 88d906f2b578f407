"""The port's DSL against the JAX package's, on the CPU: ``parse`` of
``tests/test_dsl_capi.py``'s program and its error cases (the same
``Program`` field by field, the same messages), ``build_engine`` (the same
instruments, configs, sequencers, LFOs and effects) and one render of 4,096
samples within 1e-4.  With no card, ``build_engine`` on the default device
raises.  One JAX ``Engine`` is compiled (kick, hihat2, lowpass, delay).
"""

import dataclasses

import numpy as np
import pytest
import torch

from libgooey_tpu import dsl as jdsl
from libgooey_tpu_torch import dsl as tdsl

TOL = 1e-4

PROGRAM = """
# four on the floor with a hat
bpm 130
master 0.5
inst kick kick tight
inst hat hihat2 short
seq kick x...x...x...x...
seq hat 9.5.9.5.9.5.9.5. swing=0.2
lfo 1bar kick.frequency amt=0.4
fx lowpass 2000 0.3
fx delay 0.5 0.4 0.25 6000
"""

#: every statement kind, aliases and defaults included
WIDE = """
bpm 97.5
master 0.3
inst k kick dirty
inst s snare
inst h hat open
inst t tom floor_tom
inst t2 tom2
inst b bass acid
inst p poly pad
seq k x...x...|x...x...
seq s ....9...
lfo quarter k.osc_decay
lfo 1/16 b.filter_cutoff amount=0.25
fx filter 1200
fx reverb
fx plate 0.4 0.2
fx compressor -18 3
fx saturation 0.4
fx tilt 0.3 0.5
fx limiter 0.9
"""

ERRORS = (("inst x zither", "unknown instrument family"),
          ("seq ghost x...", "unknown instrument"),
          ("inst a kick\ninst a snare", "duplicate"),
          ("fnord 3", "unknown statement"),
          ("bpm", "bpm takes one value"),
          ("inst k kick\nlfo fortnight k.frequency", "unknown LFO division"),
          ("inst k kick\nlfo 1bar k", "lfo needs"),
          ("fx chorus", "unknown effect"),
          ("inst k", "inst needs"))


@pytest.mark.parametrize("source", [PROGRAM, WIDE], ids=["program", "wide"])
def test_parse_matches_jax(source):
    assert dataclasses.asdict(tdsl.parse(source)) == dataclasses.asdict(jdsl.parse(source))


@pytest.mark.parametrize("source,match", ERRORS, ids=[m for _, m in ERRORS])
def test_parse_errors_match_jax(source, match):
    with pytest.raises(ValueError, match=match) as want:
        jdsl.parse(source)
    with pytest.raises(ValueError) as got:
        tdsl.parse(source)
    assert str(got.value) == str(want.value)


def test_tables_match_jax():
    for name in ("DIVISIONS", "PRESET_ALIASES", "PARAM_ALIASES", "FAMILY_ALIASES", "FX_NAMES",
                 "FX_CANONICAL"):
        assert getattr(tdsl, name) == getattr(jdsl, name), name


def _host(e):
    """The host side of a built Engine, comparable across the two packages."""
    return dict(
        names=dict(e._names),
        targets={k: [np.asarray(t).tolist() for t in v] for k, v in e._targets.items()},
        configs={k: [dataclasses.asdict(c) for c in v] for k, v in e._configs.items()},
        seqs=[(s.name, s.bpm, [(st.enabled, st.velocity) for st in s.pattern],
               s.swing.target, s.swing.current, s.is_running) for s in e.sequencers],
        lfos=[dataclasses.asdict(c) for c in e.lfos],
        routes=[dataclasses.asdict(r) for r in e.lfo_routes],
        fx_order=list(e.fx_order),
        fx_targets={k: np.asarray(v).tolist() for k, v in e.fx_targets.items()},
        master=e._master_target, limiter=e.limiter_threshold)


@pytest.mark.parametrize("source", [PROGRAM, WIDE], ids=["program", "wide"])
def test_build_engine_matches_jax(source):
    assert _host(tdsl.build_engine(source, device="cpu")) == _host(jdsl.build_engine(source))


def test_render_matches_jax():
    want = np.asarray(jdsl.build_engine(PROGRAM).render(4096))
    got = tdsl.build_engine(PROGRAM, device="cpu").render(4096)
    assert got.shape == want.shape == (2, 4096) and got.dtype == np.float32
    assert np.abs(want).max() > 1e-4
    err = float(np.abs(got - want).max())
    assert err <= TOL, err


def test_build_engine_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdsl.build_engine(PROGRAM)
