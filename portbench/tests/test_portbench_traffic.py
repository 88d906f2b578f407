"""The traffic generator: deterministic by seed, and equal to the builders
it was copied from (chip_smoke.py's ``sequenced_events``, the port's host
sequencer) at a small size."""

import numpy as np

from portbench.harness import spec
from portbench.harness.traffic import EventTable, hit_samples
from small import UNIT

SR, B = 44100.0, 512


def _cfg(voices=UNIT):
    cfg = spec.config("drum_kit_bus7")
    cfg["voices"] = dict(voices)
    return cfg


def _mix():
    return spec.traffic("wide")


def test_same_seed_same_events_other_seed_other_lags():
    a, b = EventTable(_cfg(), _mix(), 2**31 + 5, 48), EventTable(_cfg(), _mix(), 2**31 + 5, 48)
    c = EventTable(_cfg(), _mix(), 2**31 + 6, 48)
    for kind in UNIT:
        for x, y in zip(a.banks[kind], b.banks[kind]):
            np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(a.banks[k][0], c.banks[k][0]) for k in UNIT)


def test_equals_chip_smoke_sequenced_events():
    import chip_smoke

    voices = {"kick": 6, "snare": 5, "hihat2": 4, "tom2": 3, "bass": 7}
    n = 48
    table = EventTable(_cfg(voices), _mix(), 0, n)
    rng = np.random.RandomState(0)
    for kind, nv in voices.items():
        offs, vels = chip_smoke.sequenced_events(rng, nv, n)
        np.testing.assert_array_equal(table.banks[kind][0], offs)
        np.testing.assert_array_equal(table.banks[kind][1], vels)


def test_hits_equal_the_port_sequencer():
    from libgooey_tpu_torch.engine.sequencer import Sequencer

    seq = Sequencer(120.0, SR, 16)
    seq.set_pattern([True] * 16)
    seq.start()
    n_blocks = 700
    hits = []
    for b in range(n_blocks):
        hits += [b * B + t.offset for t in seq.tick_block(B)]
    mix = _mix()
    assert hit_samples(mix["sequencer"], SR, n_blocks * B) == hits


def test_block_and_chunk_agree_and_loop():
    table = EventTable(_cfg(), _mix(), 3, 10)
    chunk = table.chunk(7, 6)                       # wraps past the table's end
    for r in range(6):
        ev = table.block(7 + r)
        assert int(chunk["block_start"][r]) == int(ev["block_start"]) == (7 + r) * B
        for kind in UNIT:
            np.testing.assert_array_equal(chunk[kind + "_off"][r], ev[kind + "_off"])
            np.testing.assert_array_equal(chunk[kind + "_vel"][r], ev[kind + "_vel"])
    np.testing.assert_array_equal(table.block(12)["kick_off"], table.block(2)["kick_off"])
