"""The port's realtime output adapter (``engine/output.py``) through
tests/test_output.py's cases (the ramp engine's channel mapping and block
continuity, the prefetch queue, underruns and overruns, jitter absorbed by
prefetch, the overrun threshold), each run with the port's ``EngineOutput``
in place of the JAX package's; the null realtime stream; and the port's
``GooeyEngine`` on the CPU through ``fill``, synchronous and prefetched,
equal to the same engine's own ``render``.
"""

import time

import numpy as np
import pytest

import test_output

from libgooey_tpu_torch.engine import output as tout
from libgooey_tpu_torch.gooey import GooeyEngine

B = 128

CASES = ("test_fill_channel_mapping_synchronous", "test_fill_continuity_across_block_boundaries",
         "test_prefetch_pipeline_and_underrun_overrun", "test_take_overrun_count_resets",
         "test_jittery_callback_clock_absorbed_by_prefetch",
         "test_sustained_deadline_miss_counts_and_threshold_stops")


@pytest.mark.parametrize("case", CASES)
def test_output_case_on_the_port(monkeypatch, case):
    monkeypatch.setattr(test_output, "EngineOutput", tout.EngineOutput)
    getattr(test_output, case)()


def test_realtime_stream_null_backend_paces_callbacks():
    out = tout.EngineOutput(prefetch_blocks=8)
    out.initialize(44100.0)
    out.create_stream_with_engine(test_output.RampEngine())
    got = []
    stream = tout.RealtimeStream(out, backend="null", frames_per_buffer=256, sink=got.append)
    assert stream.backend == "null" or tout.sounddevice_available()
    stream.start()
    time.sleep(0.15)
    stream.stop()
    assert len(got) >= 10, len(got)
    assert 10 * 256 <= out.sample_counter <= 0.25 * 44100
    first = got[0].reshape(-1, 2)
    np.testing.assert_array_equal(first[:, 0], -first[:, 1])
    assert out.take_overrun_count() <= 1


def _engine():
    g = GooeyEngine(44100.0, B, device="cpu")
    g.set_bpm(2400.0)
    g.sequencers[0].set_step_with_settings(0, True, 1.0)
    g.sequencers[0].set_step_with_settings(2, True, 0.6)
    g.sequencers[0].start()
    return g


@pytest.mark.parametrize("prefetch", [0, 2])
def test_output_drives_the_port_engine(prefetch):
    """Sequenced kicks flow through ``fill`` with the stereo contract
    intact, equal to a twin engine's direct per-block render."""
    g, twin = _engine(), _engine()
    twin.span_rendering = False
    want = twin.render(4 * B).reshape(-1, 2)
    out = tout.EngineOutput(prefetch_blocks=prefetch)
    out.initialize(44100.0)
    out.create_stream_with_engine(g)
    assert out._block == B
    out.start()
    if prefetch:
        deadline = time.time() + 30.0
        while time.time() < deadline:
            with out._lock:
                if len(out._queue) >= prefetch:
                    break
            time.sleep(0.01)
    bufs = []
    for frames in (100, 156, 2 * B):       # straddles the engine's blocks
        buf = np.zeros(frames * 2, np.float32)
        assert out.fill(buf, 2) == frames
        bufs.append(buf.reshape(-1, 2))
    out.stop()
    frames = np.concatenate(bufs)
    assert out.sample_counter == 4 * B
    assert np.all(np.isfinite(frames)) and np.abs(frames).max() > 1e-3
    np.testing.assert_allclose(frames[:, 0], frames[:, 1], atol=1e-6)   # a centred kick
    if prefetch == 0:
        np.testing.assert_array_equal(frames, want)
    assert g.error is None, g.error
