"""The port's visualization and terminal scope (``visualization.py``,
``tui.py``) on the CPU.

tests/test_viz_misc.py's cases for the capture ring, the spectrogram, the
offscreen display and the terminal scope (a frame, and ``run`` against the
port's ``EngineOutput``) run with the port's classes in place of the JAX
package's, the FFT on ``device="cpu"``.  Then the port against the JAX
package on the same signals: ``analyze`` and ``analyze_many`` within 1e-3
dB on every bin above -100 dB of bin-centred tones (on a rich signal, on
every bin less than 40 dB under the peak; further down the float32 FFT's
rounding shows on both sides), and ``TerminalScope.frame()`` text equal to
the JAX one, character for character, on the scope test's sine with meters.
"""

import functools
import sys
import types

import numpy as np
import pytest

import test_viz_misc

from libgooey_tpu import tui as jtui
from libgooey_tpu import visualization as jviz

from libgooey_tpu_torch import tui as ttui
from libgooey_tpu_torch import visualization as tviz
from libgooey_tpu_torch.engine import output as tout

SR = 44100.0
DB_TOL = 1e-3


@pytest.fixture
def on_the_port(monkeypatch):
    """test_viz_misc's names (and its function-level imports of the JAX
    tui and output modules) bound to the port's, the FFT on the CPU."""
    monkeypatch.setattr(test_viz_misc, "AudioBuffer", tviz.AudioBuffer)
    monkeypatch.setattr(test_viz_misc, "SpectrogramAnalyzer",
                        functools.partial(tviz.SpectrogramAnalyzer, device="cpu"))
    monkeypatch.setattr(test_viz_misc, "WaveformDisplay", tviz.WaveformDisplay)
    monkeypatch.setitem(sys.modules, "libgooey_tpu.tui", types.SimpleNamespace(
        TerminalScope=functools.partial(ttui.TerminalScope, device="cpu")))
    monkeypatch.setitem(sys.modules, "libgooey_tpu.engine.output", tout)


CASES = ("test_audio_buffer_ring", "test_spectrogram_peak_bin_and_db",
         "test_waveform_display_renders_trace", "test_terminal_scope_frame_headless",
         "test_terminal_scope_runs_against_output_adapter")


@pytest.mark.parametrize("case", CASES)
def test_viz_case_on_the_port(on_the_port, case):
    getattr(test_viz_misc, case)()


def test_no_card_raises_unless_the_cpu_is_asked():
    if tviz.torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tviz.SpectrogramAnalyzer(1024, SR, 4)
    assert tviz.SpectrogramAnalyzer(1024, SR, 4, device="cpu").device.type == "cpu"


def _tones(n=4096):
    """Three tones at bin centres of a 1,024-point frame, 0, -18 and -38 dB:
    every bin above -100 dB lies within the Hann main lobes."""
    t = np.arange(n) / SR
    x = sum(a * np.sin(2 * np.pi * (k * SR / 1024) * t)
            for a, k in ((0.8, 37), (0.1, 100), (0.01, 301)))
    return x.astype(np.float32)


def _rich(n=4096):
    """Two off-bin partials and a little noise: skirts and a floor 40-80 dB
    under the peak, where a float32 FFT's rounding shows."""
    t = np.arange(n) / SR
    rs = np.random.RandomState(0)
    x = (0.6 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 5123.0 * t)
         + 1e-3 * rs.randn(n))
    return x.astype(np.float32)


def _histories(x):
    j = jviz.SpectrogramAnalyzer(1024, SR, 8)
    t = tviz.SpectrogramAnalyzer(1024, SR, 8, device="cpu")
    for a in (j, t):
        a.analyze(x)
        a.analyze_many(x[:4096].reshape(4, 1024))
    assert len(t.get_history()) == len(j.get_history()) == 5
    return zip(t.get_history(), j.get_history())


def _db_err(port, ref, floor):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    live = ref > floor
    assert live.sum() >= 3
    return float(np.abs(port[live] - ref[live]).max())


def test_spectrum_matches_jax_on_tones():
    """``analyze`` and ``analyze_many`` within 1e-3 dB on every bin above
    -100 dB."""
    for port, ref in _histories(_tones()):
        assert _db_err(port, ref, -100.0) <= DB_TOL


def test_spectrum_matches_jax_on_a_rich_signal():
    """Within 1e-3 dB on every bin less than 40 dB under the frame's peak.
    Further down, both sides carry their float32 FFT's rounding: the JAX
    package's own spectrum lies 6e-3 dB from the float64 one there, so the
    two are held to 2e-2 dB on every bin above -100 dB."""
    for port, ref in _histories(_rich()):
        assert _db_err(port, ref, float(np.max(ref)) - 40.0) <= DB_TOL
        assert _db_err(port, ref, -100.0) <= 2e-2


def test_terminal_frame_text_matches_jax():
    ring_j, ring_t = jviz.AudioBuffer(4096), tviz.AudioBuffer(4096)
    t = np.arange(4096, dtype=np.float32)
    sig = 0.8 * np.sin(2 * np.pi * 440.0 * t / 44100.0)
    ring_j.push(sig)
    ring_t.push(sig)
    js = jtui.TerminalScope(ring_j, width=40, height=8, sample_rate=SR)
    ts = ttui.TerminalScope(ring_t, width=40, height=8, sample_rate=SR, device="cpu")
    for s in (js, ts):
        s.set_meter("strip0", 0.5)
    assert ts.frame() == js.frame()
