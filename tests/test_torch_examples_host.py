"""The port's themed, host-engine and tool examples (``libgooey_tpu_torch/
examples/``) on the CPU, with tests/test_examples.py's checks.

The themed tours and the ``GooeyEngine``/C-API examples run on
``device="cpu"`` cut to ``BLOCKS`` blocks (``blocks=``, every section in
proportion) and must write a finite 44.1 kHz WAV of about that length,
audible but for ``loops_and_clips`` (its first half waits for the bar).
The bounce writes the same render at 16, 24 and 32 bits and two fresh
engines agree; the oversampler validation reports at least 20 dB of alias
reduction at 4x (the reference's bound) and at 2x; the aliasing data shows
polyBLEP beating the naive waveforms by over 6 dB; the scope writes a frame.
The per-instrument tours are in tests/test_torch_examples_engine.py, the
effect and sequencing ones in tests/test_torch_examples_effects.py.
"""

import csv

import numpy as np
import pytest

from libgooey_tpu.io_wav import read_wav

from test_torch_examples_engine import check_wav, one_torch_thread, port_example  # noqa: F401

BLOCKS = 2

MODULES = [
    "drums", "bass_sequencer", "chords", "effects_lab", "granular",
    "loops_and_clips", "sampler_rack", "performance_record", "dsl_demo",
]


@pytest.mark.parametrize("name", MODULES)
def test_example_runs_on_the_port(name, tmp_path):
    out = port_example(name).main(seconds=0.5, out_path=str(tmp_path / f"{name}.wav"),
                                  device="cpu", blocks=BLOCKS)
    check_wav(out, int(0.9 * BLOCKS * 512), audible=name != "loops_and_clips", name=name)


def test_submix_example_runs_on_the_port(tmp_path):
    out = port_example("multi_channel_submix").main(out_path=str(tmp_path / "submix.wav"),
                                                    quick=True, device="cpu", blocks=BLOCKS)
    check_wav(out, int(0.9 * BLOCKS * 512), name="multi_channel_submix")


def test_bounce_example_on_the_port(tmp_path, capsys):
    paths = port_example("bounce").main(quick=True, device="cpu", blocks=BLOCKS,
                                        out_dir=str(tmp_path))
    assert len(paths) == 3
    ref = None
    for p in paths:
        audio, sr = read_wav(p)
        assert sr == 44100 and np.all(np.isfinite(audio))
        mono = audio if audio.ndim == 1 else audio.mean(axis=0)
        if ref is None:
            ref = mono
            assert np.abs(ref).max() > 1e-5
        else:  # same render at every bit depth (within quantization)
            assert np.max(np.abs(mono[: len(ref)] - ref[: len(mono)])) < 2e-4
    assert "deterministic: True" in capsys.readouterr().out


def test_antialias_and_aliasing_examples_on_the_port(tmp_path):
    res = port_example("antialias_validation").main(quick=True, device="cpu", blocks=1,
                                                    out_dir=str(tmp_path))
    assert res["alias_db"][4] >= 20.0 and res["alias_db"][2] >= 20.0, res
    assert all(np.isfinite(v) and v > 0 for v in res["ns_per_sample"].values())
    csv_path = port_example("aliasing_plots").main(csv_path=str(tmp_path / "alias.csv"),
                                                   quick=True, device="cpu",
                                                   wav_path=str(tmp_path / "ab.wav"))
    with open(csv_path) as fh:
        rows = list(csv.DictReader(fh))
    assert rows and all(float(r["improvement_db"]) > 6.0 for r in rows)
    check_wav(str(tmp_path / "ab.wav"), 2048, name="aliasing_plots")


def test_scope_example_on_the_port(tmp_path):
    out = port_example("scope").main(out_path=str(tmp_path / "scope.txt"), quick=True,
                                     device="cpu", blocks=BLOCKS)
    text = open(out).read()
    assert "┌" in text and "master" in text and "dB" in text
