"""The port's effect, sequencing and MIDI examples (``libgooey_tpu_torch/
examples/``) on the CPU, with tests/test_examples.py's checks: each runs its
``quick`` pass on ``device="cpu"`` cut to ``BLOCKS`` blocks (every section
in proportion) and must write a finite, audible 44.1 kHz WAV of about that
length (see tests/test_torch_examples_engine.py).
"""

import pytest

from test_torch_examples_engine import check_wav, one_torch_thread, port_example  # noqa: F401

BLOCKS = 2

QUICK_MODULES = ["delay", "reverb", "reverb_lab", "tilt_filter", "lfo_test", "sequencer",
                 "membrane", "midi_drums"]


@pytest.mark.parametrize("name", QUICK_MODULES)
def test_quick_example_runs_on_the_port(name, tmp_path):
    out = port_example(name).main(out_path=str(tmp_path / f"{name}.wav"), quick=True,
                                  device="cpu", blocks=BLOCKS)
    check_wav(out, int(0.9 * BLOCKS * 512), name=name)
