"""The port's per-instrument and effect examples (``libgooey_tpu_torch/
examples/``) on the CPU, with tests/test_examples.py's checks.

Each runs its ``quick`` pass on ``device="cpu"``, cut to ``BLOCKS`` blocks
(``blocks=``: every section in proportion, each at least one block, since
the port's CPU path steps its recurrences sample by sample), and must write
a finite, audible 44.1 kHz WAV of about that length.  The tom and hihat
tours, cheap on both sides, run whole and are pinned to the JAX examples'
WAVs (16-bit) within 1e-4.  The effect and sequencing tours are in
tests/test_torch_examples_effects.py, the host-engine examples in
tests/test_torch_examples_host.py.  Each file runs PyTorch on one thread:
the CPU path is thousands of tiny ops a block, which more threads only
slow when the suite's workers share the cores.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from libgooey_tpu.io_wav import read_wav

BLOCKS = 2
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

QUICK_MODULES = ["kick", "snare", "hihat", "hihat2", "tom", "tom2", "bass"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_example(name):
    return importlib.import_module(f"libgooey_tpu_torch.examples.{name}")


def check_wav(path, min_len, audible=True, name=""):
    audio, sr = read_wav(path)
    assert sr == 44100
    assert audio.shape[-1] >= min_len, (name, audio.shape)
    assert np.all(np.isfinite(audio))
    if audible:
        assert np.abs(audio).max() > 1e-5, name
    return audio


@pytest.mark.parametrize("name", QUICK_MODULES)
def test_quick_example_runs_on_the_port(name, tmp_path):
    out = port_example(name).main(out_path=str(tmp_path / f"{name}.wav"), quick=True,
                                  device="cpu", blocks=BLOCKS)
    check_wav(out, int(0.9 * BLOCKS * 512), name=name)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["tom", "hihat"])
def test_example_wav_matches_jax(name, tmp_path):
    ref = check_wav(_jax_example(name).main(out_path=str(tmp_path / "jax.wav"), quick=True),
                    2048, name=name)
    got = check_wav(port_example(name).main(out_path=str(tmp_path / "port.wav"), quick=True,
                                            device="cpu"), 2048, name=name)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= 1e-4
