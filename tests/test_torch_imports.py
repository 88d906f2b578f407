"""The port imports torch and numpy only: never JAX, never the JAX package.

Each check runs in a fresh interpreter, since this test process has JAX
loaded (tests/conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **kw):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import libgooey_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'libgooey_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'libgooey_tpu' or k.startswith('libgooey_tpu.'))\n"
        "assert len(mods) >= 20, mods\n"
        "new = {'libgooey_tpu_torch.ops.bus_kernels', 'libgooey_tpu_torch.ops.ringbuf',\n"
        "       'libgooey_tpu_torch.effects.saturation', 'libgooey_tpu_torch.effects.lowpass',\n"
        "       'libgooey_tpu_torch.effects.tilt', 'libgooey_tpu_torch.effects.delay',\n"
        "       'libgooey_tpu_torch.effects.chain', 'libgooey_tpu_torch.effects.compressor',\n"
        "       'libgooey_tpu_torch.effects.reverb_spring',\n"
        "       'libgooey_tpu_torch.effects.reverb_plate', 'libgooey_tpu_torch.ops.plate_kernels',\n"
        "       'libgooey_tpu_torch.ops.voice', 'libgooey_tpu_torch.ops.voice_kernels',\n"
        "       'libgooey_tpu_torch.effects.waveshaper',\n"
        "       'libgooey_tpu_torch.effects.feedback_waveshaper',\n"
        "       'libgooey_tpu_torch.mixer', 'libgooey_tpu_torch.mixer.chain',\n"
        "       'libgooey_tpu_torch.ops.grain_kernels', 'libgooey_tpu_torch.instruments.granulator',\n"
        "       'libgooey_tpu_torch.instruments.sampler', 'libgooey_tpu_torch.instruments.hihat',\n"
        "       'libgooey_tpu_torch.instruments.tom', 'libgooey_tpu_torch.instruments.poly',\n"
        "       'libgooey_tpu_torch.engine.lfo', 'libgooey_tpu_torch.music',\n"
        "       'libgooey_tpu_torch.core.blendable', 'libgooey_tpu_torch.io_wav',\n"
        "       'libgooey_tpu_torch.mixer.graph', 'libgooey_tpu_torch.mixer.stereo_buffer',\n"
        "       'libgooey_tpu_torch.mixer.loop_channel', 'libgooey_tpu_torch.mixer.wsola',\n"
        "       'libgooey_tpu_torch.mixer.clip_grid', 'libgooey_tpu_torch.mixer.stream',\n"
        "       'libgooey_tpu_torch.mixer.mixer', 'libgooey_tpu_torch.ops.wsola_search',\n"
        "       'libgooey_tpu_torch.ops.wsola_stream', 'libgooey_tpu_torch.gooey',\n"
        "       'libgooey_tpu_torch.performance', 'libgooey_tpu_torch.engine.output',\n"
        "       'libgooey_tpu_torch.capi', 'libgooey_tpu_torch.dsl', 'libgooey_tpu_torch.midi',\n"
        "       'libgooey_tpu_torch.engine.legacy_sequencer', 'libgooey_tpu_torch.native',\n"
        "       'libgooey_tpu_torch.native.build', 'libgooey_tpu_torch.visualization',\n"
        "       'libgooey_tpu_torch.tui', 'libgooey_tpu_torch.examples',\n"
        "       'libgooey_tpu_torch.parallel', 'libgooey_tpu_torch.parallel.mesh'}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "examples = [m for m in mods if m.startswith('libgooey_tpu_torch.examples.')]\n"
        "assert len(examples) == 29, examples\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_chip_smoke_fails_without_a_card():
    """No CUDA card: exit non-zero and print no result line."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
