"""The run's own check of ``sys.modules``: top-level names compared whole,
so the port (``libgooey_tpu_torch``) passes and the JAX package fails;
and a run's imports on the CPU hold none of them."""

import os
import subprocess
import sys

from portbench.harness.main import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_top_level_names_compared_whole():
    assert forbidden_modules({"libgooey_tpu_torch": 1, "libgooey_tpu_torch.ops": 1,
                              "jax_like": 1, "portbench.harness": 1}) == []
    assert forbidden_modules({"libgooey_tpu": 1}) == ["libgooey_tpu"]
    assert forbidden_modules({"libgooey_tpu.core.rng": 1, "jaxlib.xla_client": 1,
                              "flax": 1, "jax": 1}) == ["flax", "jax", "jaxlib.xla_client",
                                                         "libgooey_tpu.core.rng"]


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import torch\n"
            "from portbench.harness import main, program, systems, check, trace\n"
            "from portbench.reference import render\n"
            "import libgooey_tpu_torch.engine.engine, libgooey_tpu_torch.mixer.chain\n"
            "from portbench.harness.main import forbidden_modules\n"
            "bad = forbidden_modules()\n"
            "assert not bad, bad\n"
            "assert 'libgooey_tpu_torch' in sys.modules\n"
            "ref = [m for m in sys.modules if m.startswith('portbench.reference')]\n"
            "print(len(ref))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 3


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib

    for path in pathlib.Path(ROOT, "portbench", "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("libgooey_tpu_torch", "libgooey_tpu", "jax",
                                               "jaxlib", "flax"), (path, n)


def test_no_card_no_result():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "drum_kit_bus7.wide",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
