"""Build the port's C shim and its C smoke test.

    python -m libgooey_tpu_torch.native.build [OUT_DIR]

compiles ``libgooey_tpu_torch/native/gooey_shim.cpp`` (the interpreter
boot, GIL discipline and error latch, importing ``libgooey_tpu_torch.capi``)
with the generated scalar wrappers ``native/gooey_shim_gen.cpp`` and the C
ABI headers under ``include/`` into ``OUT_DIR/libgooey_tpu_torch_shim.so``
(default ``libgooey_tpu_torch/_build/shim``), and ``native/test_shim.c``
against it into ``OUT_DIR/test_shim``.  Needs ``g++``, ``gcc`` and
``python3-config`` (``--embed`` where it has it).

A host that embeds the shim runs the interpreter ``python3-config`` names,
which need not see the packages of the one running this module:
``embed_env`` puts the repository root and this interpreter's
site-packages on ``PYTHONPATH``.
"""

from __future__ import annotations

import os
import shutil
import site
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
NATIVE = REPO / "native"
INCLUDE = REPO / "include"
SHIM_CORE = Path(__file__).resolve().parent / "gooey_shim.cpp"
DEFAULT_OUT = REPO / "libgooey_tpu_torch" / "_build" / "shim"
LIB_NAME = "libgooey_tpu_torch_shim.so"
SMOKE_NAME = "test_shim"


def toolchain_missing():
    """The first tool the build needs and cannot find, or None."""
    for tool in ("g++", "gcc", "python3-config"):
        if shutil.which(tool) is None:
            return tool
    return None


def _python_flags():
    cfg = shutil.which("python3-config")
    if cfg is None:
        raise RuntimeError("python3-config not found: the shim embeds CPython")

    def ask(*args):
        res = subprocess.run([cfg, *args], capture_output=True, text=True)
        return res.stdout.split() if res.returncode == 0 else None

    includes = ask("--includes")
    ldflags = ask("--embed", "--ldflags") or ask("--ldflags")
    if includes is None or ldflags is None:
        raise RuntimeError(f"{cfg} gave no compile or link flags")
    return includes, ldflags


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(map(str, cmd))} failed:\n{res.stderr[-4000:]}")


def build(out_dir=None) -> Path:
    """Compile the shim and the smoke test into ``out_dir``; returns it."""
    out = Path(out_dir) if out_dir is not None else DEFAULT_OUT
    out.mkdir(parents=True, exist_ok=True)
    includes, ldflags = _python_flags()
    lib = out / LIB_NAME
    _run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-Wall", f"-I{INCLUDE}",
          f"-I{NATIVE}", *includes, str(SHIM_CORE), str(NATIVE / "gooey_shim_gen.cpp"),
          *ldflags, "-o", str(lib)])
    _run(["gcc", "-O2", "-std=c11", "-Wall", f"-I{INCLUDE}", str(NATIVE / "test_shim.c"),
          f"-L{out}", f"-l:{LIB_NAME}", f"-Wl,-rpath,{out.resolve()}", "-lm",
          "-o", str(out / SMOKE_NAME)])
    return out


def embed_env(base=None) -> dict:
    """``base`` (default: this process's environment) with the repository
    root and this interpreter's site-packages first on ``PYTHONPATH``."""
    env = dict(os.environ if base is None else base)
    paths = [str(REPO), *site.getsitepackages()]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


if __name__ == "__main__":
    print(build(sys.argv[1] if len(sys.argv) > 1 else None))
