"""Build the port's CUDA sources at first use and load them with ctypes.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds).
The library lands in ``libgooey_tpu_torch/_build/`` (ignored by git) under a
name keyed by the sources' hash, so an edited source rebuilds and a
finished build is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # keep a*b + c as two roundings, like the plain PyTorch versions
    "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry points and their argument types (pointers, then ints/floats, then
#: the CUDA stream).  Every entry returns cudaGetLastError() as an int.
SIGNATURES = {
    "affine1_bank_launch": [_P] * 6 + [_I, _I, _P],
    "pink_bank_launch": [_P] * 6 + [_I, _I, _P],
    "svf_bank_launch": [_P] * 10 + [_I, _I, _P],
    "env_follow_bank_launch": [_P] * 5 + [_F, _F, _I, _I, _P],
    "fbws_bank_launch": [_P] * 6 + [_I, _I, _P],
}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgooey_bank_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    The compiler's report (``-Xptxas -v``: registers, spills) is kept in
    ``_build/nvcc.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
