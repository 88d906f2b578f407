"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` compiles with its own ``nvcc`` for ``sm_90a``, all
started together, into an object (``csrc/*.cuh`` holds code that several
sources include); one more ``nvcc`` links the objects into
a shared library with a plain C interface (no PyTorch headers, so the build
takes seconds).  The library lands in ``libgooey_tpu_torch/_build/``
(ignored by git) under a name keyed by the sources' hash, so an edited
source rebuilds and a finished build is reused.  Nothing here runs at
import time.
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
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry points and their argument types (pointers, then ints/floats, then
#: the CUDA stream).  Every entry returns cudaGetLastError() as an int.
SIGNATURES = {
    # the staged kernels (and ws4): ..., R, B, rows per block, 16-byte copies
    "affine1_bank_launch": [_P] * 6 + [_I] * 4 + [_P],
    "pink_bank_launch": [_P] * 6 + [_I] * 4 + [_P],
    "svf_bank_launch": [_P] * 10 + [_I] * 4 + [_P],
    "env_follow_bank_launch": [_P] * 5 + [_F, _F] + [_I] * 4 + [_P],
    # u, comp_signed, state in, dc, state out, coefficients, V, B, rc, vec
    "fbws_bank_launch": [_P] * 6 + [_I] * 4 + [_P],
    # x, drive, state in, y, state out, coefficients (+ tanh(0.5)), V, B, rc, vec
    "ws4_bank_launch": [_P] * 6 + [_I] * 4 + [_P],
    "linrec2_bank_launch": [_P] * 12 + [_I] * 4 + [_P],
    # idx, freq, out, 2 pi / sr, nyquist, the taper threshold, terms, V, B
    "triangle_additive_bank_launch": [_P] * 3 + [_F, _F, _F, _I, _I, _I, _P],
    # the engine's mix: voices, four smoother rows, powers, scratch, L, R, mono
    "mix_bank_launch": [_P] * 10 + [_I, _I, _P],
    # the granulator's and the sampler's reads
    "grain_read_cubic_launch": [_P] * 5 + [_I, _I, _I, _P],
    "sampler_read_linear_launch": [_P] * 6 + [_I, _I, _I, _I, _P],
    # the bus kernels: x, y, then per phase (op, flag), ten pointers, 16
    # floats and 16 ints, then the 4x chain's coefficients
    "bus_block_launch": [_P] * 7 + [_I, _P],
    "bus_chain_launch": [_P, _P, _I] + [_P] * 5 + [_I, _P],
    # the plate: its 17 pointers, its constants and lags, DIN, DMOD, B, the chunk
    "plate_block_launch": [_P] * 3 + [_I] * 4 + [_P],
    # the kit kernels: n phases, then per phase (body, V, B), 26 pointers,
    # 24 floats and 8 ints, then the 4x chain's coefficients
    "kit_sources_launch": [_I] + [_P] * 5 + [_P],
    "kit_drive_launch": [_I] + [_P] * 5 + [_P],
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
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgooey_bank_kernels-{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; returns ``[(cmd, returncode, output)]``."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    results = []
    for cmd, p in procs:
        text = p.communicate()[0]
        results.append((cmd, p.returncode, text))
    return results


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    One ``nvcc`` per source runs in parallel, then one links.  The
    compiler's report (``-Xptxas -v``: registers, spills) is kept in
    ``_build/nvcc.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(_sources(), objs)])
    tmp = out.with_suffix(f".{tag}.so")
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
                              *map(str, objs)]])
    (BUILD_DIR / "nvcc.log").write_text(
        "".join(" ".join(cmd) + "\n" + text for cmd, _, text in results))
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [(cmd, rc, text) for cmd, rc, text in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc, text = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
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
