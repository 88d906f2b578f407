#!/usr/bin/env python3
"""A/B of the port's kit_sources and bus_chain against other builds of the
kernels, on one CUDA card.

Run from the repository root with one or more directories that hold a
version of ``libgooey_tpu_torch/csrc`` (for example the parent commit's,
unpacked with ``git archive``):

    python3 tools/torch_kernel_ab.py DIR [DIR ...]

Each directory is built as the port builds its own (``ops/_build.py``'s
flags, one nvcc per source) into ``libgooey_tpu_torch/_build/ab_<name>/``
and loaded beside this tree's library; the wrappers launch one or the
other.  Cases, at the main path's shapes (``chip_smoke.py``'s inputs):
``kit_sources`` at the product kit and with each of its families alone,
``bus_chain`` with the kit's seven phases, the first four and the product
chain's ten, and each bus phase's own kernel.  Every case prints whether
each build gives this tree's outputs bit for bit, and each build's device
time per call (``chip_smoke.device_ms``), the builds interleaved (each
other build, this tree, this tree, each other build in reverse), on the
card named in the first line.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build(csrc: Path) -> Path:
    """The library of the sources in ``csrc``."""
    from libgooey_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / f"ab_{csrc.resolve().name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, srcs = _build.find_nvcc(), sorted(csrc.glob("*.cu"))
    objs = [out_dir / (s.stem + ".o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    for p in procs:
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed in {csrc}:\n{text}")
    lib = out_dir / "lib.so"
    subprocess.run([nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), *map(str, objs)],
                   check=True)
    return lib


def load(path: Path):
    from libgooey_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(path))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def same_bits(a, b) -> bool:
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from libgooey_tpu_torch.ops import _build
    from libgooey_tpu_torch.ops import bus_kernels as bus
    from libgooey_tpu_torch.ops import voice_kernels as vk

    dirs = [Path(d) for d in (argv if argv is not None else sys.argv[1:])]
    if not dirs or not torch.cuda.is_available():
        print(__doc__.strip().splitlines()[0], "\nneeds a CUDA card and a csrc directory",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    libs = {d.resolve().name: load(build(d)) for d in dirs}
    libs["this tree"] = _build.load_library()
    real_load = _build.load_library
    others = [n for n in libs if n != "this tree"]

    def run(name, fn):
        _build.load_library = lambda: libs[name]
        try:
            out = fn()
            torch.cuda.synchronize()
            return out
        finally:
            _build.load_library = real_load

    def case(label, fn):
        mine = run("this tree", fn)
        equal = {n: same_bits(run(n, fn), mine) for n in others}
        times = {n: [] for n in libs}
        for n in others + ["this tree", "this tree"] + others[::-1]:
            run(n, fn)
            times[n].append(run(n, lambda: cs.device_ms(fn, 20)))
        text = "; ".join(f"{n} {', '.join('not measured' if t is None else f'{t * 1e3:.1f}' for t in ts)}"
                         for n, ts in times.items())
        print(f"{label}: bit-equal to this tree: {equal}; device us/call: {text}", flush=True)

    sources, _ = cs.kit_phases(dev)
    case(cs.kit_label(cs.PRODUCT_KIT, cs.B), lambda: vk.kit_sources(sources))
    for ph in sources:
        case(f"kit_sources, {ph.name} alone", lambda ph=ph: vk.kit_sources([ph]))
    singles, runs = cs.bus_cases(dev, np.random.RandomState(cs.SEED), cs.B)
    for label, (x, phases) in list(runs.items())[:3]:
        case(f"bus_chain {label}", lambda x=x, phases=phases: bus.bus_chain(x, phases))
    for name, shape, args, kw, _ in singles:
        if name in bus.KERNELS:
            case(f"{name} {shape}",
                 lambda name=name, args=args, kw=kw: getattr(bus, name)(*args, **kw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
