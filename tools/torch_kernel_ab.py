#!/usr/bin/env python3
"""A/B of the port's redesigned kernels against other builds of the
kernels, on one CUDA card.

Run from the repository root with one or more directories that hold a
version of ``libgooey_tpu_torch/csrc`` (for example the parent commit's,
unpacked with ``git archive``):

    python3 tools/torch_kernel_ab.py [--only NAME,...] DIR [DIR ...]

Each directory is built as the port builds its own (``ops/_build.py``'s
flags, one nvcc per source) into ``libgooey_tpu_torch/_build/ab_<name>/``
and loaded beside this tree's library; the wrappers launch one or the
other.  A build whose ``pink_bank``, ``svf_bank``, ``ws4_bank``,
``env_follow_bank``, ``plate_block``, ``fbws_bank`` or
``triangle_additive_bank`` entry takes the arguments it took before those
kernels were redesigned (its tree's
``ops/_build.py`` beside the directory says so) is called that way
(:func:`older_args`).  Cases, at the main path's shapes (``chip_smoke.py``'s
inputs): ``pink_bank``, ``svf_bank``, ``ws4_bank``, ``fbws_bank``,
``env_follow_bank``, ``plate_block``, ``mix_bank``,
``triangle_additive_bank``, ``grain_read_cubic`` and ``sampler_read_linear``
at every phase-3 case (the path's shapes, then the tails), ``affine1_bank`` and ``linrec2_bank``
likewise (their staging header is shared),
``kit_sources`` at the product kit, with each of its families alone and at
``chip_smoke.TAIL_KITS`` (its triangle is ``triangle_additive_bank``'s),
``kit_drive`` at the product kit, with each of its bodies alone and at
``chip_smoke.TAIL_KITS``, ``bus_chain`` with
the kit's seven phases, the first four and the product chain's ten, and
each bus phase's own kernel, the spring also at ``chip_smoke.spring_cases``
(22,050 and 96,000 Hz, an unaligned history), and the saturation, the
compressor, the detector, the spring, the two waveshapers, the lowpass,
the delay and the tilt at ``chip_smoke.lone_edge_cases`` (512, 100 and 33
samples, their bypass gates crossed, their smoothers settling and the
tilt's knob crossing the center inside chunks).  Up to ``BUILDS_AT_ONCE`` trees build at once.  Every case prints whether each build gives
this tree's outputs bit for bit, and each build's device time per call
(``chip_smoke.device_ms``), the builds interleaved (each other build, this
tree, this tree, each other build in reverse), on the card named in the
first line, with its maximum SM clock.  A build is named by its tree's
directory (``X/libgooey_tpu_torch/csrc``: X), else by its own.  ``--only``
keeps the cases of the named kernels.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
#: trees built at once (each runs one nvcc a source)
BUILDS_AT_ONCE = 3


def build_name(csrc: Path) -> str:
    """A build's name: its tree's directory, else the directory's own."""
    p = csrc.resolve()
    return p.parent.parent.name if p.parent.name == "libgooey_tpu_torch" else p.name


def build(csrc: Path) -> Path:
    """The library of the sources in ``csrc``."""
    from libgooey_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / f"ab_{build_name(csrc)}"
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


def load(path: Path, sigs: dict):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def signatures(csrc: Path) -> dict:
    """The C entries' argument types of the build in ``csrc``: those of the
    ``ops/_build.py`` of its own tree where it sits in one, else this
    tree's."""
    import importlib.util

    from libgooey_tpu_torch.ops import _build

    path = csrc.resolve().parent / "ops" / "_build.py"
    if not path.is_file():
        return _build.SIGNATURES
    spec = importlib.util.spec_from_file_location(f"_build_of_{abs(hash(str(path)))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.SIGNATURES


def older_args(entry, args, sigs, gain):
    """This tree's arguments of C entry ``entry`` as a build with argument
    types ``sigs`` takes them: before the redesign ``pink_bank_launch``,
    ``svf_bank_launch``, ``env_follow_bank_launch`` and
    ``fbws_bank_launch`` took no rows per block or 16-byte flag,
    ``ws4_bank_launch`` took neither and the drive's ``(d, comp)`` from its
    wrapper instead of the drive (``gain(drive_ptr, V, B)`` gives pointers
    to those two), ``plate_block_launch`` took no chunk, and
    ``triangle_additive_bank_launch`` no taper threshold."""
    from libgooey_tpu_torch.ops import _build

    if len(sigs[entry]) == len(_build.SIGNATURES[entry]):
        return args
    if entry == "pink_bank_launch":
        return args[:8]
    if entry == "svf_bank_launch":
        return args[:12]
    if entry == "env_follow_bank_launch":
        return args[:9]
    if entry == "fbws_bank_launch":
        return args[:8]
    if entry == "plate_block_launch":
        return args[:6]
    if entry == "triangle_additive_bank_launch":
        return args[:5] + args[6:]
    if entry == "ws4_bank_launch":
        x, drive, st_in, y, st_out, coefs, V, B = args[:8]
        return (x, *gain(drive, V, B), st_in, y, st_out, coefs, V, B)
    raise ValueError(f"{entry}: no older form known")


class OlderEntries:
    """A library whose redesigned kernels' entries take their older
    arguments, called with this tree's (see
    :func:`older_args`)."""

    def __init__(self, lib, sigs, drives):
        self.lib, self.sigs, self.drives, self.keep = lib, sigs, drives, []

    def __getattr__(self, entry):
        fn = getattr(self.lib, entry)

        def gain(drive_ptr, V, B):
            from libgooey_tpu_torch.ops import bank_kernels as bk

            self.keep[:] = bk._ws4_gain(self.drives[drive_ptr])
            return tuple(t.data_ptr() for t in self.keep)

        return lambda *a: fn(*older_args(entry, a[:-1], self.sigs, gain), a[-1])


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from libgooey_tpu_torch.ops import _build
    from libgooey_tpu_torch.ops import bus_kernels as bus
    from libgooey_tpu_torch.ops import kernels
    from libgooey_tpu_torch.ops import voice_kernels as vk

    args = list(argv if argv is not None else sys.argv[1:])
    only = None
    if args[:1] == ["--only"] and len(args) > 1:
        only, args = set(args[1].split(",")), args[2:]
    dirs = [Path(d) for d in args]
    if not dirs or not torch.cuda.is_available():
        print(__doc__.strip().splitlines()[0], "\nneeds a CUDA card and a csrc directory",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(cs.card_line(), f"(max SM clock {clock})", flush=True)
    drives = {}   # ws4's drive tensors by pointer, for an older build's wrapper gain
    libs = {}
    with concurrent.futures.ThreadPoolExecutor(BUILDS_AT_ONCE) as pool:
        built = list(pool.map(build, dirs))
    for d, path in zip(dirs, built):
        sigs = signatures(d)
        lib = load(path, sigs)
        libs[build_name(d)] = lib if sigs == _build.SIGNATURES else OlderEntries(lib, sigs, drives)
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
        if only is not None and not any(label.startswith(n) for n in only):
            return
        mine = run("this tree", fn)
        equal = {n: cs.same_bits(run(n, fn), mine) for n in others}
        times = {n: [] for n in libs}
        for n in others + ["this tree", "this tree"] + others[::-1]:
            run(n, fn)
            times[n].append(run(n, lambda: cs.device_ms(fn, 20)))
        text = "; ".join(f"{n} {', '.join('not measured' if t is None else f'{t * 1e3:.1f}' for t in ts)}"
                         for n, ts in times.items())
        print(f"{label}: bit-equal to this tree: {equal}; device us/call: {text}", flush=True)

    for name, shape, args, kw, _ in cs.kernel_cases(dev):
        if name in ("pink_bank", "svf_bank", "ws4_bank", "affine1_bank", "linrec2_bank",
                    "env_follow_bank", "plate_block", "fbws_bank", "mix_bank",
                    "triangle_additive_bank", "grain_read_cubic", "sampler_read_linear"):
            if name == "ws4_bank":
                drives[args[1].data_ptr()] = args[1]
            fn = getattr(kernels.module_of(name), name)
            case(f"{name} {shape}", lambda fn=fn, args=args, kw=kw: fn(*args, **kw))
    sources, drive = cs.kit_phases(dev)
    case(f"kit_sources {cs.kit_label(cs.PRODUCT_KIT, cs.B)}", lambda: vk.kit_sources(sources))
    for ph in sources:
        case(f"kit_sources, {ph.name} alone", lambda ph=ph: vk.kit_sources([ph]))
    case(f"kit_drive {cs.kit_label(cs.PRODUCT_KIT, cs.B)}", lambda: vk.kit_drive(drive))
    for ph in drive:
        case(f"kit_drive, {ph.name} alone", lambda ph=ph: vk.kit_drive([ph]))
    for kit, b in cs.TAIL_KITS:
        src, tail = cs.kit_phases(dev, kit, b)
        case(f"kit_sources {cs.kit_label(kit, b)}", lambda src=src: vk.kit_sources(src))
        case(f"kit_drive {cs.kit_label(kit, b)}", lambda tail=tail: vk.kit_drive(tail))
    singles, runs = cs.bus_cases(dev, np.random.RandomState(cs.SEED), cs.B)
    for label, (x, phases) in list(runs.items())[:3]:
        case(f"bus_chain {label}", lambda x=x, phases=phases: bus.bus_chain(x, phases))
    singles = [(name, shape, args, kw) for name, shape, args, kw, _ in singles]
    singles += [("spring_block", label, args, kw) for label, args, kw in cs.spring_cases(dev)]
    for b in cs.LONE_BLOCKS:
        singles += cs.lone_edge_cases(dev, b)
    for name, shape, args, kw in singles:
        if name in bus.KERNELS:
            case(f"{name} {shape}",
                 lambda name=name, args=args, kw=kw: getattr(bus, name)(*args, **kw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
