#!/usr/bin/env python3
"""Two builds of the kit and bus kernels against each other, bit for bit, on
the CPU, before either goes to the card.

    python3 tools/cuda_cpu_emu/emu_ab.py OTHER_CSRC [CSRC]

Builds ``voice_kernels.cu`` and ``bus_kernels.cu`` of both source
directories (``CSRC`` defaults to this tree's ``libgooey_tpu_torch/csrc``)
with g++ against ``cuda_emu.h`` (the CUDA subset, emulated: threads as
threads, barriers as barriers) into ``libgooey_tpu_torch/_build/emu_*``,
and runs both through the port's own wrappers' packing on CPU tensors:
``kit_sources`` and ``kit_drive`` at the product kit, one voice a family,
5/3/7/1/2 voices at 100 and 37 samples and 128 a family; every bus kernel
and ``bus_chain`` run of ``chip_smoke.bus_cases`` at 512, 100 and 33
samples.  A restructuring that moves work between threads but keeps every
per-sample operation gives the other build's bits; exits 1 where it does
not.  (The host's libm stands in for the card's, so these outputs are not
the card's; the card compares each kernel with its plain version.)
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
EMU = Path(__file__).resolve().parent
SOURCES = ("voice_kernels.cu", "bus_kernels.cu")


def translate(src: str) -> str:
    """CUDA source -> C++ for cuda_emu.h: dynamic shared memory, launches and
    the inline barrier."""
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_dyn_smem);", src)
    src = re.sub(r"(\w+(?:<\w+>)?)<<<(.+?)>>>\((.*?)\);",
                 r"emu_launch(\2, [&]() { \1(\3); });", src)
    return src.replace('asm volatile("bar.sync 0;" ::: "memory");', "__syncthreads();")


def build(csrc: Path, tag: str) -> ctypes.CDLL:
    from libgooey_tpu_torch.ops import _build

    out = _build.BUILD_DIR / f"emu_{tag}"
    out.mkdir(parents=True, exist_ok=True)
    cpps = []
    for name in SOURCES:
        cpp = out / (Path(name).stem + ".cpp")
        cpp.write_text(translate((csrc / name).read_text()))
        cpps.append(str(cpp))
    lib = out / "lib.so"
    cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
           "-I", str(EMU), "-I", str(csrc), "-o", str(lib), *cpps, "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"g++ failed on {csrc}:\n{res.stderr[:8000]}")
    handle = ctypes.CDLL(str(lib))
    for entry, argtypes in _build.SIGNATURES.items():
        if hasattr(handle, entry):
            fn = getattr(handle, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return handle


def same_bits(a, b) -> bool:
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def main(argv=None) -> int:
    import chip_smoke as cs
    from libgooey_tpu_torch.ops import bus_kernels as bus
    from libgooey_tpu_torch.ops import voice_kernels as vk

    args = argv if argv is not None else sys.argv[1:]
    if not 1 <= len(args) <= 2:
        print("usage: emu_ab.py OTHER_CSRC [CSRC]", file=sys.stderr)
        return 2
    dirs = [Path(args[0]), Path(args[1]) if len(args) > 1 else ROOT / "libgooey_tpu_torch/csrc"]
    libs = [build(d, f"{i}_{d.resolve().parent.name}_{d.name}") for i, d in enumerate(dirs)]

    def launcher(lib):
        def launch(name, device, entry, *a):
            rc = getattr(lib, entry)(*a, None)
            if rc:
                raise RuntimeError(f"{name}: launch failed with {rc}")
        return launch

    def both(module, fn):
        outs = []
        for lib in libs:
            module._launch = launcher(lib)
            outs.append(fn())
        return same_bits(*outs)

    failed = []

    def case(label, ok):
        print(f"{label}: {'bit-equal' if ok else 'DIFFERENT'}", flush=True)
        if not ok:
            failed.append(label)

    one = dict.fromkeys(cs.PRODUCT_KIT, 1)
    for kit, b in ((cs.PRODUCT_KIT, cs.B), (one, cs.B), (cs.ODD_KIT, 100), (cs.ODD_KIT, 37),
                   (dict.fromkeys(cs.PRODUCT_KIT, 128), cs.B)):
        sources, drive = cs.kit_phases("cpu", kit, b)
        case(f"kit_sources {cs.kit_label(kit, b)}", both(
            vk, lambda: vk._launch_kit("kit_sources", "kit_sources_launch", sources,
                                       vk._SOURCE_BODIES)))
        case(f"kit_drive {cs.kit_label(kit, b)}", both(
            vk, lambda: vk._launch_kit("kit_drive", "kit_drive_launch", drive,
                                       vk._DRIVE_BODIES)))
    for b in (cs.B,) + cs.TAIL_BLOCKS:
        singles, runs = cs.bus_cases("cpu", np.random.RandomState(b), b)
        for name, shape, a, kw, _ in singles:
            if name in bus.KERNELS:
                case(f"{name} {shape}", both(bus, lambda: bus._launch_one(name, a[0], a[1:], kw)))
        for label, (x, phases) in runs.items():
            case(f"bus_chain {label}", both(
                bus, lambda: bus._launch_phases("bus_chain", x, phases, fused=True)))
    print(f"{len(failed)} different" if failed else "all bit-equal")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
