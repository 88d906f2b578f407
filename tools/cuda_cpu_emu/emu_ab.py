#!/usr/bin/env python3
"""Two builds of the kit, bus, bank and plate kernels against each other,
bit for bit, on the CPU, before either goes to the card.

    python3 tools/cuda_cpu_emu/emu_ab.py [--only NAME,...] OTHER_CSRC [CSRC]

Builds ``voice_kernels.cu``, ``bus_kernels.cu``, ``bank_kernels.cu``,
``plate_kernels.cu``, ``osc_kernels.cu`` and ``grain_kernels.cu`` of both
source directories (``CSRC`` defaults to this
tree's ``libgooey_tpu_torch/csrc``), with their headers, with g++ against
``cuda_emu.h`` (the CUDA subset, emulated: threads as threads, barriers as
barriers, cp.async as a plain copy) into
``libgooey_tpu_torch/_build/emu_*``, and runs both through the port's own
wrappers' packing on CPU tensors: ``kit_sources`` and ``kit_drive`` at the
product kit, one voice a family, 5/3/7/1/2 voices at 100 and 37 samples and
128 a family; every bus kernel and ``bus_chain`` run of
``chip_smoke.bus_cases`` at 512, 100 and 33 samples, and
``chip_smoke.lone_edge_cases`` (the saturation and the compressor with
their bypass gates crossed inside chunks, the detector with its bypass
span's ends inside chunks, the spring, the waveshaper and the feedback
waveshaper bypassed by mix and by drive, engaged, with +-inf samples, on an
envelope under the makeup's floor; the lowpass with its feedback across 1,
its stages flushed and +-inf samples; the delay with its smoothers settling
inside chunks, its writes flushed, a NaN tap, both ping-pong settings and
an unaligned tap) at the same, and
``chip_smoke.spring_cases`` (the spring at 22,050 and 96,000 Hz and with
its history unaligned); ``plate_block`` at
the main path's block and ``chip_smoke.plate_cases`` (100 and 33 samples,
the modulated lags falling to 1, 22,050 and 96,000 Hz); the staged bank
kernels, ``ws4_bank``, ``fbws_bank`` (rows bypassed for the whole block
and from mid-block on) and ``mix_bank`` (every voice settled, half of them
sweeping, half at the settle snap's edge) at 1, 5, 130 and 515 rows (or
voices) of 512, 100 and 37 samples and with unaligned inputs
(``BANK_SHAPES``), rows per block as on 132 SMs;
``triangle_additive_bank`` at the edge frequencies
(``chip_smoke.triangle_tail_cases``), on the snare's traffic (its first 64
voices, at ``chip_smoke.SNARE_BLOCK``) and at 40-2,000 Hz drawn apart, at
rows of 512, 100 and 37 samples; ``grain_read_cubic`` at
``chip_smoke.grain_tail_cases`` and at 37 grains of 512 and 99 samples with
ages and without; ``sampler_read_linear`` at the main path's 128 voices
and ``chip_smoke.sampler_tail_cases`` (one voice, 130 of 512, 100 and 33
samples, fractional ends, negative and non-finite increments, bases at the
arena's end, ages wrapping).  The tilt's cases are among the lone
kernels' (``chip_smoke.walk_edge_cases``: the knob through the center, a
passthrough span, Q at its top, +-inf in x, x unaligned).  A build
whose entries take the arguments they took before their kernels were
redesigned (its tree's ``ops/_build.py`` says so) is called that way
(``tools/torch_kernel_ab.older_args``).  A restructuring that moves work
between threads but keeps every per-sample operation gives the other
build's bits; exits 1 where it does not.  (The host's libm stands in for
the card's, so these outputs are not the card's; the card compares each
kernel with its plain version.  The bank kernels without a transcendental
and the grain and sampler reads, the detector and the spring are also
held to their plain versions here.)  ``--only``
keeps the cases of the named kernels.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
EMU = Path(__file__).resolve().parent
SOURCES = ("voice_kernels.cu", "bus_kernels.cu", "bank_kernels.cu", "plate_kernels.cu",
           "osc_kernels.cu", "grain_kernels.cu")
#: the bank kernels' (rows, samples) here, and the unaligned case's
BANK_SHAPES = ((1, 512), (5, 100), (130, 512), (515, 100), (515, 37))
BANK_UNALIGNED = (515, 128)
#: the bank kernels whose plain versions give the kernels' bits on the CPU
#: too (no transcendental: the host's libm is not the card's)
BANK_EXACT_ON_CPU = ("affine1_bank", "pink_bank", "svf_bank", "env_follow_bank", "linrec2_bank",
                     "plate_block", "grain_read_cubic", "sampler_read_linear")
#: the bus kernels held to their plain versions here too (the detector
#: passes its signal through: y must be x)
BUS_EXACT_ON_CPU = ("env_follower_block", "spring_block")


def translate(src: str) -> str:
    """CUDA source -> C++ for cuda_emu.h: dynamic shared memory, launches,
    the inline barrier and cp.async."""
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_dyn_smem);", src)
    src = re.sub(r"(\w+(?:<\w+>)?)<<<(.+?)>>>\((.*?)\);",
                 r"emu_launch(\2, [&]() { \1(\3); });", src, flags=re.S)
    src = re.sub(r'asm volatile\("cp\.async\.c[ag]\.shared\.global \[%0\], \[%1\], (\d+);\\n"'
                 r' ::"r"\(s\), "l"\(gmem\)\);', r"emu_cp_async(smem, gmem, \1);", src)
    src = re.sub(r'asm volatile\("cp\.async\.commit_group;\\n" ::\);', "emu_cp_async_commit();",
                 src)
    src = re.sub(r'asm volatile\("cp\.async\.wait_group %0;\\n" ::"n"\([^)]*\)\);',
                 "emu_cp_async_wait();", src)
    return src.replace('asm volatile("bar.sync 0;" ::: "memory");', "__syncthreads();")


def build(csrc: Path, tag: str):
    """``(library, its C entries' argument types)`` of the sources in
    ``csrc``, headers translated beside them."""
    from libgooey_tpu_torch.ops import _build
    from torch_kernel_ab import signatures

    out = _build.BUILD_DIR / f"emu_{tag}"
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (out / header.name).write_text(translate(header.read_text()))
    cpps = []
    for name in SOURCES:
        cpp = out / (Path(name).stem + ".cpp")
        cpp.write_text(translate((csrc / name).read_text()))
        cpps.append(str(cpp))
    lib = out / "lib.so"
    cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
           "-I", str(EMU), "-I", str(out), "-o", str(lib), *cpps, "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"g++ failed on {csrc}:\n{res.stderr[:8000]}")
    handle = ctypes.CDLL(str(lib))
    sigs = signatures(csrc)
    for entry, argtypes in sigs.items():
        if hasattr(handle, entry):
            fn = getattr(handle, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return handle, sigs


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.tanhf.argtypes = [ctypes.c_float]
_LIBM.tanhf.restype = ctypes.c_float


def host_ws4_gain(drive_ptr, V, B):
    """ws4's ``(d, comp)`` of the drive at a host pointer, with the host's
    ``tanhf`` and an IEEE float32 division, as the emulated kernel computes
    them (for a build whose wrapper passes them)."""
    import torch

    from libgooey_tpu_torch.ops import bank_kernels as bk

    drive = np.ctypeslib.as_array((ctypes.c_float * (V * B)).from_address(drive_ptr))
    lo = np.float32(1.0 + 1e-6)
    d = np.where(drive < lo, lo, drive).astype(np.float32)
    th = np.array([_LIBM.tanhf(float(np.float32(0.5) * v)) for v in d], np.float32)
    comp = np.float32(bk._TANH_HALF) / th
    return torch.from_numpy(d.copy()), torch.from_numpy(comp)


def bank_ab_cases(dev, shapes, unaligned_shape):
    """``(label, name, args, kwargs)`` of the staged bank kernels, the split
    ones and mix_bank at each ``(rows, samples)``: affine1_bank with a live
    floor and with none, pink_bank with resets and without, svf_bank with
    resets and without, env_follow_bank with freezes, linrec2_bank's
    resonators, ws4_bank's overdrive, fbws_bank with bypassed rows,
    mix_bank settled, half sweeping and half at the snap's edge; then each
    with every input 4 bytes past a 16-byte boundary."""
    import torch

    import chip_smoke as cs

    rs = np.random.RandomState(3)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def rows(R, B):
        target = np.abs(0.5 * rs.randn(R, B))
        w = 2 * np.pi * rs.uniform(150.0, 350.0, (R, 1)) / cs.SR
        alpha = np.sin(w) / (2 * rs.uniform(1.0, 8.0, (R, 1)))
        keep = np.where(rs.rand(R, B) < 0.01, 0.0, 1.0)
        return [
            ("affine1_bank", (t(target), t(np.where(rs.rand(R, B) < 0.01, 0.0, 0.9995)),
                              t(0.0005 * target), t(np.abs(0.1 * rs.randn(R)))), {}),
            ("affine1_bank", (None, t(rs.uniform(-0.99, 0.99, (R, B))), t(rs.randn(R, B)),
                              t(rs.randn(R))), {}),
            ("pink_bank", *cs.pink_rows(rs, t, R, B)),
            ("pink_bank", *cs.pink_rows(rs, t, R, B, resets=False)),
            ("svf_bank", cs.svf_rows(rs, t, R, B), {}),
            ("svf_bank", cs.svf_rows(rs, t, R, B, resets=False), {}),
            ("env_follow_bank", *cs.env_rows(rs, t, R, B)),
            ("linrec2_bank", (t(2 * np.cos(w) / (1 + alpha) * keep),
                              t(-(1 - alpha) / (1 + alpha) * keep), t(keep),
                              t(np.zeros((R, B))), t(0.002 * rs.randn(R, B)),
                              t(np.zeros((R, B))), t(0.01 * rs.randn(R)),
                              t(0.01 * rs.randn(R))), {}),
            ("ws4_bank", cs.ws4_rows(rs, t, R, B), {}),
            ("fbws_bank", cs.fbws_rows(rs, t, R, B), {}),
            ("mix_bank", *cs.mix_rows(rs, t, R, B)),
            ("mix_bank", *cs.mix_rows(rs, t, R, B, half=True)),
            ("mix_bank", *cs.mix_rows(rs, t, R, B, half=True, edge=True)),
        ]

    cases = [(f"R={R}, B={B}", name, a, kw) for R, B in shapes for name, a, kw in rows(R, B)]
    R, B = unaligned_shape
    cases += [(f"R={R}, B={B}, unaligned", name, cs.unaligned(a), kw)
              for name, a, kw in rows(R, B)]
    return cases


def triangle_ab_cases():
    """``(label, args, kwargs)`` of triangle_additive_bank on CPU tensors:
    chip_smoke's edge cases (0, 1, 64 and 192 harmonics: with the gain
    table and without), the snare's traffic at 512 of its voices, and
    40-2,000 Hz drawn apart at 512, 64, 5 and 3 rows of 512, 512, 100 and 37
    samples (V*B not a multiple of a block's samples)."""
    import torch

    import chip_smoke as cs

    rs = np.random.RandomState(4)
    cases = [(label, a, kw) for label, a, kw in cs.triangle_tail_cases("cpu")]
    snare = cs.snare_triangle_args("cpu", voices=512)
    cases.append(("V=512, the snare's traffic", snare, dict(sample_rate=cs.SR, max_harmonics=64)))
    for V, B in ((512, 512), (64, 512), (5, 100), (3, 37)):
        a = (torch.as_tensor(rs.randint(0, 2 * int(cs.SR), (V, 1)) + np.arange(B)[None, :],
                             dtype=torch.float32),
             torch.as_tensor(rs.uniform(40.0, 2000.0, (V, B)), dtype=torch.float32))
        cases.append((f"V={V}, B={B}, 40-2,000 Hz drawn apart", a,
                      dict(sample_rate=cs.SR, max_harmonics=64)))
    return cases


def grain_ab_cases():
    """``(label, args, kwargs)`` of grain_read_cubic on CPU tensors:
    chip_smoke's tails, 37 grains of 512 and 99 samples on the 4k bench's
    source and 300 of 512 and 1,000 (four samples a thread) with ages
    (steps up to 8, never-spawned lanes) and without."""
    import torch

    import chip_smoke as cs

    rs = np.random.RandomState(5)
    cases = list(cs.grain_tail_cases("cpu"))
    for G, blocks in ((37, (512, 99)), (300, (512, 1000))):
        step = rs.uniform(0.5, 2.0, G) * rs.choice([-1.0, 1.0], G)
        step[::5] = 8.0 * np.sign(step[::5])
        age0 = rs.randint(-512, 60000, G)
        age0[::7] = 2**30
        a = (torch.as_tensor(0.3 * rs.randn(cs.GRAIN_SOURCE), dtype=torch.float32),
             torch.as_tensor(rs.uniform(-300.0, cs.GRAIN_SOURCE + 300.0, G), dtype=torch.float32),
             torch.as_tensor(step, dtype=torch.float32))
        for b in blocks:
            cases.append((f"G={G}, B={b}, ages", a,
                          dict(B=b, age0=torch.as_tensor(age0, dtype=torch.int32))))
            cases.append((f"G={G}, B={b}, age = n", a, dict(B=b)))
    return cases


def sampler_ab_cases():
    """``(label, args, kwargs)`` of sampler_read_linear on CPU tensors: 128
    voices of 512 samples on a 32,768-frame arena as phase 3 draws them,
    then chip_smoke's tails."""
    import torch

    import chip_smoke as cs

    rs = np.random.RandomState(6)
    F, V = cs.ARENA_FRAMES, cs.S_VOICES
    a = (torch.as_tensor(0.3 * rs.randn(F, 2), dtype=torch.float32),
         torch.as_tensor(rs.randint(0, F, V), dtype=torch.int32),
         torch.as_tensor(rs.uniform(2000.0, 30000.0, V) + rs.choice([0.0, 0.25, 0.5], V),
                         dtype=torch.float32),
         torch.as_tensor(rs.randint(-30000, 2 * cs.B, V), dtype=torch.int32),
         torch.as_tensor(rs.uniform(0.5, 2.0, V), dtype=torch.float32), 3 * cs.B)
    return [(f"V={V}, F={F}, B={cs.B}", a, dict(B=cs.B))] + cs.sampler_tail_cases("cpu")


def main(argv=None) -> int:
    import chip_smoke as cs
    from libgooey_tpu_torch.ops import bank_kernels as bk
    from libgooey_tpu_torch.ops import bus_kernels as bus
    from libgooey_tpu_torch.ops import grain_kernels as gk
    from libgooey_tpu_torch.ops import plate_kernels as pk
    from libgooey_tpu_torch.ops import voice_kernels as vk
    from torch_kernel_ab import older_args

    args = list(argv if argv is not None else sys.argv[1:])
    only = None
    if args[:1] == ["--only"] and len(args) > 1:
        only, args = set(args[1].split(",")), args[2:]
    if not 1 <= len(args) <= 2:
        print("usage: emu_ab.py [--only NAME,...] OTHER_CSRC [CSRC]", file=sys.stderr)
        return 2
    dirs = [Path(args[0]), Path(args[1]) if len(args) > 1 else ROOT / "libgooey_tpu_torch/csrc"]
    builds = [build(d, f"{i}_{d.resolve().parent.name}_{d.name}") for i, d in enumerate(dirs)]

    def launcher(lib, sigs):
        keep = []

        def gain(drive_ptr, V, B):
            keep.append(host_ws4_gain(drive_ptr, V, B))
            return tuple(t.data_ptr() for t in keep[-1])

        def launch(name, device, entry, *a):
            rc = getattr(lib, entry)(*older_args(entry, a, sigs, gain), None)
            if rc:
                raise RuntimeError(f"{name}: launch failed with {rc}")
        return launch

    def both(module, fn):
        outs = []
        for lib, sigs in builds:
            module._launch = launcher(lib, sigs)
            outs.append(fn())
        return cs.same_bits(*outs)

    failed = []

    def case(label, ok):
        print(f"{label}: {'bit-equal' if ok else 'DIFFERENT'}", flush=True)
        if not ok:
            failed.append(label)

    def wanted(name):
        return only is None or name in only

    one = dict.fromkeys(cs.PRODUCT_KIT, 1)
    for kit, b in ((cs.PRODUCT_KIT, cs.B), (one, cs.B), (cs.ODD_KIT, 100), (cs.ODD_KIT, 37),
                   (dict.fromkeys(cs.PRODUCT_KIT, 128), cs.B)):
        if not (wanted("kit_sources") or wanted("kit_drive")):
            break
        sources, drive = cs.kit_phases("cpu", kit, b)
        if wanted("kit_sources"):
            case(f"kit_sources {cs.kit_label(kit, b)}", both(
                vk, lambda: vk._launch_kit("kit_sources", "kit_sources_launch", sources,
                                           vk._SOURCE_BODIES)))
        if wanted("kit_drive"):
            case(f"kit_drive {cs.kit_label(kit, b)}", both(
                vk, lambda: vk._launch_kit("kit_drive", "kit_drive_launch", drive,
                                           vk._DRIVE_BODIES)))
    springs = [("spring_block", label, a, kw) for label, a, kw in cs.spring_cases("cpu")]
    for b in (cs.B,) + cs.TAIL_BLOCKS:
        singles, runs = cs.bus_cases("cpu", np.random.RandomState(b), b)
        singles = [(name, shape, a, kw) for name, shape, a, kw, _ in singles]
        if b == cs.B:
            singles += springs
        for name, shape, a, kw in singles + cs.lone_edge_cases("cpu", b):
            if name in bus.KERNELS and wanted(name):
                case(f"{name} {shape}", both(bus, lambda: bus._launch_one(name, a[0], a[1:], kw)))
            if name in BUS_EXACT_ON_CPU and wanted(name):
                bus._launch = launcher(*builds[-1])
                got = bus._launch_one(name, a[0], a[1:], kw)
                if name in bus._PASSES_SIGNAL:   # (y, *outputs): y is x
                    got = got[1:] if cs.same_bits(got[0], a[0]) else (got[0],)
                case(f"{name} {shape} against its plain version",
                     cs.same_bits(got, getattr(bus, name + "_plain")(*a, **kw)))
        for label, (x, phases) in runs.items():
            if wanted("bus_chain"):
                case(f"bus_chain {label}", both(
                    bus, lambda: bus._launch_phases("bus_chain", x, phases, fused=True)))
    # the bank kernels, the plate and the reads on CPU tensors: launch as on
    # a card of 132 SMs (the snare's blocks before its captured launch run
    # on the plain versions, first)
    tri_cases = triangle_ab_cases() if wanted("triangle_additive_bank") else []
    grain_cases = grain_ab_cases() if wanted("grain_read_cubic") else []
    sampler_cases = sampler_ab_cases() if wanted("sampler_read_linear") else []
    bk._on_cuda = pk._on_cuda = lambda name, t: True
    bk._sm_count = lambda index: 132
    cases = [(label, bk, name, a, kw)
             for label, name, a, kw in bank_ab_cases("cpu", BANK_SHAPES, BANK_UNALIGNED)]
    plate = cs.plate_args("cpu", np.random.RandomState(cs.SEED), cs.B)
    cases += [(label, pk, "plate_block", a, kw)
              for label, a, kw in [(cs.plate_label(*plate), *plate)] + cs.plate_cases("cpu")]
    cases += [(label, bk, "triangle_additive_bank", a, kw) for label, a, kw in tri_cases]
    gk._on_cuda = lambda name, t: True
    cases += [(label, gk, "grain_read_cubic", a, kw) for label, a, kw in grain_cases]
    cases += [(label, gk, "sampler_read_linear", a, kw) for label, a, kw in sampler_cases]
    for label, module, name, a, kw in cases:
        if not wanted(name):
            continue
        kern = getattr(module, name)
        case(f"{name} {label}", both(module, lambda: kern(*a, **kw)))
        if name in BANK_EXACT_ON_CPU:
            module._launch = launcher(*builds[-1])
            case(f"{name} {label} against its plain version",
                 cs.same_bits(kern(*a, **kw), getattr(module, name + "_plain")(*a, **kw)))
    print(f"{len(failed)} different" if failed else "all bit-equal")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
