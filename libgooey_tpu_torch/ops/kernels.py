"""Every hand-written kernel of the port by name: the voice banks' and the
engine mix's (:mod:`ops.bank_kernels`), the bus's (:mod:`ops.bus_kernels`),
the plate's (:mod:`ops.plate_kernels`), the kit's (:mod:`ops.voice_kernels`)
and the granulator's and sampler's reads (:mod:`ops.grain_kernels`), with
their launch counts."""

from __future__ import annotations

from libgooey_tpu_torch.ops import (
    bank_kernels,
    bus_kernels,
    grain_kernels,
    plate_kernels,
    voice_kernels,
)

MODULES = (bank_kernels, bus_kernels, plate_kernels, voice_kernels, grain_kernels)
KERNELS = sum((mod.KERNELS for mod in MODULES), ())

#: the wrappers as imported, so that the counts survive a caller swapping a
#: module attribute for the plain version
_WRAPPERS = {name: getattr(mod, name) for mod in MODULES for name in mod.KERNELS}


def module_of(name: str):
    """The module that holds kernel ``name``'s wrapper, plain version,
    ``SOURCES`` and ``REPLACES`` entries."""
    return next(mod for mod in MODULES if name in mod.KERNELS)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts():
    for fn in _WRAPPERS.values():
        fn.launches = 0
