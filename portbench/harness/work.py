"""Roofline arithmetic: the least time the card could take for a kernel
group's work a block, from the group's frozen table (``work/<group>.json``)
and the cell's widths, against the group's device time in the trace.

A launch's least time is the larger of its bytes (each input read once,
each output written once) over the card's memory bandwidth and its
operations over its float32 rate outside the tensor cores; a group's is
the sum over its launches.  A launch's operations and bytes a block grow
linearly with the configuration's scale (``[a, b]``: ``a * s + b``), where
``s`` is the configuration's voices over the table's unit kit; the table
holds them at the block size it was captured at.  Which trace kernels
belong to a group is read from the program's sources: every
``__global__`` function of the group's source files."""

from __future__ import annotations

import re

from portbench.harness.spec import ROOT

#: published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")


def kernel_names(sources) -> set:
    """Names of the ``__global__`` functions in the program's ``sources``
    (paths relative to the checkout)."""
    names = set()
    for src in sources:
        path = ROOT / src
        if path.is_file():
            names.update(_GLOBAL.findall(path.read_text()))
    return names


def port_kernel_names() -> set:
    """Every hand-written kernel of the program (its CUDA sources)."""
    return kernel_names(str(p.relative_to(ROOT))
                        for p in sorted((ROOT / "libgooey_tpu_torch" / "csrc").glob("*.cu*")))


def base_name(trace_name: str) -> str:
    """A trace kernel's function name: ``void walk_lone_kernel<X>(...)`` ->
    ``walk_lone_kernel``."""
    name = trace_name.replace("(anonymous namespace)", "")
    cuts = [i for i in (name.find("("), name.find("<")) if i >= 0]
    head = name[:min(cuts)] if cuts else name
    head = head.strip()
    return head.split()[-1].split("::")[-1] if head else ""


def is_port_op(trace_name: str, names: set) -> bool:
    return base_name(trace_name) in names


def scale_of(cfg: dict, table: dict) -> float:
    """The configuration's voices over the table's unit kit (each family's
    voices over its unit count; the same for every family)."""
    unit = table["unit_voices"]
    scales = {cfg["voices"][k] / unit[k] for k in unit if k in cfg["voices"]}
    if len(scales) != 1 or set(cfg["voices"]) != set(unit):
        raise ValueError(f"{table['group']}: the configuration's voices {cfg['voices']} are not "
                         f"a multiple of the table's unit kit {unit}")
    return scales.pop()


def least_seconds(cfg: dict, table: dict) -> float:
    """The group's least time a block at the configuration's widths."""
    s = scale_of(cfg, table)
    total = 0.0
    for launch in table["launches"]:
        ops = launch["ops"][0] * s + launch["ops"][1]
        nbytes = launch["bytes"][0] * s + launch["bytes"][1]
        total += max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)
    return total


def roofline_pct(ctx, group: str):
    """The group's least time over its device time in the traced stretch,
    in percent; None where the trace holds none of the group's kernels."""
    table = ctx.work(group)
    names = kernel_names(table["sources"])
    device_us = sum(d for n, _s, d in ctx.trace.ops if is_port_op(n, names))
    if device_us <= 0.0:
        return None
    return 100.0 * least_seconds(ctx.config, table) * ctx.trace.blocks / (device_us * 1e-6)


def chain_floor_us(table: dict, block_size: int, clock_hz: float) -> float:
    """The longest carried chain of the group's launches: dependent
    operations a sample at ``cycles_per_op`` cycles each over the block, at
    the card's maximum SM clock."""
    ops = max(launch.get("chain_ops_per_sample", 0) for launch in table["launches"])
    return ops * table["cycles_per_op"] * block_size / clock_hz * 1e6
