"""One run of one cell: set-up, warm-up, the measured window, the checks,
the metrics, and the result's line.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  The last line of standard
output is one JSON object: ``correct``, ``attempted`` (blocks rendered in
the window), ``failed`` (of them, blocks whose stereo is not finite),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit.  The same numbers are the
last lines of standard error.  Without a CUDA card, or with fewer than the
cell asks for, it prints no result and exits 2; where ``jax``, ``jaxlib``,
``flax`` or ``libgooey_tpu`` is loaded once the window has closed, it exits
3."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass

from portbench.harness import check, spec, systems, trace as trace_mod, work
from portbench.harness.traffic import EventTable
from portbench.harness.window import run_window, warm_up

#: top-level module names that no run may hold (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "libgooey_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def log(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


@dataclass
class Ctx:
    """What a metric's reader reads."""
    cell: dict
    config: dict
    traffic: dict
    window: object
    trace: object
    port_kernels: set

    @staticmethod
    def work(name: str) -> dict:
        return spec.work(name)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, *,
             system: str = "program", overrides: dict = None):
    """Everything but the look for a card: returns the result's dict.
    ``overrides``: ``{"config": {...}, "traffic": {...}}`` merged into the
    cell's files (the harness's tests run small cells on the CPU)."""
    import torch

    bench = spec.benchmark()
    cell = spec.cell(workload, bench)
    overrides = overrides or {}
    cfg = _merge(spec.config(cell["config"]), overrides.get("config"))
    mix = _merge(spec.traffic(cell["traffic"]), overrides.get("traffic"))
    log(f"{workload}: {sum(cfg['voices'].values())} voices, B = {cfg['block_size']}, "
        f"seed {seed}, {seconds} s, trace {int(trace)}, {system}")
    table = EventTable(cfg, mix, seed)
    sut = systems.make(system, cfg, device)
    warm_up(sut, table, mix, device)
    # a cell whose end-to-end metrics come from the device's trace is traced
    # in every run; only --trace 1 reports the per-layer metrics
    traced = trace or any(m["source"] == "device_trace"
                          for m in spec.metrics_of(workload, False, bench))
    window = run_window(sut, table, mix, seconds=seconds, seed=seed, trace=traced,
                        device=device, setup_clock=process_age_s)
    is_cuda = device.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if is_cuda else 0
    del sut
    if is_cuda:
        torch.cuda.empty_cache()
    log(f"window: {window.blocks} blocks in {window.seconds:.3f} s, set-up {window.setup_s:.2f} s, "
        f"steps at {window.step_blocks}, peak {peak} bytes")
    log(f"host ms a block by stretches of 64 enqueued blocks: {_stretches(window.ends, 64)}")
    t0 = time.perf_counter()
    numbers = check.judge(window, table, cfg)
    log(f"checks: {time.perf_counter() - t0:.1f} s; worst at {numbers.pop('where')}")
    ctx = Ctx(cell=cell, config=cfg, traffic=mix, window=window, trace=window.trace,
              port_kernels=work.port_kernel_names())
    metrics = {}
    for m in spec.metrics_of(workload, trace, bench):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if is_cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": check.is_correct(numbers, cfg["limits"]), "attempted": window.blocks,
              "failed": window.nonfinite_blocks, "metrics": metrics, "device": dev}
    if trace and window.trace is not None:
        dev["busy_s"] = window.trace.busy_us * 1e-6
        dev["window_s"] = window.trace.window_us * 1e-6
        result["breakdown"] = trace_mod.breakdown(window.trace)
    result["checks"] = {k: {"value": _finite(numbers[k]), "limit": lim}
                        for k, lim in cfg["limits"].items()}
    return result


def _stretches(ends, n):
    """Min, median and max of the host's ms a block over consecutive
    stretches of ``n`` blocks (a stall shows as one slow stretch, a slow
    host as all of them)."""
    ms = sorted(1e3 * (ends[k + n] - ends[k]) / n for k in range(0, len(ends) - n, n))
    return [round(ms[0], 2), round(ms[len(ms) // 2], 2), round(ms[-1], 2)] if ms else []


def _finite(x):
    """A number the result's JSON can hold: an infinity or a NaN reads as
    the largest float."""
    return x if math.isfinite(x) else sys.float_info.max


def _card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def _notes(result: dict, workload: str, card: str):
    """Lines printed before the checks: the real-time limit beside a block
    time, the bus chain floor beside its roofline."""
    cfg = spec.config(spec.cell(workload)["config"])
    m = result["metrics"]
    if "block_ms_p95" in m and "real_time_limit_ms" in cfg:
        log(f"block_ms_p95 {m['block_ms_p95']['value']!r} ms against the real-time limit "
            f"{cfg['real_time_limit_ms']} ms")
    if "bus_roofline_pct" in m:
        try:
            clock_hz = float(card.split(",")[2].split()[0]) * 1e6
            log(f"bus_chain chain floor {work.chain_floor_us(spec.work('bus'), cfg['block_size'], clock_hz)!r}"
                f" us a block at {clock_hz / 1e6:.0f} MHz")
        except (IndexError, ValueError):
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = int(spec.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda:0")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    card = _card_line()
    log(f"card: {card}")
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}: no result")
        return 3
    _notes(result, args.workload, card)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
