"""Everything by name: the cell's entry in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its metrics' readers (``metrics/<name>.py``) and
the kernel groups' work tables (``work/<name>.json``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _load_json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} "
                                f"({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _load_json("configs", name)


def traffic(name: str) -> dict:
    return _load_json("traffic", name)


def work(name: str) -> dict:
    return _load_json("work", name)


def cell(name: str, bench: dict = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def metrics_of(cell_name: str, trace: bool, bench: dict = None) -> list:
    """The cell's metric entries: its end-to-end ones (``trace`` off) or
    its per-layer ones (``trace`` on), each listed for it or for every
    cell."""
    bench = bench or benchmark()
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric_name!r} "
                                f"({path.relative_to(ROOT)})")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric_name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def mix_rows(cfg: dict):
    """``(pan [V], gain [V], master)`` of a configuration's mixer: ``pan`` a
    number (every voice) or ``[lo, hi]`` (``linspace``), ``gain`` a number
    or ``"1/V"``."""
    mix, nv = cfg["mix"], sum(cfg["voices"].values())
    pan = (np.linspace(mix["pan"][0], mix["pan"][1], nv) if isinstance(mix["pan"], list)
           else np.full(nv, mix["pan"]))
    gain = np.full(nv, 1.0 / nv) if mix["gain"] == "1/V" else np.full(nv, float(mix["gain"]))
    return pan, gain, np.float32(mix["master"])
