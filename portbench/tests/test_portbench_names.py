"""``BENCHMARK.json`` against the contract's shapes: names, units and
characters; every cell, configuration, traffic mix, metric reader and work
table found by name under ``portbench/``."""

import json
import re

import pytest

from portbench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                  for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])


def test_configs():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert all(k in cfg for k in c["reduced"])


def test_workloads():
    cfgs = {c["name"] for c in BENCH["configs"]}
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in cfgs
        assert (w["config"], w["traffic"]) not in seen and w["chips"] in (1, 4)
        seen.add((w["config"], w["traffic"]))
        assert _line(w["why"])
        spec.traffic(w["traffic"])
    assert {w["config"] for w in BENCH["workloads"]} == cfgs
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert set(m["workloads"]) <= cells if "workloads" in m else True
        spec.reader(m["name"])
        if kind == "end_to_end":
            assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert _line(m["layer"]) and m["moves"] in e2e
            moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))


def test_every_cell_reports_setup_another_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = spec.metrics_of(w["name"], False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert spec.metrics_of(w["name"], True)


def test_work_tables_scale_to_their_configs():
    from portbench.harness import work

    for group in ("bank", "kit", "bus"):
        table = spec.work(group)
        assert work.least_seconds(spec.config(table["config"]), table) > 0.0
        assert work.kernel_names(table["sources"])
