"""Everything a cell needs is found by name from BENCHMARK.json, and
BENCHMARK.json keeps to the benchmark's schema."""

import importlib
import json
import re

import pytest

from port_bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"][1] == "port_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH, indent=2)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = harness.load("workloads", cell)
    assert w["name"] == cell and w["config"] == entry["config"]
    assert w["traffic"]["name"] == entry["traffic"] and w["chips"] == entry["chips"] == 1
    cfg = harness.load("configs", w["config"])
    importlib.import_module(f"port_bench.entries.{cfg['entry']}")
    importlib.import_module(f"port_bench.inputs.{cfg['inputs']}")
    importlib.import_module(f"port_bench.work.{cfg['entry']}")
    assert set(w["limits"]) >= {"choice_gap", "effect_gap", "records_gap"}
    assert float(w["iters_per_second"]) > 0   # the window's fixed iteration count
    e2e, per_layer = harness.cell_metrics(BENCH, cell)
    assert {"setup_s", "iter_ms"} <= {m["name"] for m in e2e}
    assert per_layer


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    cfg = json.loads(open(harness.ROOT / config["file"]).read())
    assert cfg["name"] == config["name"] and cfg["reduced"] == config["reduced"]
    assert config["file"] == f"port_bench/configs/{config['name']}.json"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_found_by_name(metric):
    assert callable(harness.metric_reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) for m in metrics)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
