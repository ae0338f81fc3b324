"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is found by name, and agrees."""

import importlib.util
import json
import re

import pytest

from conftest import BENCH_DIR, CHECKOUT
from port_bench.lib.harness import Cell, load_module, metric_modules

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert 1 <= len(entry["why"]) <= 200 and not set(entry["why"]) & {"\n", "\t"}
    assert entry["file"] == f"port_bench/configs/{entry['name']}.json"
    data = json.loads((CHECKOUT / entry["file"]).read_text())
    assert data["name"] == entry["name"] and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] == []
    assert len(entry["source"]) <= 200


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and 1 <= len(entry["why"]) <= 200
    cell = Cell.load(entry["name"])
    assert (cell.spec["config"], cell.spec["traffic"]) == (entry["config"], entry["traffic"])
    assert cell.spec["why"] == entry["why"]
    assert (BENCH_DIR / "traffic" / f"{cell.mix['kind']}.py").is_file()
    run_cls = cell.traffic_module().Run
    reported = {m["name"] for m in BENCH["end_to_end"]
                if "workloads" not in m or entry["name"] in m["workloads"]}
    assert reported == set(run_cls.UNITS) | {"setup_s"}
    assert set(cell.spec["limits"]) >= {"det_mismatch", "angle_mismatch"}


def test_metric_entries():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda e: e["name"])
def test_per_layer_metric_found_by_name(entry):
    module = metric_modules()[entry["name"]]
    assert (module.LAYER, module.UNIT, module.MOVES) == (entry["layer"], entry["unit"],
                                                         entry["moves"])
    assert {Cell.load(w).mix["kind"] for w in entry["workloads"]} <= set(module.KINDS)
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == entry["moves"])
    assert set(entry["workloads"]) <= set(moved.get("workloads", entry["workloads"]))


def test_every_metric_file_of_a_benchmarked_kind_is_in_the_benchmark():
    """A reader of a traffic kind no cell of the benchmark runs yet waits for its cell."""
    listed = {m["name"] for m in BENCH["per_layer"]}
    kinds = {Cell.load(w["name"]).mix["kind"] for w in BENCH["workloads"]}
    for name, module in metric_modules().items():
        assert (name in listed) == bool(kinds & set(module.KINDS)), name


def test_cells_in_waiting_are_whole():
    """A workload file outside BENCHMARK.json still names a configuration, a mix and limits."""
    listed = {w["name"] for w in BENCH["workloads"]}
    for path in (BENCH_DIR / "workloads").glob("*.json"):
        cell = Cell.load(path.stem)
        assert cell.spec["name"] == path.stem and cell.spec["limits"]
        assert path.stem in listed or cell.mix["kind"] not in {
            Cell.load(w).mix["kind"] for w in listed}


def test_every_traffic_kind_loads():
    for path in (BENCH_DIR / "traffic").glob("*.py"):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        assert spec is not None
        assert hasattr(load_module(path, "kind_" + path.stem), "Run")
