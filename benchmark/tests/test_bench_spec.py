"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and metric found by name."""

from __future__ import annotations

import importlib.util
import json
import re

import pytest

from benchmark.lib import harness, loops

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ALL_METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    s = SPEC["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith("benchmark/configs/")
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert entry["reduced"] == []
    assert "compare_limits" in cfg
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    mix = json.loads((harness.BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    assert mix["kind"] in loops.KINDS
    assert any(c["name"] == cell["config"] for c in SPEC["configs"])
    names = [m["name"] for m in ALL_METRICS if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in names
    assert sum(1 for m in SPEC["end_to_end"] if m["name"] in names) >= 2
    assert sum(1 for m in SPEC["per_layer"] if m["name"] in names) >= 1


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    path = harness.BENCH / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    for w in metric.get("workloads", []):
        assert any(c["name"] == w for c in SPEC["workloads"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_entry(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_entry(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    for w in metric["workloads"]:
        assert "workloads" not in moved or w in moved["workloads"]
    if metric["name"].split(".")[0].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_setup_bound_and_unique_names():
    assert next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    for group in (SPEC["configs"], SPEC["workloads"], ALL_METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    assert len(json.dumps(SPEC)) < 64 * 1024
