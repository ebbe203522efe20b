"""Whole runs of the cells' loops on the CPU at a 64x64 grid: the result
line's keys, the JAX check by whole top-level names, and `correct` false
under each fault a cell can have, planted in the timed path."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.lib import harness
from benchmark.tests import cells

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["s.stream", "s.offline"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_holds_the_contract_keys(tmp_path, cell, trace):
    rc, result = cells.run(tmp_path, cell, seconds=0.5, trace=trace)
    assert rc == 0
    assert list(result) == KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert result["correct"] is True
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    expected = cells.spec(tmp_path)
    section = "per_layer" if trace else "end_to_end"
    assert set(result["metrics"]) <= {m["name"] for m in expected[section]}
    if not trace:
        assert "setup_s" in result["metrics"]
    assert all(set(v) == {"value", "limit"} for v in result["compared"].values())


@pytest.mark.parametrize("cell,fault", [("s.stream", "answer_altered"), ("s.offline", "answer_altered"),
                                        ("s.offline", "half_batch_empty")])
def test_fault_makes_the_run_not_correct(tmp_path, cell, fault):
    plant = control.FAULTS[cell.split(".")[1]][fault]
    rc, result = cells.run(tmp_path, cell, seconds=0.3, plant=lambda run: plant(run.det))
    assert rc == 0 and result["correct"] is False


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "det3d_tpu_torch_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "det3d_tpu.pipeline", object())
    assert harness.forbidden_modules() == ["det3d_tpu.pipeline"]


YARDSTICK = sorted({*(str(p.relative_to(harness.BENCH)) for d in ("families", "reference")
                      for p in (harness.BENCH / d).glob("*.py")),
                    "tests/toy_family.py", "lib/compare.py", "lib/counts.py", "lib/traffic.py", "lib/weights.py"})


@pytest.mark.parametrize("rel", YARDSTICK)
def test_reference_and_yardstick_import_nothing_of_the_program(rel):
    tree = ast.parse((harness.BENCH / rel).read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "flax", "det3d_tpu", "det3d_tpu_torch"}, rel


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, json, time; sys.path.insert(0, '.');"
            "from benchmark.tests import cells; from pathlib import Path;"
            f"rc, r = cells.run(Path({str(tmp_path)!r}), 's.stream', seconds=0.3);"
            "from benchmark.lib import harness; print(json.dumps([rc, harness.forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    rc, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0 and bad == []


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark: the run
    exits with another code than 0 and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ntusl20-stream", "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.gpu
def test_stream_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ntusl20-stream", "--seed",
                          str(2**31 + 99), "--seconds", "2"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=600)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and result["correct"] is True and np.isfinite(result["compared"]["det_gap"]["value"])
