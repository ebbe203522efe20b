"""A small benchmark spec for the CPU tests: the cells' loops at a 64x64
grid, with the limits of the configuration they stand for, or with a
configuration's own (the toy family's)."""

from __future__ import annotations

import json
import time
from pathlib import Path

from benchmark.lib import harness

SMALL = "benchmark/tests/small_config.json"
TOY = "benchmark/tests/toy_config.json"
NTUSL = "benchmark/configs/ntusl_20cm.json"


def spec(tmp: Path, limits_of: str | None = NTUSL, config: str = SMALL) -> dict:
    """Cells s.stream and s.offline over `config`, holding also the limits
    of `limits_of` where one is given, written under `tmp`."""
    cfg = json.loads((harness.ROOT / config).read_text())
    if limits_of:
        cfg["compare_limits"].update(json.loads((harness.ROOT / limits_of).read_text())["compare_limits"])
    out = Path(tmp) / "small_config_with_limits.json"
    out.write_text(json.dumps(cfg))
    cells = [("s.stream", "small_stream"), ("s.offline", "small_offline")]
    real = harness.load_spec()
    return {
        "configs": [{"name": "small", "file": str(out)}],
        "workloads": [{"name": n, "config": "small", "traffic": f"../tests/{t}", "chips": 1} for n, t in cells],
        "end_to_end": [dict(m, workloads=[n for n, _ in cells if n.split(".")[1] in
                                          {"detect_ms_mean": "stream",
                                           "frames_per_s": "offline"}.get(m["name"], "stream offline")])
                       for m in real["end_to_end"]],
        "per_layer": [dict(m, workloads=[n for n, _ in cells if m["name"].endswith("." + n.split(".")[1])])
                      for m in real["per_layer"]],
    }


def run(tmp: Path, cell: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False, plant=None,
        limits_of: str | None = NTUSL, config: str = SMALL):
    from benchmark import run as bench_run

    s = spec(tmp, limits_of, config)
    return bench_run.run_cell(s, cell, seed, seconds, trace, device="cpu", t_start=time.perf_counter(), plant=plant)
