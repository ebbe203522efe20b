"""One run of one cell: the state the loops fill and the metric readers
read, and the result line.

Everything a cell needs is found by name: its entry in `BENCHMARK.json`,
the configuration file it names, the detector family that file names
(`"family"`, `pointpillars` without the key: `benchmark/families/<family>.py`,
which holds the reference, the weights, the comparison and the yardstick
of that architecture), the traffic mix `benchmark/traffic/<traffic>.json`
(whose `kind` picks the loop in `loops.KINDS`), and one reader
`benchmark/metrics/<metric>.py` for each metric, whose `read(run)` returns
the value or None where the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "det3d_tpu")
DEFAULT_FAMILY = "pointpillars"


class Run:
    def __init__(self, spec: dict, cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
        self.spec, self.cell, self.seed, self.seconds, self.trace = spec, cell, seed, seconds, trace
        self.device = device
        self.t_start = t_start
        self.config = next(c for c in spec["configs"] if c["name"] == cell["config"])
        self.config_path = ROOT / self.config["file"]
        self.config_file = json.loads(self.config_path.read_text())
        self.family = family(self.config_file)
        self.mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
        self.plant = None
        self.setup_s = None
        self.attempted = self.failed = 0

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def metrics_for(self, section: str) -> list[dict]:
        return [m for m in self.spec[section] if "workloads" not in m or self.cell["name"] in m["workloads"]]


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def family(config_file: dict):
    """The family module that a configuration file names, imported under
    its dotted path in the checkout."""
    name = config_file.get("family", DEFAULT_FAMILY)
    path = (BENCH / "families" / f"{name}.py").resolve()
    if not path.is_file() or not path.is_relative_to(ROOT):
        raise SystemExit(f"family {name!r}: no family module at {path}")
    return importlib.import_module(".".join(path.relative_to(ROOT).with_suffix("").parts))


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run: Run, section: str) -> dict:
    out = {}
    for m in run.metrics_for(section):
        value = reader(m["name"])(run)
        if value is None:
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def limits(run: Run) -> dict:
    return run.config_file["compare_limits"]


def verdict(run: Run, compared: dict) -> tuple[bool, dict]:
    """Each limit of the configuration beside its number; a limit whose
    number the family did not give fails."""
    lim = limits(run)
    unlimited = sorted(set(compared) - set(lim))
    if unlimited:
        raise SystemExit(f"compared numbers {unlimited} have no limit in {run.config_path}")
    out, ok = {}, True
    for name, limit in lim.items():
        value = compared.get(name)
        out[name] = {"value": None if value is None else float(value), "limit": float(limit)}
        ok &= value is not None and math.isfinite(value) and value <= limit
    return ok, out
