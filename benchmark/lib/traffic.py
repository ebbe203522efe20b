"""Traffic: the one generator that every mix file feeds.

A mix is a JSON file `benchmark/traffic/<name>.json` of parameters; its
`kind` names the loop that drives it (`benchmark/lib/loops.py`). Frames are
made on the host from the seed, with the same set of sizes for every seed,
in a seed-drawn order, so that a seed changes which points a sweep holds
and not how much work the run does. A stream's sensors take their phases
from the seed and run at slightly different rates, which sweep each
sensor's phase against the others' through the window: every run sees the
alignments of unsynchronised sensors, bursts included.

`cloud` is a frozen copy of the program's synthetic generator
(`det3d_tpu_torch/data/synthetic.py`: `synthetic_cloud`), drawn from
numpy's PCG64 so that any whole-number seed works.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose of one run: any whole-number seed."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([seed % 2**64, *stream])))


def cloud(n: int, r: np.random.Generator) -> np.ndarray:
    """An n-point LiDAR-like sweep (N, 4): range-decayed radial density, a
    ground plane and scattered verticals."""
    pts = np.zeros((n, 4), np.float32)
    dist = np.abs(r.standard_normal(n)) * 25.0 + 2.0
    theta = r.uniform(-np.pi, np.pi, n)
    pts[:, 0] = dist * np.cos(theta)
    pts[:, 1] = dist * np.sin(theta)
    pts[:, 2] = np.where(r.random(n) < 0.7, r.uniform(-2.0, -1.5, n), r.uniform(-1.5, 4.0, n))
    pts[:, 3] = r.uniform(0, 1, n)
    return pts


def sizes(mix: dict, count: int, seed: int) -> np.ndarray:
    """`count` point counts evenly over the mix's [lo, hi], in a seed-drawn order."""
    lo, hi = mix["points"]
    return rng(seed, 1).permutation(np.linspace(lo, hi, count).round().astype(np.int64))


def cloud_pool(mix: dict, seed: int) -> list[np.ndarray]:
    """The mix's pool of sweeps for this seed."""
    return [cloud(int(n), rng(seed, 2, i)) for i, n in enumerate(sizes(mix, mix["pool"], seed))]


def stream_schedule(mix: dict, seed: int, seconds: float, beat_s: float | None = None) -> list[tuple[float, int, int]]:
    """Every sweep due in [0, seconds): (due s, sensor, pool frame), in due
    order. Each sensor's phase is uniform over one nominal period, drawn
    from the seed; its spin rate is `hz` times (1 + e), the offsets e
    evenly spaced and handed to the sensors in a seed-drawn order, one step
    apart being `beat_cycles` relative turns in `beat_s` seconds (the run's
    window): every pair of sensors then passes through every relative phase
    a whole number of times in the window, whatever the seed. Sensor s's
    j-th sweep is pool frame (s + j * sensors) mod pool."""
    k, hz, pool = mix["sensors"], mix["hz"], mix["pool"]
    r = rng(seed, 3)
    phases = r.uniform(0.0, 1.0 / hz, k)
    step = mix["beat_cycles"] / ((beat_s or seconds) * hz)
    periods = 1.0 / (hz * (1.0 + (r.permutation(k) - (k - 1) / 2) * step))
    out = []
    for s in range(k):
        j = 0
        while phases[s] + j * periods[s] < seconds:
            out.append((float(phases[s] + j * periods[s]), s, (s + j * k) % pool))
            j += 1
    out.sort()
    return out
