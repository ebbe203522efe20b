"""Traffic: the one generator that every mix file feeds.

A mix is a JSON file `benchmark/traffic/<name>.json` of parameters; its
`kind` names the loop that drives it (`benchmark/lib/loops.py`). Frames are
made on the host from the seed, with the same set of sizes for every seed,
in a seed-drawn order, so that a seed changes which points a sweep holds
and not how much work the run does. A stream's sensors run at slightly
different rates, which sweep each sensor's phase against the others'
through the window: every run sees the alignments of unsynchronised
sensors, bursts included. Their phases and rates are the mix's, and the
seed picks where in their cycle of alignments the window starts, so every
seed meets the same bursts in another order. What one sweep
holds, its points and their features, is the configuration's family's
(`benchmark/families/<family>.py`: `point_cloud`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose of one run: any whole-number seed."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([seed % 2**64, *stream])))


def sizes(mix: dict, count: int, seed: int) -> np.ndarray:
    """`count` point counts evenly over the mix's [lo, hi], in a seed-drawn order."""
    lo, hi = mix["points"]
    return rng(seed, 1).permutation(np.linspace(lo, hi, count).round().astype(np.int64))


def cloud_pool(mix: dict, seed: int, cloud: Callable[[int, np.random.Generator], np.ndarray]) -> list[np.ndarray]:
    """The mix's pool of sweeps for this seed, each made by `cloud(n, rng)`."""
    return [cloud(int(n), rng(seed, 2, i)) for i, n in enumerate(sizes(mix, mix["pool"], seed))]


def stream_schedule(mix: dict, seed: int, seconds: float, beat_s: float | None = None) -> list[tuple[float, int, int]]:
    """Every sweep due in [0, seconds): (due s, sensor, pool frame), in due
    order. The sensors' pattern is the mix's, the same for every seed: each
    phase uniform over one nominal period and each spin rate `hz` times
    (1 + e), the offsets e evenly spaced and handed to the sensors in an
    order, all drawn from the mix's `pattern_seed`; one step apart is
    `beat_cycles` relative turns in `beat_s` seconds (the run's window).
    Every pair of sensors then passes through every relative phase a whole
    number of times in the window, and the relative phases repeat every
    `beat_s / beat_cycles` seconds, so the seed picks only where in that
    cycle the window starts: every seed meets the same alignments, bursts
    included, in another order. Sensor s's j-th sweep in the window is pool
    frame (s + j * sensors) mod pool."""
    k, hz, pool = mix["sensors"], mix["hz"], mix["pool"]
    cycle = (beat_s or seconds) / mix["beat_cycles"]
    r = rng(mix["pattern_seed"], 3)
    phases = r.uniform(0.0, 1.0 / hz, k)
    step = 1.0 / (cycle * hz)
    periods = 1.0 / (hz * (1.0 + (r.permutation(k) - (k - 1) / 2) * step))
    phases = np.mod(phases - rng(seed, 3).uniform(0.0, cycle), periods)
    out = []
    for s in range(k):
        j = 0
        while phases[s] + j * periods[s] < seconds:
            out.append((float(phases[s] + j * periods[s]), s, (s + j * k) % pool))
            j += 1
    out.sort()
    return out
