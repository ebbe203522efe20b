"""The stream's knee: the highest rate the program sustains, by a sweep over
the number of sensors.

    python3 benchmark/knee.py --workload ntusl20-stream --seed N --seconds 20 --sensors 6 7 8 9 10 11

One process: the cell's set-up, then for each sensor count one open-loop
window of the cell's traffic with that many sensors (the schedule as a run
makes it, its rates spread for a window of `--seconds`). Prints one JSON
line a count: the offered rate, the sweeps due and finished, the p50 and
p95 latency from the due time (an unfinished sweep counts its wait), the
median `detect`, and the mean latency of the first and last quarter of
the sweeps (a growing backlog shows as a last quarter far above the
first). The benchmark's own runs do not run this; its readings are kept
in the mix file.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark.lib import harness, loops, traffic  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="ntusl20-stream")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--sensors", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    return sweep(harness.load_spec(), args.workload, args.seed, args.seconds, args.sensors, "cuda")


def sweep(spec: dict, workload: str, seed: int, seconds: float, sensors: list[int], device: str) -> int:
    torch.set_num_threads(1)
    run = harness.Run(spec, harness.find_cell(spec, workload), seed, seconds, False, device, time.perf_counter())
    kind = loops.Stream()
    kind.setup(run)
    gc.collect()
    gc.freeze()
    for k in sensors:
        mix = dict(run.mix, sensors=k)
        out = kind.drive(run, traffic.stream_schedule(mix, seed, seconds), seconds)
        lat = out["latency_s"]
        q = max(len(lat) // 4, 1)
        print(json.dumps({"sensors": k, "offered_per_s": k * mix["hz"], "due": out["attempted"], "done": out["done"],
                          "p50_ms": statistics.median(lat) * 1e3, "p95_ms": loops.percentile(lat, 95) * 1e3,
                          "service_p50_ms": statistics.median(out["service_s"]) * 1e3,
                          "first_quarter_mean_ms": statistics.mean(lat[:q]) * 1e3,
                          "last_quarter_mean_ms": statistics.mean(lat[-q:]) * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
