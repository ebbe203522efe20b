"""The benchmark of det3d_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. What the cell needs is found by name (`benchmark/lib/harness.py`):
the configuration file, the detector family it names
(`benchmark/families/<family>.py`: reference, weights, sweeps, comparison,
yardstick), the traffic mix and one reader a metric. Set-up (imports, the kernels' build into the program's cache in
the checkout, weights made on the card from the seed, the frame pool, the
warm-up calls and the graph capture) ends at the first timed call; the
window then runs the cell's traffic for S seconds; with --trace 1 a traced
stretch and an eager stage pass follow. Once the window has closed and the
program's state is freed, sampled answers of the window are compared with
the plain reference. The last line of standard output is the result JSON;
the numbers compared, each beside its limit, are the last lines of
standard error and the last key of the result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unread"
    except (OSError, subprocess.TimeoutExpired):
        return "unread"


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T0, plant=None):
    """One run → (exit code, result dict or None). `plant(run)`, where
    given, breaks the timed path as soon as set-up has made the program's
    detector (the fault tests)."""
    import gc

    import torch

    from benchmark.lib import compare, loops

    # one intra-op thread: the host's copies run on the calling thread; with
    # a pool of them a call sometimes waits milliseconds for its workers on
    # a shared host, which made the stream's latency tail bimodal
    torch.set_num_threads(1)
    cell = harness.find_cell(spec, workload)
    run = harness.Run(spec, cell, seed, seconds, trace, device, t_start)
    run.plant = plant
    kind = loops.KINDS[run.mix["kind"]]()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kind.setup(run)
    gc.collect()
    gc.freeze()   # what set-up made is never collected in the window
    run.setup_s = time.perf_counter() - t_start
    kind.window(run)
    run.peak_bytes = torch.cuda.max_memory_reserved() if cuda else 0
    if trace:
        kind.traced(run)
    gc.unfreeze()
    kind.release(run)
    if cuda:
        run.log(f"card: {card_line()}")
    try:
        compared = kind.check(run)
        correct, shown = harness.verdict(run, compared)
    except compare.BadOutput as e:
        run.log(f"not correct: an output of the program is unusable: {e}")
        correct = False
        shown = {name: {"value": None, "limit": float(v)} for name, v in harness.limits(run).items()}
    metrics = harness.read_metrics(run, "per_layer" if trace else "end_to_end")
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 4, None
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(run.failed),
              "metrics": metrics, "device": dev}
    if trace and getattr(run, "trace_window_s", None):
        dev["busy_s"] = run.trace_busy_s
        dev["window_s"] = run.trace_window_s
        result["breakdown"] = run.breakdown
    result["compared"] = shown
    for name, v in shown.items():
        print(f"compared {name}: {v['value']} (limit {v['limit']})", file=sys.stderr, flush=True)
    return 0, result


def main(argv=None) -> int:
    args = parse(argv)
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"this cell needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 5
    rc, result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace))
    if result is not None:
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
