"""Stage timing and profiling on the port's device.

Counterpart of the JAX package's utils/timing.py (reference: the manual
`time.time()` + `torch.cuda.synchronize()` accumulators in
networks/pointpillars8_shared.py:359-380 and train.py:244-258). PyTorch
returns before the card finishes, so every span ends in
`block_until_ready`: a `torch.cuda.synchronize()` when its value holds a
CUDA tensor, nothing on the CPU. `trace` wraps a block in `torch.profiler`.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree: Any) -> Any:
    """Wait for the card to finish `tree`'s CUDA tensors (any nesting of
    dicts, lists and tuples, NamedTuples included); returns `tree`."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)
    return tree


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2, **kw) -> dict:
    """Median / best / mean wall time of `fn(*args)`, each call waited on."""
    for _ in range(warmup):
        block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return {
        "p50_ms": float(np.median(times) * 1e3),
        "best_ms": float(np.min(times) * 1e3),
        "mean_ms": float(np.mean(times) * 1e3),
    }


class StageTimers:
    """Named span timings (host clock, device-synced): running sums and
    counts, printed as the reference's breakdown line."""

    def __init__(self) -> None:
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, sync: Any = None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            block_until_ready(sync)
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self.total[name] += seconds
        self.count[name] += 1

    def averages(self) -> dict[str, float]:
        return {k: self.total[k] / max(self.count[k], 1) for k in self.total}

    def report(self) -> str:
        return "  ".join(f"{k}: {v * 1e3:.2f}ms" for k, v in self.averages().items())


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """torch.profiler over the block (host, and the card where there is
    one); writes `trace.json` (chrome://tracing, Perfetto) into `log_dir`,
    a fresh temporary directory by default. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir or tempfile.mkdtemp(prefix="det3d-torch-trace-"))
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
