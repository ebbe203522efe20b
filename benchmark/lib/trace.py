"""Device traces: `torch.profiler` over a stretch of the run, read back from
its Chrome trace (device kernels, copies and sets with their start and
length on the host's clock; the benchmark's own `record_function` ranges
on the CPU timeline).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (start us, end us, name)
    ranges: list = field(default_factory=list)   # (start us, end us, name): the benchmark's ranges


@contextlib.contextmanager
def profiled():
    """Profile the block; yields a Trace that is filled when the block ends."""
    out = Trace()
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield out
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                out.device.append((start, end, e.get("name", "")))
            elif e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("bench."):
                out.ranges.append((start, end, e["name"]))
        out.device.sort()
        out.ranges.sort()


def merged(intervals):
    """Union of (start, end, ...) intervals → sorted disjoint (start, end)."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi), *rest) for s, e, *rest in intervals if e > lo and s < hi]


def busy_us(intervals) -> float:
    return sum(e - s for s, e in merged(intervals))


def window(tr: Trace, name: str):
    """(start, end) of the benchmark range `name` (the first, or None)."""
    for s, e, n in tr.ranges:
        if n == name:
            return s, e
    return None


def device_in(tr: Trace, lo: float, hi: float):
    return clip(tr.device, lo, hi)


def top_ops(device, n: int = 10):
    """The device operations that took most time: [[name, seconds], ...]."""
    total: dict[str, float] = {}
    for s, e, name in device:
        total[name] = total.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, lo: float, hi: float, n: int = 10):
    """Idle time of the device in [lo, hi], summed by what the host was
    doing meanwhile: each stretch of a gap goes to the innermost benchmark
    range open then (the one that began last), or to `bench.other`."""
    busy = merged(device_in(tr, lo, hi))
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    inner = sorted(r for r in tr.ranges if r[2] != "bench.window")
    starts = [r[0] for r in inner]
    edges = sorted(t for r in inner for t in r[:2])

    def open_at(t: float) -> str:
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if inner[i][1] > t:
                return inner[i][2]
        return "bench.other"

    by: dict[str, float] = {}
    for s, e in gaps:
        cuts = [s] + edges[bisect.bisect_right(edges, s):bisect.bisect_left(edges, e)] + [e]
        for a, b in zip(cuts, cuts[1:]):
            if b > a:
                label = open_at(a)
                by[label] = by.get(label, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def kernel_time(device, pattern) -> tuple[float, int]:
    """(seconds, launches) of the device ops whose names match `pattern`."""
    hits = [(e - s) for s, e, name in device if pattern.search(name)]
    return sum(hits) / 1e6, len(hits)
