"""The arithmetic behind the metric readers in `benchmark/metrics/`."""

from __future__ import annotations

import statistics

from benchmark.lib import counts, loops


def latency_p95_ms(run):
    s = getattr(run, "stream", None)
    return None if s is None else loops.percentile(s["latency_s"], 95) * 1e3


def service_p50_ms(run):
    s = getattr(run, "stream", None)
    return None if s is None or not s["service_s"] else statistics.median(s["service_s"]) * 1e3


def service_mean_ms(run):
    s = getattr(run, "stream", None)
    return None if s is None or not s["service_s"] else sum(s["service_s"]) / len(s["service_s"]) * 1e3


def generator_late_p95_ms(run):
    s = getattr(run, "stream", None)
    return None if s is None or not s["late_s"] else loops.percentile(s["late_s"], 95) * 1e3


def frames_per_s(run):
    o = getattr(run, "offline", None)
    return None if o is None else o["frames"] / o["window_s"]


def peak_gib(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None


def setup_s(run):
    return run.setup_s


def host_io_ms(run):
    """Host ms per frame in pad and annos."""
    o = getattr(run, "offline", None)
    if o is not None:
        return (o["spans"]["pad"] + o["spans"]["annos"]) / max(o["batches"] * run.mix["batch"], 1) * 1e3
    io = getattr(run, "host_io_s", None)
    return None if io is None else io * 1e3


def device_idle_pct(run):
    w = getattr(run, "trace_window_s", None)
    if not w or not getattr(run, "trace_busy_s", None):
        return None
    return 100.0 * (1.0 - run.trace_busy_s / w)


def stage_device_ms(run, stage: str):
    ms = getattr(run, "stage_ms", {}).get(stage)
    return ms if ms else None


def roofline_pct(run, kernel: str, bound_s: float):
    """A kernel's bound over its time, summed over its launches in the
    traced stretch; `bound_s` is one launch's."""
    k = getattr(run, "kernels", {}).get(kernel)
    if not k or not k[1] or k[0] <= 0:
        return None
    return 100.0 * bound_s * k[1] / k[0]


def scatter_roofline_pct(run):
    """The BEV scatter's bytes, at the cell's batch, at the HBM rate."""
    bound_s = run.family.scatter_bytes(run.geo, run.mix.get("batch", 1)) / counts.HBM_BYTES_PER_S
    return roofline_pct(run, "scatter", bound_s)


def nms_roofline_pct(run):
    k = getattr(run, "kernels", {}).get("nms")
    bound = loops.nms_bound_s(run)
    calls = getattr(run, "nms_calls", 0)
    if not k or not calls or k[0] <= 0 or bound is None:
        return None
    return 100.0 * bound * calls / k[0]


def mfu_pct(run):
    """Network FLOPs over the time they took, against the bf16 dense peak:
    per call in the stream, the whole window in the closed loops."""
    flops = run.family.network_flops(run.geo)
    s = getattr(run, "stream", None)
    if s is not None and s["service_s"]:
        return 100.0 * flops / statistics.median(s["service_s"]) / counts.BF16_FLOPS_PER_S
    o = getattr(run, "offline", None)
    if o is not None and o["frames"]:
        return 100.0 * flops * o["frames"] / o["window_s"] / counts.BF16_FLOPS_PER_S
    return None
