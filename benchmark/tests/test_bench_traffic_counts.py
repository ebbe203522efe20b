"""The traffic generator is deterministic per seed and gives every seed
the same work; the yardstick's operation and byte counts."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark.lib import counts, harness, traffic

FAMILY = harness.family({})

BIG = 2**31 + 12345


@pytest.mark.parametrize("name", ["lidar_stream", "drive_b4"])
def test_pool_deterministic_per_seed(name):
    mix = dict(traffic.load_mix(name), pool=4, points=[2000, 5000])
    a, b, c = (traffic.cloud_pool(mix, s, FAMILY.point_cloud) for s in (BIG, BIG, BIG + 1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert sorted(len(x) for x in a) == sorted(len(x) for x in c)   # the same sizes, in another order


def test_seeds_beyond_32_bits():
    mix = dict(traffic.load_mix("lidar_stream"), pool=2, points=[100, 200])
    for seed in (0, 2**31 + 3, 2**40 + 1):
        assert len(traffic.cloud_pool(mix, seed, FAMILY.point_cloud)) == 2


def _rates(sched):
    """Each sensor's spin rate in Hz, from its first and last sweep."""
    by = {}
    for d, s, _ in sched:
        by.setdefault(s, []).append(d)
    return [(len(v) - 1) / (v[-1] - v[0]) for _, v in sorted(by.items())]


def test_stream_schedule_deterministic_per_seed():
    mix = traffic.load_mix("lidar_stream")
    s1, s2 = traffic.stream_schedule(mix, BIG, 20.0), traffic.stream_schedule(mix, BIG + 7, 20.0)
    assert s1 == traffic.stream_schedule(mix, BIG, 20.0)
    assert [d for d, _, _ in s1] != [d for d, _, _ in s2]             # the start in the cycle comes from the seed
    assert all(0.0 <= d < 20.0 for d, _, _ in s1)
    assert abs(len(s1) - 20 * mix["hz"] * mix["sensors"]) <= mix["sensors"]
    assert [d for d, _, _ in s1] == sorted(d for d, _, _ in s1)


@pytest.mark.parametrize("seconds", [20.0, 51.0])
def test_stream_rates_the_same_set_every_seed_whole_beats_in_the_window(seconds):
    """The same spin rates for every seed, the mix's, one step apart being
    `beat_cycles` relative turns in the window."""
    mix = traffic.load_mix("lidar_stream")
    r1 = _rates(traffic.stream_schedule(mix, BIG, seconds))
    r2 = _rates(traffic.stream_schedule(mix, BIG + 7, seconds))
    assert r1 == pytest.approx(r2, rel=1e-9)
    assert r1 != pytest.approx(sorted(r1), rel=1e-9, abs=0)          # handed out in the pattern's order
    steps = np.diff(sorted(r1))
    assert steps == pytest.approx(np.full(mix["sensors"] - 1, mix["beat_cycles"] / seconds), rel=1e-3)
    assert np.mean(r1) == pytest.approx(mix["hz"], rel=1e-3)


def test_stream_schedule_has_bursts():
    """Unsynchronised sensors: some sweeps come due within a millisecond of
    another, and some gaps are far longer than the even spacing."""
    mix = traffic.load_mix("lidar_stream")
    due = np.asarray([d for d, _, _ in traffic.stream_schedule(mix, BIG, 20.0)])
    gaps = np.diff(due)
    even = 1.0 / (mix["hz"] * mix["sensors"])
    assert (gaps < 0.001).any() and gaps.max() > 2 * even


def _fifo_p95_ms(sched, service_s: float) -> float:
    """The p95 latency of one server taking the sweeps in due order."""
    t, lat = 0.0, []
    for due, _, _ in sched:
        t = max(t, due) + service_s
        lat.append(t - due)
    return float(np.percentile(lat, 95)) * 1e3


@pytest.mark.parametrize("sensors", [8, 10])
def test_stream_every_seed_the_same_bursts(sensors):
    """Every seed meets the same alignments in another order: over the 51 s
    window a fixed service time queues to the same tail within 1 %, while
    the due times differ; the pattern seed alone moves that tail."""
    mix = dict(traffic.load_mix("lidar_stream"), sensors=sensors)
    seeds = [BIG, BIG + 7, 2**40 + 1, 3]
    scheds = [traffic.stream_schedule(mix, s, 51.0) for s in seeds]
    p95 = [_fifo_p95_ms(sc, 0.006) for sc in scheds]
    assert max(p95) / min(p95) < 1.01
    assert max(len(sc) for sc in scheds) - min(len(sc) for sc in scheds) <= sensors
    assert len({sc[0][0] for sc in scheds}) == len(seeds)
    other = [_fifo_p95_ms(traffic.stream_schedule(dict(mix, pattern_seed=p), BIG, 51.0), 0.006) for p in (2, 5, 26)]
    assert max(other) / min(other) > 1.05


@pytest.mark.parametrize("cfg,gflop", [("ntusl_20cm", 203.47904)])
def test_network_flops(cfg, gflop):
    path = harness.BENCH / "configs" / f"{cfg}.json"
    fam = harness.family(json.loads(path.read_text()))
    geo = fam.geometry(path)
    # RPN by hand at 20 cm: blocks of 47.2 + 64.9 + 64.9 GFLOP, branches 1.3 + 5.2 + 10.5, head 9.2, PFN 0.28
    assert fam.network_flops(geo) / 1e9 == pytest.approx(gflop, rel=1e-9)


def test_kernel_bounds():
    path = harness.BENCH / "configs" / "ntusl_20cm.json"
    fam = harness.family(json.loads(path.read_text()))
    geo = fam.geometry(path)
    assert fam.scatter_bytes(geo, 1) == 2 * 16000 * 64 * 2 + 16000 * 12
    assert fam.scatter_bytes(geo, 4) == pytest.approx(4 * fam.scatter_bytes(geo, 1))
    assert fam.NMS_RANK_CAP == 1000 and set(fam.KERNELS) <= set(counts.KERNELS)
    t, by = counts.nms_bound_s([1000, 1000, 1000], 1000)
    assert by == "operations"
    assert t == pytest.approx(3 * 1000 * 999 / 2 * 15 / 67e12)
    assert counts.KERNELS["scatter"].search("void scatter_rows<uint4, 0>(int)")
    assert not counts.KERNELS["scatter"].search("void scatter_rows<uint4, 1>(int)")
    assert counts.KERNELS["nms"].search("mask_tiles(float const*)") and counts.KERNELS["nms"].search("sweep(int)")


def test_idle_gaps_split_by_the_host_range_open_meanwhile():
    from benchmark.lib import trace as tr

    t = tr.Trace(device=[(0, 10, "k"), (50, 60, "k")],
                 ranges=[(0, 100, "bench.window"), (0, 20, "bench.detect"), (20, 50, "bench.wait"),
                         (50, 70, "bench.detect"), (52, 58, "bench.inner")])
    got = dict(tr.idle_gaps(t, 0, 100))
    assert got == pytest.approx({"bench.detect": 20e-6, "bench.wait": 30e-6, "bench.other": 30e-6})
