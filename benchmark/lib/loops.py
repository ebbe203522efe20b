"""The loops that drive the program, one per traffic kind.

Each kind is a class with `setup(run)`, `window(run)`, `traced(run)`,
`release(run)` and `check(run)`; `run.py` calls them in that order. The
program is reached only through its public entry points and the stage
functions its modules call: `Detector.detect` (the stream) and
`Detector.infer_batch_jit` (offline batches), with `Detector.pad_points`
and `postprocess.to_annos` around them where the user makes those calls.
What depends on the architecture (weights, sweeps, the reference check,
the eager stage calls, the NMS rank cap) is asked of the configuration's
family, `run.family`.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time

import numpy as np
import torch

from benchmark.lib import counts, traffic
from benchmark.lib import trace as tr

TRACE_SECONDS = 2.0     # the traced stretch of a --trace 1 run, after its window
STAGE_FRAMES = 4        # frames of the eager pass that attributes device time to stages
HOST_IO_FRAMES = 16     # frames whose pad and annos the stream's traced run times alone
START_LEAD_S = 0.01     # the stream's first sweep is due this long after the window opens


def ranged(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _sleep_until(t: float) -> None:
    left = t - time.perf_counter()
    if left > 0.002:
        time.sleep(left - 0.0015)
    while time.perf_counter() < t:
        pass


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Detect:
    """Shared by the detector cells: weights, the program's detector, the
    reference check after the window."""

    def setup(self, run) -> None:
        from det3d_tpu_torch.config import load_config
        from det3d_tpu_torch.pipeline import Detector

        run.log(f"set-up: imports done at {time.perf_counter() - run.t_start:.3f} s")
        run.cfg = load_config(run.config_path)
        run.geo = run.family.geometry(run.config_path)
        run.weights = run.family.make_weights(run.seed, run.geo, run.device)
        run.det = Detector(run.cfg, device=run.device)
        run.det.load_state_dict(run.weights)
        if run.plant is not None:
            run.plant(run)
        run.log(f"set-up: detector and weights at {time.perf_counter() - run.t_start:.3f} s")
        run.pool = traffic.cloud_pool(run.mix, run.seed, run.family.point_cloud)
        run.log(f"set-up: frame pool at {time.perf_counter() - run.t_start:.3f} s")
        run.kept = {}            # sample id -> (pool frame, annos)

    def release(self, run) -> None:
        run.det = None
        gc.collect()
        if torch.device(run.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, run) -> dict:
        """Every sampled frame through the family's reference → the largest
        of each number compared."""
        fam = run.family
        net = fam.reference_network(run.weights, run.geo, run.device)
        worst, notes, valid = {}, [], []
        for sid in sorted(run.kept):
            f, annos = run.kept[sid]
            got = fam.check_frame(fam.reference_frame(net, run.pool[f], run.geo, run.device), annos,
                                  f"sample {sid} (pool frame {f})")
            valid.append(got.valid)
            notes.append(f"compared sample {sid} (pool frame {f}): {got.note}")
            for name, v in got.numbers.items():
                worst[name] = max(worst.get(name, v), v)
        run.nms_valid = valid
        for note in notes:
            run.log(note)
        return worst

    def stage_pass(self, run, batch: int) -> None:
        """The family's eager stage calls under the benchmark's ranges,
        profiled: device ms per frame of each stage."""
        from det3d_tpu_torch import postprocess

        @contextlib.contextmanager
        def stage(name: str):
            with ranged(True, f"bench.{name}"):
                yield
                _sync(run.device)

        mod = run.det.module
        frames = [run.det.pad_points(run.pool[i % len(run.pool)]) for i in range(STAGE_FRAMES * batch)]
        with torch.no_grad(), tr.profiled() as t:
            for b in range(STAGE_FRAMES):
                group = frames[b * batch:(b + 1) * batch]
                pts = [torch.as_tensor(p, device=run.device) for p, _ in group]
                ns = [torch.as_tensor(n, device=run.device) for _, n in group]
                _sync(run.device)
                run.family.stage_calls(mod, pts, ns, stage, postprocess)
        per = {}
        for s, e, name in t.ranges:
            per[name] = per.get(name, 0.0) + tr.busy_us(tr.device_in(t, s, e)) / 1e3
        run.stage_ms = {k.split(".", 1)[1]: v / (STAGE_FRAMES * batch) for k, v in per.items()}

    def read_trace(self, run, t) -> None:
        span = tr.window(t, "bench.window")
        if span is None:
            return
        lo, hi = span
        dev = tr.device_in(t, lo, hi)
        run.trace_window_s = (hi - lo) / 1e6
        run.trace_busy_s = tr.busy_us(dev) / 1e6
        run.breakdown = {"device_ops": tr.top_ops(dev), "idle_gaps": tr.idle_gaps(t, lo, hi)}
        run.kernels = {k: tr.kernel_time(dev, counts.KERNELS[k]) for k in run.family.KERNELS}
        run.nms_calls = sum(1 for _, _, name in dev if "mask_tiles(" in name)


class Stream(Detect):
    """An open loop of K unsynchronised sensors, one `Detector.detect` at a
    time, first in first out; latency from each sweep's due time."""

    def setup(self, run) -> None:
        super().setup(run)
        run.det.detect(run.pool[0])          # the capture
        run.log(f"set-up: first detect (warm-ups and capture) at {time.perf_counter() - run.t_start:.3f} s")
        for f in run.pool[1:4]:
            run.det.detect(f)
        _sync(run.device)
        run.schedule = traffic.stream_schedule(run.mix, run.seed, run.seconds)
        half = sum(1 for due, _, _ in run.schedule if due < run.seconds / 2)
        n = min(run.mix["compare"], half)
        run.sample_ids = set(traffic.rng(run.seed, 4).choice(half, n, replace=False).tolist())

    def drive(self, run, schedule, seconds: float, sample_ids=(), ranges: bool = False) -> dict:
        lat, svc, late = [], [], []
        t0 = time.perf_counter()
        t_end = t0 + START_LEAD_S + seconds
        done_count = 0
        with ranged(ranges, "bench.window"):
            for i, (due_rel, _, f) in enumerate(schedule):
                due = t0 + START_LEAD_S + due_rel
                now = time.perf_counter()
                if now >= t_end:
                    break
                if now < due:
                    with ranged(ranges, "bench.wait"):
                        _sleep_until(due)
                    now = time.perf_counter()
                    late.append(now - due)
                with ranged(ranges, "bench.detect"):
                    annos = run.det.detect(run.pool[f])
                done = time.perf_counter()
                lat.append(done - due)
                svc.append(done - now)
                done_count += 1
                if i in sample_ids:
                    run.kept[i] = (f, annos)
            t_close = max(time.perf_counter(), t_end)
        for due_rel, _, _ in schedule[done_count:]:
            lat.append(t_end - (t0 + START_LEAD_S + due_rel))   # due in the window, never started
        return {"latency_s": lat, "service_s": svc, "late_s": late, "done": done_count,
                "attempted": len(schedule), "window_s": t_close - t0}

    def window(self, run) -> None:
        run.stream = self.drive(run, run.schedule, run.seconds, run.sample_ids)
        run.attempted, run.failed = run.stream["attempted"], 0

    def traced(self, run) -> None:
        sched = traffic.stream_schedule(run.mix, run.seed + 1, TRACE_SECONDS, beat_s=run.seconds)
        with tr.profiled() as t:
            self.drive(run, sched, TRACE_SECONDS, ranges=True)
        self.read_trace(run, t)
        self.stage_pass(run, 1)
        from det3d_tpu_torch.postprocess import to_annos

        io = []
        for f in run.pool[:HOST_IO_FRAMES]:
            t0 = time.perf_counter()
            padded, n = run.det.pad_points(f)
            t1 = time.perf_counter()
            dets = run.det.infer_fn(padded, n)
            _sync(run.device)
            t2 = time.perf_counter()
            to_annos(run.cfg, dets)
            io.append((t1 - t0) + (time.perf_counter() - t2))
        run.host_io_s = statistics.median(io)


class Offline(Detect):
    """A closed loop, one batch in flight: pad B frames, one
    `Detector.infer_batch_jit`, each frame's annos to the host."""

    def setup(self, run) -> None:
        super().setup(run)
        b = run.mix["batch"]
        run.order = traffic.rng(run.seed, 5).permutation(len(run.pool))
        for i in range(3):                   # the capture, then two replays
            self.batch(run, i)
            if i == 0:
                run.log(f"set-up: first batch (warm-ups and capture) at {time.perf_counter() - run.t_start:.3f} s")
        _sync(run.device)
        n_sure = max(1, int(run.mix.get("sure_batches", 16)))
        picks = traffic.rng(run.seed, 6).choice(n_sure, run.mix["compare_batches"], replace=False)
        run.sample_ids = {int(p) * b + j for p in picks for j in range(b)}

    def batch(self, run, i: int, ranges: bool = False, spans=None):
        from det3d_tpu_torch.postprocess import Detections, to_annos

        b = run.mix["batch"]
        ids = [int(run.order[(i * b + j) % len(run.order)]) for j in range(b)]
        t0 = time.perf_counter()
        with ranged(ranges, "bench.pad"):
            padded = [run.det.pad_points(run.pool[f]) for f in ids]
            points = np.stack([p for p, _ in padded])
            n = np.asarray([k for _, k in padded], np.int32)
        t1 = time.perf_counter()
        with ranged(ranges, "bench.call"):
            dets = run.det.infer_batch_jit(points, n)
        t2 = time.perf_counter()
        with ranged(ranges, "bench.annos"):
            annos = [to_annos(run.cfg, Detections(dets.boxes[j], dets.scores[j], dets.valid[j])) for j in range(b)]
        t3 = time.perf_counter()
        if spans is not None:
            spans["pad"] += t1 - t0
            spans["call"] += t2 - t1
            spans["annos"] += t3 - t2
        return ids, annos

    def drive(self, run, seconds: float, sample: bool, ranges: bool = False, first: int = 0) -> dict:
        b = run.mix["batch"]
        spans = {"pad": 0.0, "call": 0.0, "annos": 0.0}
        frames, i = 0, first
        t0 = time.perf_counter()
        t_end = t0 + seconds
        with ranged(ranges, "bench.window"):
            while time.perf_counter() < t_end:
                ids, annos = self.batch(run, i, ranges, spans)
                if time.perf_counter() <= t_end:
                    frames += b
                if sample:
                    for j, (f, a) in enumerate(zip(ids, annos)):
                        if i * b + j in run.sample_ids:
                            run.kept[i * b + j] = (f, a)
                i += 1
        return {"frames": frames, "batches": i - first, "window_s": seconds, "spans": spans}

    def window(self, run) -> None:
        run.offline = self.drive(run, run.seconds, sample=True)
        run.attempted, run.failed = run.offline["batches"] * run.mix["batch"], 0

    def traced(self, run) -> None:
        with tr.profiled() as t:
            self.drive(run, TRACE_SECONDS, sample=False, ranges=True, first=run.offline["batches"])
        self.read_trace(run, t)
        self.stage_pass(run, run.mix["batch"])


KINDS = {"stream": Stream, "offline": Offline}


def nms_bound_s(run) -> float | None:
    """The NMS bound of one call over the rows of `batch` frames, from the
    compared frames' valid candidate counts."""
    frames = getattr(run, "nms_valid", None)
    if not frames:
        return None
    b = run.mix.get("batch", 1)
    total = 0.0
    for valid in frames:
        total += counts.nms_bound_s(valid * b, run.family.NMS_RANK_CAP)[0]
    return total / len(frames)


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
