"""Offline inference and evaluation: the reference's `infer()` entry.

Counterpart of the JAX package's apps/infer_app.py (reference
train.py:187-270): detect every frame of an eval set, time it, optionally
split the time into pre / net / post (`breakdown`), pickle the detection
annos, then the official mAP at a sweep of range thresholds, the
rotated-IoU matrices computed once and shared across the sweep. Frames of
a dataset are read by `DetectionDataset.iter_points_native` (the native
loader's threads where its library builds).

A frame runs through `Detector.infer_jit` (one captured CUDA graph a
frame on the card), as the JAX app's `det.infer_jit`. `breakdown` splits
the time of the replay the app runs into pre / net / post by the graph's
own stage marks (`utils.timing`), over `BREAKDOWN_CALLS` more calls of the
first frame or chunk under the profiler (`utils.timing.trace`), and prints
the host spans of those calls beside them. `batch > 1` runs
chunks of `batch` frames through `Detector.infer_batch_jit` (the network
once at that batch, NMS once per chunk, one graph), the JAX app's
`jax.jit(jax.vmap(...))` path on one device; `exported` runs an exported
artifact (`deploy.runtime.infer_exported`). With a data-parallel `mesh`
(`torchrun ... infer --batch B`), each chunk is sharded over the ranks by
`parallel/mesh.make_sharded_infer` (each rank's slice through its own
`infer_batch` and the detections gathered in frame order, in one captured
CUDA graph a chunk on the card), over the first
gcd(B, world) ranks where B does not divide the world, and on rank 0
alone where they share no factor, as the JAX app's rule
(infer_app.py:92-116); rank 0 writes the annos, the timing and the eval.
`spatial=True` (`infer --spatial`) splits each frame's network along x
over the ranks of `mesh` (`parallel/mesh.make_spatial_infer`, the
detector's `infer_jit`: one captured CUDA graph a frame with its
collectives inside), the multi-card single-frame latency mode: one frame
at a time (no `batch`, no `exported`), no `breakdown` (it times stages of
one device); every rank runs every frame and holds its detections, and
rank 0 prints, writes and evaluates. The JAX app's `exact_topk` becomes
`approx_topk`, because the port's top-k is exact by default.
"""

from __future__ import annotations

import math
import pickle
import statistics
import tempfile
import time

import numpy as np

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.parallel.mesh import DataMesh, make_mesh, make_sharded_infer, make_spatial_infer
from det3d_tpu_torch.postprocess import Detections, PostProcessParams, to_annos
from det3d_tpu_torch.utils import timing
from det3d_tpu_torch.utils.timing import block_until_ready

BREAKDOWN_CALLS = 10   # calls of the first frame or chunk that `breakdown` reads the stages of


def frame_source(cfg: Config, synthetic: bool, num_frames: int, seed: int, pad_points):
    """(reader name, gt annos, iterator of (padded points, n)); `pad_points`
    pads a synthetic scene's cloud to (max_points, C)."""
    from det3d_tpu_torch.apps.train_app import _eval_samples, gt_annos_of

    if synthetic:
        samples, gt_annos = _eval_samples(cfg, True, num_frames, seed)
        return "synthetic", gt_annos, (pad_points(s["points"]) for s in samples)
    from det3d_tpu_torch.data.dataset import DetectionDataset

    ds = DetectionDataset(cfg, cfg.eval_info, training=False)
    order = np.arange(min(num_frames, len(ds)))
    gt_annos = [gt_annos_of(ds.infos[i]) for i in order]
    return ds.point_reader(), gt_annos, ((pts, n) for _, pts, n in ds.iter_points_native(order))


def infer(
    cfg: Config,
    *,
    checkpoint: str | None = None,
    synthetic: bool = False,
    num_frames: int = 64,
    range_thresholds: tuple[float, ...] = (80.0, 85.0, 90.0),
    breakdown: bool = False,
    out_path: str | None = None,
    seed: int = 1,
    approx_topk: bool = False,
    batch: int = 1,
    exported: str | None = None,
    device=None,
    mesh: DataMesh | None = None,
    spatial: bool = False,
) -> dict | None:
    """Returns {"dt_annos", "gt_annos", "eval_strs", "avg_ms", "reader",
    "stages", "timed_frames"}. `checkpoint`: a model directory (its
    `latest.pth`) or a `.pth` file; seeded random weights without one. The
    first frame or chunk (the kernels' build, cuDNN's choice of
    algorithms) is left out of the average; where that leaves nothing, a
    second call of it, on inputs moved by 1 mm, is timed. With `batch`,
    the last chunk is padded with its last frame and the average counts
    every dispatched frame, padding included, as the JAX app does.
    `exported`: an artifact directory, run by `infer_exported` (which
    returns its own dict) in place of a live detector. `mesh`: the batch
    sharded over its ranks (see the module docstring), on the mesh's
    device; None on every rank but rank 0. `spatial`: each frame split over
    the ranks of `mesh` (see the module docstring)."""
    lead = mesh is None or mesh.rank == 0  # prints, writes, evaluates
    shard = None
    if spatial:
        if batch > 1:
            raise ValueError("--spatial partitions within one frame; use it with batch=1")
        if exported:
            raise ValueError("--spatial runs the live detector: no exported artifact with it")
        if mesh is None:
            raise ValueError("--spatial needs a process group (parallel/mesh.make_spatial_mesh)")
        device = mesh.device
        if breakdown and lead:
            print("NOTE: --breakdown is per-stage on a single device and is skipped under --spatial")
        breakdown = False
    elif mesh is not None:
        device = mesh.device
        use = 1 if exported else math.gcd(batch, mesh.world)
        if use > 1:
            shard = mesh if use == mesh.world else make_mesh(use, device=device)  # a collective of every rank
            if not shard.member:
                return None
        elif not lead:
            return None
        if lead and mesh.world > 1:
            print(f"batch {batch} " + (f"data-parallel over {use}/{mesh.world} ranks" if shard is not None else
                                       f"shares no factor with {mesh.world} ranks: rank 0 alone"))
    if exported:
        if checkpoint or batch > 1 or breakdown:
            raise ValueError("an exported artifact carries its weights and runs one frame at a time: "
                             "no checkpoint, batch or breakdown with it")
        from det3d_tpu_torch.deploy.runtime import infer_exported

        return infer_exported(cfg, exported, synthetic=synthetic, num_frames=num_frames, seed=seed, device=device)
    from det3d_tpu_torch.eval.ap import get_official_eval_result
    from det3d_tpu_torch.pipeline import Detector

    if batch < 1:
        raise ValueError(f"batch must be at least 1, got {batch}")
    pp = PostProcessParams(approx_topk=True) if approx_topk else None
    if spatial:
        det, _ = make_spatial_infer(cfg, mesh, postprocess_params=pp)
        if lead:
            print(f"spatial partitioning over {mesh.world} ranks ({mesh.backend})")
    else:
        det = Detector(cfg, device, postprocess_params=pp)
    if checkpoint:
        from det3d_tpu_torch.train.checkpoint import load_latest_state

        _, state = load_latest_state(cfg, checkpoint, det)
        if lead:
            print(f"loaded checkpoint @ step {state.step}")
    else:
        det.init_weights(0)
        if lead:
            print("WARNING: random weights (no checkpoint given)")

    reader, gt_annos, frames = frame_source(cfg, synthetic, num_frames, seed, det.pad_points)
    if lead:
        print(f"point reader: {reader}")
    if shard is not None:
        dt_annos, total, denom, first = _run_batched(det, frames, batch, make_sharded_infer(det, shard))
    elif batch > 1:
        dt_annos, total, denom, first = _run_batched(det, frames, batch, det.infer_batch_jit)
    else:
        dt_annos, total, denom, first = _run_frames(det, frames)
    stages = {"e2e": total / denom}
    if breakdown and first is not None:  # every rank that ran the calls: a sharded graph's collectives
        stages.update(_stage_breakdown(det.cfg, *first, lead))
    if not lead:
        return None

    avg_ms = 1e3 * total / denom
    print(f"avg end-to-end: {avg_ms:.2f} ms/frame   [{'  '.join(f'{k}: {v * 1e3:.2f}ms' for k, v in stages.items())}]")

    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(dt_annos, f)
        print(f"wrote {out_path}")

    eval_strs = []
    cache: dict = {}  # rotated-IoU matrices shared across the range sweep
    for rt in range_thresholds:
        _, s = get_official_eval_result(gt_annos, dt_annos, list(cfg.detect_class), rt, overlaps_cache=cache,
                                        device=det.device)
        print(s)
        eval_strs.append(s)
    return {"dt_annos": dt_annos, "gt_annos": gt_annos, "eval_strs": eval_strs, "avg_ms": avg_ms,
            "reader": reader, "stages": stages, "timed_frames": denom}


def _run_frames(det, frames):
    """One frame at a time → (annos, timed seconds, timed frames, the
    frame function with the first frame and its frame count)."""
    infer = det.infer_fn
    dt_annos, total, first = [], 0.0, None
    for i, (pts, n) in enumerate(frames):
        t0 = time.perf_counter()
        out = block_until_ready(infer(pts, n))
        dt = time.perf_counter() - t0
        if i == 0:
            first = (infer, (pts, n), 1)
        else:
            total += dt
        dt_annos.append(to_annos(det.cfg, out))
    if len(dt_annos) == 1:
        pts, n = first[1]
        t0 = time.perf_counter()
        block_until_ready(infer(pts + np.float32(1e-3), n))
        total = time.perf_counter() - t0
    return dt_annos, total, max(len(dt_annos) - 1, 1), first


def _run_batched(det, frames, batch: int, run):
    """Chunks of `batch` frames through `run`: `Detector.infer_batch_jit`,
    or `make_sharded_infer`'s function of host arrays; the last chunk
    padded with its last frame → (annos, timed seconds, dispatched frames
    timed, `run` with the first chunk and its frame count)."""
    dt_annos, total, timed, first = [], 0.0, 0, None
    frames = list(frames)
    for start in range(0, len(frames), batch):
        chunk = frames[start:start + batch]
        padded = chunk + [chunk[-1]] * (batch - len(chunk))
        pts = np.stack([p for p, _ in padded])
        cnt = np.asarray([int(n) for _, n in padded], np.int32)
        first = first or (run, (pts, cnt), batch)
        t0 = time.perf_counter()
        out = block_until_ready(run(pts, cnt))
        dt = time.perf_counter() - t0
        if start > 0:
            total += dt
            timed += batch
        for i in range(len(chunk)):
            dt_annos.append(to_annos(det.cfg, Detections(*(t[i] for t in out))))
    if timed == 0 and frames:
        # the one chunk paid the build: time it again, on moved inputs
        t0 = time.perf_counter()
        block_until_ready(run(pts + np.float32(1e-3), cnt))
        total, timed = time.perf_counter() - t0, batch
    return dt_annos, total, max(timed, 1), first


def _stage_breakdown(cfg: Config, run, args, frames: int, lead: bool) -> dict[str, float]:
    """Seconds a frame of each stage of the replay that `run(*args)` makes
    (pre = voxelize + anchor mask, net = the network, post = decode + NMS,
    the reference's split, train.py:244-258), the median over
    `BREAKDOWN_CALLS` calls under the profiler, read from the graph's
    stage marks (device time on the card); `lead` prints the median of
    each host span of the calls (staging, launch, fetch, format)."""
    since = time.perf_counter_ns()
    with tempfile.TemporaryDirectory(prefix="det3d-breakdown-") as log_dir, timing.trace(log_dir):
        for _ in range(BREAKDOWN_CALLS):
            out = run(*args)
            for i in range(frames):
                to_annos(cfg, out if frames == 1 else Detections(*(t[i] for t in out)))
    replays, stages = timing.replays(since), {}
    for key, first, last in (("pre", "start", "preprocess"), ("net", "preprocess", "network"),
                             ("post", "network", "postprocess")):
        ms = [_stage_ms(r.marks, first, last) for r in replays]
        stages[key] = statistics.median(ms) / frames / 1e3 if ms else math.nan
    if lead:
        host: dict[str, list[float]] = {}
        for sp in timing.spans(since):
            host.setdefault(sp.name, []).append((sp.end_ns - sp.start_ns) / 1e6)
        print("breakdown host ms (median a span): "
              + "  ".join(f"{k} {statistics.median(v):.3f}" for k, v in host.items()))
    return stages


def _stage_ms(marks, first: str, last: str) -> float:
    """ms from mark `first` to mark `last`."""
    at = dict(marks)
    return at[last] - at[first]
