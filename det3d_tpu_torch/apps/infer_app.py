"""Offline inference and evaluation: the reference's `infer()` entry.

Counterpart of the JAX package's apps/infer_app.py (reference
train.py:187-270): detect every frame of an eval set, time it, optionally
split the time into pre / net / post (`breakdown`), pickle the detection
annos, then the official mAP at a sweep of range thresholds, the
rotated-IoU matrices computed once and shared across the sweep. Frames of
a dataset are read by `DetectionDataset.iter_points_native` (the native
loader's threads where its library builds).

`batch > 1` runs chunks of `batch` frames through `Detector.infer_batch`
(the network once at that batch, NMS once per chunk), the JAX app's
`jax.vmap` path on one device; `exported` runs an exported artifact
(`deploy.runtime.infer_exported`). With a data-parallel `mesh`
(`torchrun ... infer --batch B`), each chunk is sharded over the ranks by
`parallel/mesh.make_sharded_infer` (each rank's slice through its own
`infer_batch`, the detections gathered in frame order), over the first
gcd(B, world) ranks where B does not divide the world, and on rank 0
alone where they share no factor, as the JAX app's rule
(infer_app.py:92-116); rank 0 writes the annos, the timing and the eval.
Not ported: `spatial` (ROADMAP). The JAX app's `exact_topk` becomes
`approx_topk`, because the port's top-k is exact by default.
"""

from __future__ import annotations

import math
import pickle
import time

import numpy as np
import torch

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.parallel.mesh import DataMesh, make_mesh, make_sharded_infer
from det3d_tpu_torch.postprocess import Detections, PostProcessParams, frame_preds, to_annos
from det3d_tpu_torch.utils.timing import StageTimers, block_until_ready, time_fn


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
    device; None on every rank but rank 0."""
    lead = mesh is None or mesh.rank == 0  # prints, writes, evaluates
    shard = None
    if mesh is not None:
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
    det = Detector(cfg, device, postprocess_params=PostProcessParams(approx_topk=True) if approx_topk else None)
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
    timers = StageTimers()
    if shard is not None:
        dt_annos, total, denom, first = _run_batched(det, frames, batch, timers, make_sharded_infer(det, shard))
        if not lead:
            return None
    elif batch > 1:
        dt_annos, total, denom, first = _run_batched(det, frames, batch, timers)
    else:
        dt_annos, total, denom, first = _run_frames(det, frames, timers)

    if breakdown and first is not None:
        _stage_breakdown(det, *first, timers)

    avg_ms = 1e3 * total / denom
    print(f"avg end-to-end: {avg_ms:.2f} ms/frame   [{timers.report()}]")

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
            "reader": reader, "stages": timers.averages(), "timed_frames": denom}


def _run_frames(det, frames, timers: StageTimers):
    """One frame at a time → (annos, timed seconds, timed frames, the
    first frame)."""
    dt_annos, total, first = [], 0.0, None
    for i, (pts, n) in enumerate(frames):
        t0 = time.perf_counter()
        out = block_until_ready(det.infer(torch.from_numpy(pts).to(det.device), int(n)))
        dt = time.perf_counter() - t0
        if i == 0:
            first = (pts, n)
        else:
            total += dt
            timers.add("e2e", dt)
        dt_annos.append(to_annos(det.cfg, out))
    if len(dt_annos) == 1:
        t0 = time.perf_counter()
        block_until_ready(det.infer(torch.from_numpy(first[0] + np.float32(1e-3)).to(det.device), int(first[1])))
        total = time.perf_counter() - t0
        timers.add("e2e", total)
    return dt_annos, total, max(len(dt_annos) - 1, 1), first


def _run_batched(det, frames, batch: int, timers: StageTimers, sharded=None):
    """Chunks of `batch` frames through `Detector.infer_batch`, or through
    `sharded` (`make_sharded_infer`'s function of host arrays), the last
    chunk padded with its last frame → (annos, timed seconds, dispatched
    frames timed, the first frame)."""
    def run(pts, cnt):
        if sharded is not None:
            return sharded(pts, cnt)
        return det.infer_batch(torch.from_numpy(pts).to(det.device), torch.from_numpy(cnt).to(det.device))

    dt_annos, total, timed, first = [], 0.0, 0, None
    frames = list(frames)
    for start in range(0, len(frames), batch):
        chunk = frames[start:start + batch]
        first = first or chunk[0]
        padded = chunk + [chunk[-1]] * (batch - len(chunk))
        pts = np.stack([p for p, _ in padded])
        cnt = np.asarray([int(n) for _, n in padded], np.int32)
        t0 = time.perf_counter()
        out = block_until_ready(run(pts, cnt))
        dt = time.perf_counter() - t0
        if start > 0:
            total += dt
            timed += batch
            timers.add("e2e", dt / batch)
        for i in range(len(chunk)):
            dt_annos.append(to_annos(det.cfg, Detections(*(t[i] for t in out))))
    if timed == 0 and frames:
        # the one chunk paid the build: time it again, on moved inputs
        t0 = time.perf_counter()
        block_until_ready(run(pts + np.float32(1e-3), cnt))
        total, timed = time.perf_counter() - t0, batch
        timers.add("e2e", total / batch)
    return dt_annos, total, max(timed, 1), first


@torch.no_grad()
def _stage_breakdown(det, pts: np.ndarray, n, timers: StageTimers) -> None:
    """Per-stage latency, median of 10 (reference train.py:244-258 prints
    the same split): pre = voxelize + anchor mask, net = the network,
    post = decode + NMS."""
    points = torch.from_numpy(pts).to(det.device)
    frame, mask = det.preprocess(points, int(n))
    net_args = (frame.voxels[None], frame.num_points_per_voxel[None], frame.coors[None])
    preds = frame_preds(det.model(*net_args), 0)  # a split head's column-parity pairs stay pairs
    post = lambda p, m: det.postprocess.finalize_stage(det.postprocess.decode_stage(p, m))  # noqa: E731
    for name, fn, args in (("pre", det.preprocess, (points, int(n))), ("net", det.model, net_args),
                           ("post", post, (preds, mask))):
        timers.add(name, time_fn(fn, *args, iters=10)["p50_ms"] / 1e3)
