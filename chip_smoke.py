#!/usr/bin/env python3
"""Smoke run of the PyTorch port (det3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. environment: the card (nvidia-smi name and power limit), torch, CUDA;
     TF32 off for the float32 phases;
  2. build: every CUDA kernel from det3d_tpu_torch/kernels/csrc, in
     parallel, with the compiler's register/shared-memory report;
  3. kernels vs their plain PyTorch versions on the card, at the shapes of
     the 20 cm main path: the BEV scatter bit-equal in f32 and bf16, NMS
     keep masks equal (a real frame's 3 x 1000 candidates, random boxes,
     1 to 8 classes, K from 33 to 1024, a chain of dependent decisions,
     identical boxes, valid flags only in the last chunk); times from CUDA
     events, the NMS mask kernel and sweep also apart;
  4. the main path at full width: configs/ntusl_20cm.json (800x800 grid,
     16k pillars x 15 points, 1.44M anchors, bf16) with seeded random
     weights, ~100k-point frames through `Detector.detect`; every kernel of
     the path must launch on every frame;
  5. the full path in float32 with the kernels against the same path with
     the plain versions on the card, and a small geometry on the card
     against the CPU, at the tolerances of tests/test_golden_e2e.py;
  6. the train path's kernels vs their plain versions on the card, at the
     20 cm shapes (batch 2): the matcher (a real frame pair, no valid gt,
     every anchor masked, one class's anchors masked, gt outside the range,
     a zero-size gt and two gt that tie everywhere, a matched threshold of
     0: labels, weights, dir and gt-max equal, targets within 1e-6; what its
     cull leaves of the real pair), the scatter backward (bit-equal in f32 and bf16) and the fence
     copy (bit-equal and contiguous on the head's three views, f32, odd
     offsets and sizes, rank 6; the kernel each view took; timed with a warm
     and with a flushed L2 against the contiguous-format `clone`); device
     times from CUDA events, host times per call;
  7. the train step at full width: ntusl_20cm, bf16, batch 2, seeded
     weights, two seeded ~100k-point scenes repeated; ms/step, peak memory,
     launches per step of every train-path kernel, finite losses that fall,
     the host-card synchronisations of one step, a stage breakdown and the
     profiler's device share;
  8. one float32 train step with the kernels against one with the plain
     versions, from the same weights and batch: loss, gradients, updated
     parameters and batch statistics at the CPU tests' tolerances;
  9. the layout path's kernels vs their plain versions at the 20 cm shapes
     (16k pillars x 64 channels; batch 1 and 2): the s2d scatter in H-major
     and W-major order, the blocked-halo s2d scatter (8 blocks, halo (4, 3))
     and both backwards, bit-equal in f32 and bf16, each timed against its
     bytes bound, its plain version and zeros + index_put_;
 10. packed inference at full width: ntusl_20cm with pack_w, then with
     pack_w + block0_blocked (bf16, 20 frames each): ms/frame, peak memory,
     stage breakdown, launches (the s2d or the blocked scatter once a
     frame, the dense scatter never); in f32, the kernel path against the
     plain path, and packed against dense `cls_preds`;
 11. the packed train step at full width: ntusl_20cm with pack_w and its
     shipped block0_blocked_train + late_blocked_train (bf16, batch 2, 20
     steps: ms/step, peak memory, falling loss, the blocked scatter and its
     backward once a step, breakdown), the packed step without blocking
     (the s2d scatter and its backward once a step), and one f32 packed +
     blocked step with the kernels against one with the plain versions.
The last lines are the kernels table (JSON), the card's name and power
limit, and {"ok": true, "device": {...}}. Needs one CUDA card; imports
nothing of the JAX package.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_FRAMES = 20
N_POINTS = 100_000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
SPIN_CYCLES = 40_000_000    # ~20 ms of a spin kernel at the H100's ~1.98 GHz boost clock
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
# operations per box pair in the NMS suppression test: iw and ih (min, max,
# sub, add, max each), inter, union (add, sub), the division, the compare;
# the per-box areas are counted once per box, not per pair
NMS_OPS_PER_PAIR = 15
# operations per overlapping (included anchor, valid gt of its class) pair
# in the matcher: the IoU (iw, ih: min, max, sub each; two compares and a
# multiply for inter; two areas of sub, sub, mul; union add, sub; compare,
# divide) is 19; pass 1 adds the max, pass 2 the argmax compare and select
# and the force-match compare, compare and or. A pair that the kernels visit
# and find disjoint costs the interval tests only (min, max, sub, compare,
# twice)
MATCH_OPS_PASS1 = 20
MATCH_OPS_PASS2 = 24
MATCH_OPS_DISJOINT = 8
# the matcher kernels that looped over every gt of the class for every
# anchor, before the cull by anchor-chunk boxes, at the same batch on an H100
# at 700 W (PERF.md, kernel table)
MATCHER_GT_MAX_PREV_MS = 0.1116
MATCHER_ASSIGN_PREV_MS = 0.1160
# the one-block-per-class NMS kernel that the mask + sweep design replaced, at
# the 3 x 1000 real-frame shape on an H100 at 700 W (PERF.md, kernel table)
NMS_PREV_MS = 0.3533
# the element-per-thread fence kernel on the `cls_preds` view, before the
# transpose kernel took that view (PERF.md, kernel table)
FENCE_PREV_MS = 0.0209
L2_FLUSH_BYTES = 128 * 2**20  # more than twice the H100's 50 MB L2
TRAIN_BATCH = 2
TRAIN_WARMUP = 3
TRAIN_STEPS = 20
TRAIN_POINTS = 97_000  # ground points of each scene; ~100k with the objects
LAYOUT_TRAIN_STEPS = 10  # steps of the packed train step without blocking
# packed (and blocked) against dense cls_preds in f32 with TF32 off: the
# same function with other convolutions summing in other orders through
# 20 layers, each renormalised by an InstanceNorm; a fraction of the
# largest |cls_preds| (at least 1)
PACKED_VS_DENSE_TOL = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls.
    A spin kernel queued first keeps the card busy while the host queues
    the calls, so a wrapper's Python time does not show as device time
    (unless the host needs longer than the spin, ~20 ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def single_call_ms(fn, flush: torch.Tensor | None = None, reps: int = 10) -> float:
    """Median device time of single calls, CUDA events around each. With
    `flush`, a buffer larger than the L2, every call comes after a `zero_()`
    of it, so the call finds its input in device memory, not in the cache.
    A short spin kernel goes first, so the host has queued the call before
    the card reaches it; the events' own cost (a few microseconds) is part
    of every reading."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES // 40)  # ~0.5 ms
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, iters: int = 30) -> float:
    """Mean host time of one call (the wrapper's Python and the launch),
    with the card kept busy so that no call waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def scatter_inputs(v: int, c: int, grid_xy, n_valid: int, dtype, gen: torch.Generator):
    nx, ny = grid_xy
    feats = torch.randn((1, v, c), generator=gen).to(dtype)
    coors = torch.full((1, v, 3), -1, dtype=torch.int32)
    cells = torch.randperm(nx * ny, generator=gen)[:n_valid]
    coors[0, :n_valid, 0] = (cells // ny).to(torch.int32)
    coors[0, :n_valid, 1] = (cells % ny).to(torch.int32)
    coors[0, :n_valid, 2] = 0
    return feats.cuda(), coors.cuda()


def check_scatter(grid_xy, v: int, c: int) -> dict:
    from det3d_tpu_torch.kernels import scatter_cuda as sc

    gen = torch.Generator().manual_seed(SEED)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n_valid in (12_000, 0):
            feats, coors = scatter_inputs(v, c, grid_xy, n_valid, dtype, gen)
            got = sc.scatter_to_bev_cuda(feats, coors, grid_xy)
            want = sc.scatter_to_bev_plain(feats, coors, grid_xy)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            equal = torch.equal(bits(got), bits(want))
            print(f"scatter {str(dtype):15s} valid={n_valid:5d}: bit-equal={equal} max_abs_err={err}")
            check(equal, f"scatter {dtype} with {n_valid} pillars differs from the plain version")
            result["max_abs_err"] = max(result.get("max_abs_err", 0.0), err)
        # times at the main path's shape, with the ~12k-pillar input
        feats, coors = scatter_inputs(v, c, grid_xy, 12_000, dtype, gen)
        keep = coors[0, :, 0] >= 0
        idx = (torch.zeros_like(coors[0, keep, 0]).long(), coors[0, keep, 0].long(), coors[0, keep, 1].long())
        rows = feats[0, keep]
        nx, ny = grid_xy
        ms = cuda_ms(lambda: sc.scatter_to_bev_cuda(feats, coors, grid_xy))
        plain_ms = cuda_ms(lambda: sc.scatter_to_bev_plain(feats, coors, grid_xy))
        library_ms = cuda_ms(lambda: torch.zeros((1, nx, ny, c), dtype=dtype, device="cuda").index_put_(idx, rows))
        moved = (nx * ny * c + v * c) * feats.element_size() + coors.numel() * 4
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        print(f"scatter {str(dtype):15s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} (bytes)")
        result[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms)
    return result


def random_boxes(ncls: int, k: int, gen: torch.Generator) -> torch.Tensor:
    centers = torch.rand((ncls, k, 2), generator=gen) * 80 - 40
    dims = torch.rand((ncls, k, 2), generator=gen) * 7 + 1
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1).cuda()


def nms_cases(candidates, gen: torch.Generator):
    """(name, boxes (ncls, K, 4), valid (ncls, K)) cases on the card: the
    first three at the main path's 3 x 1000, then the shapes and data that
    stress the chunked sweep."""
    k = max(c.valid.shape[0] for c in candidates)
    ncls = len(candidates)
    real = torch.zeros((ncls, k, 4), device="cuda")
    for ci, c in enumerate(candidates):
        real[ci, : c.standup.shape[0]] = c.standup
    # ~20% invalid, as the score gate leaves a real frame's tail
    some_invalid = torch.rand((ncls, k), generator=gen) >= 0.2
    ones = lambda *shape: torch.ones(shape, dtype=torch.bool, device="cuda")
    # each box over the threshold only with its neighbours: kept and
    # suppressed alternate along 1000 dependent decisions
    x = torch.arange(1000, dtype=torch.float32, device="cuda") * 5
    chain = torch.stack([x, torch.zeros_like(x), x + 9, torch.full_like(x, 9.0)], dim=-1)[None]
    identical = torch.tensor([1.0, 2.0, 6.0, 5.0], device="cuda").expand(1, 1000, 4).contiguous()
    last_chunk = (torch.arange(k, device="cuda") >= (k - 1) // 32 * 32).expand(ncls, k).contiguous()
    return [
        ("random boxes", random_boxes(3, 1000, gen), ones(3, 1000)),
        ("real frame, 20% invalid", real.contiguous(), some_invalid.cuda()),
        ("real frame, all invalid", real.contiguous(), ~ones(ncls, k)),
        ("real frame, last chunk valid", real.contiguous(), last_chunk),
        ("chain of 1000", chain.contiguous(), ones(1, 1000)),
        ("1000 identical boxes", identical, ones(1, 1000)),
        ("random 1 x 33", random_boxes(1, 33, gen), ones(1, 33)),
        ("random 2 x 77", random_boxes(2, 77, gen), torch.rand((2, 77), generator=gen).cuda() >= 0.2),
        ("random 8 x 1024", random_boxes(8, 1024, gen), torch.rand((8, 1024), generator=gen).cuda() >= 0.2),
    ]


def check_nms(candidates, iou_threshold: float) -> dict:
    from det3d_tpu_torch.kernels import nms_cuda as nc

    gen = torch.Generator().manual_seed(SEED + 1)
    cases = nms_cases(candidates, gen)
    for name, boxes, valid in cases:
        got = nc.nms_keep_cuda(boxes, valid, iou_threshold)
        want = nc.nms_keep_plain(boxes, valid, iou_threshold)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        print(f"nms {name:28s} {tuple(valid.shape)}: keep equal={equal} kept={int(got.sum())} "
              f"of {int(valid.sum())} valid")
        check(equal, f"nms keep mask differs from the plain version on '{name}'")
    check(int(nc.nms_keep_cuda(*cases[4][1:], iou_threshold).sum()) == 500, "the chain keeps every other box")
    check(int(nc.nms_keep_cuda(*cases[5][1:], iou_threshold).sum()) == 1, "identical boxes keep the first")
    _, boxes, valid = cases[1]
    ms = cuda_ms(lambda: nc.nms_keep_cuda(boxes, valid, iou_threshold))
    # the two launches apart, over one scratch mask (the sweep reads what the mask kernel left there)
    mask = nc.mask_scratch(boxes)
    mask_ms = cuda_ms(lambda: nc.launch(boxes, valid, iou_threshold, mask, parts=1))
    sweep_ms = cuda_ms(lambda: nc.launch(boxes, valid, iou_threshold, mask, parts=2))
    plain_ms = cuda_ms(lambda: nc.nms_keep_plain(boxes, valid, iou_threshold), iters=5, warmup=1)
    nv = valid.sum(dim=1).double()
    ops = float((nv * (nv - 1) / 2).sum()) * NMS_OPS_PER_PAIR
    moved = boxes.numel() * 4 + 2 * valid.numel()
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    print(f"nms (3 x {boxes.shape[1]}, one call, two launches) kernel_ms={ms:.4f} (mask kernel alone {mask_ms:.4f}, "
          f"sweep alone {sweep_ms:.4f}; prev_ms={NMS_PREV_MS}, the one-block-per-class kernel it replaced) "
          f"plain_ms={plain_ms:.4f} library_ms=none bound_ms={bound_ms:.6f} ({bound_by}); "
          f"host ms per call {host_ms(lambda: nc.nms_keep_cuda(boxes, valid, iou_threshold)):.4f}")
    for name, b, v in (cases[4], cases[8]):
        print(f"nms {name}: kernel_ms={cuda_ms(lambda: nc.nms_keep_cuda(b, v, iou_threshold)):.4f}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0)


def assert_detections_close(a, b, what: str) -> None:
    """tests/test_golden_e2e.py tolerances: valid equal, boxes 1e-4, scores 1e-5."""
    va, vb = a.valid.cpu(), b.valid.cpu()
    check(torch.equal(va, vb), f"{what}: valid sets differ ({int(va.sum())} vs {int(vb.sum())})")
    torch.testing.assert_close(a.boxes.cpu()[va], b.boxes.cpu()[va], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(a.scores.cpu()[va], b.scores.cpu()[va], rtol=1e-5, atol=1e-5)
    print(f"{what}: valid equal ({int(va.sum())} detections), boxes and scores within tolerance")


@torch.no_grad()
def stage_breakdown(det, frames) -> dict[str, float]:
    """Median ms of each stage of `Detector.detect` over `frames`, host clock
    with a synchronize after every stage (so the stages do not overlap)."""
    model, post = det.model, det.postprocess
    spans: dict[str, list[float]] = {}
    for pts_np in frames:
        marks = [("start", time.perf_counter())]

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        padded, n = det.pad_points(pts_np)
        pts = torch.from_numpy(padded).cuda()
        mark("pad + copy to card")
        frame, anchors_mask = det.preprocess(pts, int(n))
        mark("voxelize + anchor mask")
        feats = model.pillar_point_net(frame.voxels[None], frame.num_points_per_voxel[None], frame.coors[None])
        mark("PFN")
        layout = model.layout(1, False)
        canvas = model.canvas(feats, frame.coors[None], layout)
        mark("BEV scatter (kernel)")
        x = model.rpn(canvas, *layout)
        mark("RPN")
        preds = model.heads(x)
        mark("head")
        cands = post.decode_stage({k: v[0] for k, v in preds.items()}, anchors_mask)
        mark("decode (gate, top-k, decode)")
        post.finalize_stage(cands)
        mark("finalize (NMS kernel, compaction)")
        for (_, t0), (name, t1) in zip(marks, marks[1:]):
            spans.setdefault(name, []).append((t1 - t0) * 1e3)
    return {name: statistics.median(v) for name, v in spans.items()}


def device_time(det, frames) -> tuple[float, list[tuple[str, float]]] | None:
    """Device time per `Detector.detect` frame from a torch.profiler trace
    (sum of the card's kernel, memset and memcpy spans), and the top device
    ops by time per frame; None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for pts_np in frames:
            det.detect(pts_np)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / len(frames)
    if not by_name:
        return None
    return sum(by_name.values()), sorted(by_name.items(), key=lambda kv: -kv[1])[:12]


def train_scenes(cfg, seed: int):
    """Two seeded ~100k-point scenes with 20-40 gt boxes each."""
    from det3d_tpu_torch.data.synthetic import sample_scene

    rng = np.random.RandomState(seed)
    return [sample_scene(cfg, rng, (20, 40), ground_points=TRAIN_POINTS) for _ in range(TRAIN_BATCH)]


MATCHER_CASES = ("real frames", "no valid gt", "every anchor masked", "a class's anchors masked",
                 "gt outside the range", "zero-size gt, one standup box twice", "matched threshold 0")


def matcher_inputs(trainer, batch, case: str):
    """(mask (B, A), gt_boxes, gt_bv, gt_classes, gt_valid) on the card."""
    from det3d_tpu_torch.targets import gt_standup

    masks = [trainer.detector.preprocess(batch.points[i], batch.num_points[i])[1] for i in range(TRAIN_BATCH)]
    mask = torch.stack(masks).reshape(TRAIN_BATCH, -1)
    gt_boxes, gt_classes, gt_valid = batch.gt_boxes.clone(), batch.gt_classes.clone(), batch.gt_valid
    if case == "no valid gt":
        gt_valid = torch.zeros_like(gt_valid)
    elif case == "every anchor masked":
        mask = torch.zeros_like(mask)
    elif case == "a class's anchors masked":  # its valid gt end at -1, the others' at >= 0
        start = trainer.assigner.tables.class_start.tolist()
        mask[:, start[1] : start[2]] = False
    elif case == "gt outside the range":
        gt_boxes[..., :2] += 500.0
    elif case == "zero-size gt, one standup box twice":
        gt_boxes[:, 1, 3:5] = 0.0
        # row 3 ties with row 2 on every anchor and differs in z and height:
        # the first of the two must be the one matched
        gt_boxes[:, 3] = gt_boxes[:, 2]
        gt_boxes[:, 3, 2] += 1.0
        gt_boxes[:, 3, 5] *= 1.2
        gt_classes[:, 3] = gt_classes[:, 2]
    return mask, gt_boxes, gt_standup(gt_boxes), gt_classes, gt_valid


def matcher_cull_stats(tables, mask, gt_bv, gt_classes, gt_valid) -> dict:
    """What the matcher's cull leaves of this input, counted with tensor
    operations: per (sample, anchor chunk) the candidate gt (valid, of the
    chunk's classes, box not disjoint from the chunk's box), the pairs of an
    included anchor and a candidate of its class that the kernels visit, and
    those of them that overlap."""
    from det3d_tpu_torch.kernels import matcher_cuda as mc

    a, dev = mask.shape[1], mask.device
    nchunks = tables.chunk_bv.shape[0]
    bounds = tables.class_start.long()[1:-1].contiguous()
    first = torch.arange(nchunks, device=dev) * mc.CHUNK
    c_lo = torch.bucketize(first, bounds, right=True)
    c_hi = torch.bucketize((first + mc.CHUNK).clamp(max=a) - 1, bounds, right=True)
    cls = torch.where(gt_valid, gt_classes.long() - 1, -1)              # (B, G)
    cb, gb = tables.chunk_bv[None, :, None, :], gt_bv[:, None, :, :]    # (1, C, 1, 4), (B, 1, G, 4)
    cand = ((cls[:, None, :] >= c_lo[None, :, None]) & (cls[:, None, :] <= c_hi[None, :, None])
            & ~(gb[..., 2] <= cb[..., 0]) & ~(cb[..., 2] <= gb[..., 0])
            & ~(gb[..., 3] <= cb[..., 1]) & ~(cb[..., 3] <= gb[..., 1]))  # (B, C, G)
    per_chunk = cand.sum(-1)
    b_i, ch_i, g_i = cand.nonzero(as_tuple=True)
    idx = ch_i[:, None] * mc.CHUNK + torch.arange(mc.CHUNK, device=dev)
    exists = idx < a
    idx = idx.clamp(max=a - 1)
    active = exists & mask[b_i[:, None], idx] & (torch.bucketize(idx, bounds, right=True) == cls[b_i, g_i][:, None])
    q, g4 = tables.anchors_bv[idx], gt_bv[b_i, g_i][:, None, :]
    iw = torch.minimum(g4[..., 2], q[..., 2]) - torch.maximum(g4[..., 0], q[..., 0])
    ih = torch.minimum(g4[..., 3], q[..., 3]) - torch.maximum(g4[..., 1], q[..., 1])
    return dict(
        chunks=per_chunk.numel(), none=int((per_chunk == 0).sum()), one=int((per_chunk == 1).sum()),
        more=int((per_chunk > 1).sum()), most=int(per_chunk.max()), candidates=int(cand.sum()),
        reached_chunks=int((per_chunk.sum(0) > 0).sum()),  # chunks whose anchors_bv some sample needs
        visited=int(active.sum()), overlapping=int((active & (iw > 0) & (ih > 0)).sum()),
    )


def check_matcher(trainer, batch) -> dict:
    """Both matcher kernels against the plain dense assignment on the card."""
    import dataclasses

    from det3d_tpu_torch.kernels import matcher_cuda as mc
    from det3d_tpu_torch.targets import make_target_assigner

    fx, fy = trainer.assigner.grid_hw
    zero_thr = tuple(dataclasses.replace(s, matched_threshold=0.0, unmatched_threshold=0.0)
                     for s in trainer.cfg.class_specs)
    result = {"max_abs_err": 0.0, "gt_max_err": 0.0}
    for case in MATCHER_CASES:
        assigner = trainer.assigner
        if case == "matched threshold 0":  # an included anchor is positive on a row of zeros
            assigner = make_target_assigner(trainer.cfg.replace(class_specs=zero_thr), trainer.detector.anchor_set,
                                            "cuda")
        tables = assigner.tables
        mask, gt_boxes, gt_bv, gt_classes, gt_valid = matcher_inputs(trainer, batch, case)
        spatial = mask.reshape(TRAIN_BATCH, -1, fx, fy)
        got_max = mc.decode_gt_max(mc.gt_max_bits_cuda(tables, mask, gt_boxes, gt_bv, gt_classes, gt_valid))
        want_max = assigner.gt_max_plain(gt_boxes, gt_classes, gt_valid, spatial)
        got = assigner.kernel(gt_boxes, gt_classes, gt_valid, spatial)
        want = assigner.plain(gt_boxes, gt_classes, gt_valid, spatial)
        torch.cuda.synchronize()
        check(torch.equal(got_max, want_max), f"matcher gt-max differs from the plain version on '{case}'")
        for name in ("labels", "bbox_outside_weights", "dir_targets"):
            check(torch.equal(getattr(got, name), getattr(want, name)), f"matcher {name} differ on '{case}'")
        err = (got.bbox_targets - want.bbox_targets).abs().max().item()
        torch.testing.assert_close(got.bbox_targets, want.bbox_targets, rtol=1e-6, atol=1e-6)
        labels = got.labels
        print(f"matcher {case:36s}: labels/weights/dir equal, gt-max equal (valid gt at -1: "
              f"{int((got_max[gt_valid] < 0).sum())}, at 0: {int((got_max[gt_valid] == 0).sum())}), "
              f"targets max_abs_err={err:.3e}; positives {int((labels > 0).sum())}, "
              f"negatives {int((labels == 0).sum())}, ignored {int((labels < 0).sum())}")
        result["max_abs_err"] = max(result["max_abs_err"], err)

    assigner = trainer.assigner
    tables = assigner.tables
    mask, gt_boxes, gt_bv, gt_classes, gt_valid = matcher_inputs(trainer, batch, "real frames")
    spatial = mask.reshape(TRAIN_BATCH, -1, fx, fy)
    args = (tables, mask, gt_boxes, gt_bv, gt_classes, gt_valid)
    bits = mc.gt_max_bits_cuda(*args)
    result["gt_max_ms"] = cuda_ms(lambda: mc.gt_max_bits_cuda(*args))
    result["assign_ms"] = cuda_ms(lambda: mc.assign_cuda(*args, bits))
    print(f"matcher, one call of both passes (match_cuda): {cuda_ms(lambda: mc.match_cuda(*args)):.4f} ms")
    print(f"matcher host ms per call (wrapper + launch): gt-max {host_ms(lambda: mc.gt_max_bits_cuda(*args)):.4f}, "
          f"assign {host_ms(lambda: mc.assign_cuda(*args, bits)):.4f}, "
          f"TargetAssigner.kernel {host_ms(lambda: assigner.kernel(gt_boxes, gt_classes, gt_valid, spatial)):.4f}")
    plain = (gt_boxes, gt_classes, gt_valid, spatial)
    result["gt_max_plain_ms"] = cuda_ms(lambda: assigner.gt_max_plain(*plain), iters=5, warmup=1)
    result["assign_plain_ms"] = cuda_ms(lambda: assigner.plain(*plain), iters=5, warmup=1)

    # bounds from this run's inputs: every byte the function needs read
    # once, every output written once; operations over the pairs this data
    # needs. The function needs the mask, the gt, the anchors' yaw plane
    # (dir) and every output; it needs an anchor's standup box only where a
    # gt reaches its chunk, and its other six planes only where it is positive.
    a = tables.anchors.shape[0]
    g = gt_valid.shape[1]
    hw = fx * fy
    pairs = 0
    for b in range(TRAIN_BATCH):
        for ci, (c0, c1) in enumerate(assigner.channels):
            included = int(mask[b, c0 * hw : c1 * hw].sum())
            valid = int((gt_valid[b] & (gt_classes[b] == ci + 1)).sum())
            pairs += included * valid
    stats = matcher_cull_stats(tables, mask, gt_bv, gt_classes, gt_valid)
    positives = int((assigner.kernel(*plain).labels > 0).sum())
    print(f"matcher cull on the real frames: {stats}; {pairs} (included anchor, valid gt of its class) pairs, "
          f"{positives} positives")
    gt_bytes = TRAIN_BATCH * g * (16 + 4 + 1)
    reached = stats["reached_chunks"] * mc.CHUNK * 16 + tables.chunk_bv.numel() * 4
    old_pass1 = a * 16 + TRAIN_BATCH * a + gt_bytes + TRAIN_BATCH * g * 4
    old_pass2 = a * (28 + 16) + TRAIN_BATCH * a + gt_bytes + TRAIN_BATCH * g * (28 + 4) \
        + TRAIN_BATCH * a * (4 + 28 + 4 + 4)
    pass1_bytes = TRAIN_BATCH * a + gt_bytes + TRAIN_BATCH * g * 4 + reached
    pass2_bytes = TRAIN_BATCH * a * (4 + 28 + 4 + 4) + TRAIN_BATCH * a + a * 4 + gt_bytes \
        + TRAIN_BATCH * g * (28 + 4) + reached + positives * 24
    print(f"matcher bytes counted before the cull (all of anchors and anchors_bv read once): pass 1 {old_pass1} "
          f"({old_pass1 / HBM_BYTES_PER_S * 1e3:.5f} ms), pass 2 {old_pass2} ({old_pass2 / HBM_BYTES_PER_S * 1e3:.5f} ms); "
          f"counted for what these inputs need: pass 1 {pass1_bytes}, pass 2 {pass2_bytes}")
    disjoint = (stats["visited"] - stats["overlapping"]) * MATCH_OPS_DISJOINT
    for key, moved, ops, prev in (
            ("gt_max", pass1_bytes, stats["overlapping"] * MATCH_OPS_PASS1 + disjoint, MATCHER_GT_MAX_PREV_MS),
            ("assign", pass2_bytes, stats["overlapping"] * MATCH_OPS_PASS2 + disjoint, MATCHER_ASSIGN_PREV_MS)):
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        result[f"{key}_bound_ms"] = max(t_bytes, t_ops) * 1e3
        result[f"{key}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        check(result[f"{key}_ms"] >= result[f"{key}_bound_ms"], f"matcher {key} reads faster than its bound")
        print(f"matcher {key}: kernel_ms={result[f'{key}_ms']:.4f} (prev_ms={prev}, the kernel without the cull) "
              f"plain_ms={result[f'{key}_plain_ms']:.4f} "
              f"library_ms=none bound_ms={result[f'{key}_bound_ms']:.5f} ({result[f'{key}_bound_by']}; "
              f"{moved} bytes, {ops} operations over {stats['overlapping']} overlapping of {stats['visited']} visited pairs)")
    return result


def check_scatter_bwd(grid_xy, v: int, c: int) -> dict:
    """The backward gather against the plain gather, bit for bit, on a
    channels-last cotangent like the one the first convolution returns."""
    from det3d_tpu_torch.kernels import scatter_cuda as sc

    gen = torch.Generator().manual_seed(SEED + 2)
    nx, ny = grid_xy
    result = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for n_valid in (12_000, 0):
            _, coors = scatter_inputs(v, c, grid_xy, n_valid, dtype, gen)
            grad = torch.randn((TRAIN_BATCH, c, nx, ny), generator=gen).to(dtype).cuda()
            grad = grad.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            coors = coors.expand(TRAIN_BATCH, -1, -1).contiguous()
            got = sc.scatter_to_bev_bwd_cuda(grad, coors)
            want = sc.scatter_to_bev_bwd_plain(grad, coors)
            torch.cuda.synchronize()
            equal = torch.equal(bits(got), bits(want))
            print(f"scatter bwd {str(dtype):15s} valid={n_valid:5d}: bit-equal={equal}")
            check(equal, f"scatter backward {dtype} with {n_valid} pillars differs from the plain gather")
        _, coors = scatter_inputs(v, c, grid_xy, 12_000, dtype, gen)
        coors = coors.expand(TRAIN_BATCH, -1, -1).contiguous()
        grad = torch.randn((TRAIN_BATCH, c, nx, ny), generator=gen).to(dtype).cuda()
        grad = grad.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        bi, x, y, keep = sc._kept_rows(coors, grid_xy)
        idx = (bi[keep], x[keep], y[keep])
        ms = cuda_ms(lambda: sc.scatter_to_bev_bwd_cuda(grad, coors))
        plain_ms = cuda_ms(lambda: sc.scatter_to_bev_bwd_plain(grad, coors))
        library_ms = cuda_ms(lambda: grad[idx])
        kept = int(keep.sum())
        moved = (kept * c + TRAIN_BATCH * v * c) * grad.element_size() + coors.numel() * 4
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        print(f"scatter bwd {str(dtype):15s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (advanced indexing) bound_ms={bound_ms:.5f} (bytes); "
              f"host ms per call {host_ms(lambda: sc.scatter_to_bev_bwd_cuda(grad, coors)):.4f}")
        result[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms)
    return result


def check_fence(preds: dict[str, torch.Tensor]) -> dict:
    """The fence copy against the contiguous-format `clone`, bit for bit, on
    the head's three strided views and on other layouts, each through the
    kernel that `copy_plan` names; then its time on the `cls_preds` view."""
    from det3d_tpu_torch.kernels import fence_cuda as fc

    preds_cls = preds["cls_preds"]
    b, _, a, h, w = preds_cls.shape
    head32 = torch.randn(b, a * 10, h, w, device="cuda").contiguous(memory_format=torch.channels_last)
    views = [(f"{name} view", x) for name, x in preds.items()]
    views += [
        ("cls_preds view, f32", head32[:, :a].reshape(b, a, 1, h, w).transpose(1, 2)),
        ("contiguous", preds_cls.contiguous()),
        ("odd-sized f32", torch.randn(7, 13, 5, device="cuda")),
        ("odd offset", preds_cls.contiguous().flatten()[1:]),
        ("rank 6, strided", torch.randn(3, 4, 5, 6, 7, 8, device="cuda")[::2, :, 1:, ::3].permute(0, 5, 2, 3, 4, 1)),
    ]
    for name, x in views:
        route = fc.copy_plan(x).route
        before = fc.route_launches[route]
        got, want = fc.fence_copy_cuda(x), x.clone(memory_format=torch.contiguous_format)
        torch.cuda.synchronize()
        equal = torch.equal(bits(got), bits(want)) and torch.equal(bits(fc.fence_copy_plain(x)), bits(want))
        print(f"fence {name:20s} {tuple(x.shape)} {x.dtype} strides {x.stride()} offset {x.storage_offset()}: "
              f"{route} kernel, bit-equal={equal} contiguous={got.is_contiguous()}")
        check(equal and got.is_contiguous(), f"fence copy differs from the contiguous clone on the {name}")
        check(fc.route_launches[route] == before + 1, f"the {route} kernel was not launched for the {name}")
        if name.startswith("cls_preds view"):
            check(route == "transpose", f"the {name} took the {route} kernel")
        if name in ("contiguous", "odd offset"):
            check(route == "contiguous", f"the {name} tensor took the {route} kernel")
    del head32, views

    kernel = lambda: fc.fence_copy_cuda(preds_cls)
    library = lambda: preds_cls.clone(memory_format=torch.contiguous_format)
    keep_order = lambda: preds_cls.clone()  # keeps the view's stride order: no transpose, an easier function
    ms, library_ms, keep_order_ms = cuda_ms(kernel), cuda_ms(library), cuda_ms(keep_order)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    moved = 2 * preds_cls.numel() * preds_cls.element_size()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"fence {tuple(preds_cls.shape)} kernel_ms={ms:.4f} (prev_ms={FENCE_PREV_MS}, one element per thread) "
          f"plain_ms=library_ms={library_ms:.4f} (clone(memory_format=contiguous_format)) "
          f"clone_keep_order_ms={keep_order_ms:.4f} bound_ms={bound_ms:.5f} (bytes); "
          f"host ms per call {host_ms(kernel):.4f}")
    print("fence, single calls between CUDA events, median of 10, warm L2 / after a "
          f"{L2_FLUSH_BYTES >> 20} MB zero_(): kernel {single_call_ms(kernel):.4f} / "
          f"{single_call_ms(kernel, flush):.4f}, library {single_call_ms(library):.4f} / "
          f"{single_call_ms(library, flush):.4f}, clone keeping order {single_call_ms(keep_order):.4f} / "
          f"{single_call_ms(keep_order, flush):.4f}")
    for name in ("box_preds", "dir_preds"):
        x = preds[name]
        print(f"fence {name} view: kernel_ms={cuda_ms(lambda: fc.fence_copy_cuda(x)):.4f} library_ms="
              f"{cuda_ms(lambda: x.clone(memory_format=torch.contiguous_format)):.4f}")
    return dict(ms=ms, plain_ms=library_ms, library_ms=library_ms, bound_ms=bound_ms, max_abs_err=0.0)


def layout_inputs(b: int, v: int, c: int, grid_xy, n_valid: int, dtype, gen: torch.Generator):
    """Features (b, v, c) and coordinates on the card: n_valid pillars on
    unique cells of each sample, at random slots, -1 rows elsewhere."""
    nx, ny = grid_xy
    feats = torch.randn((b, v, c), generator=gen).to(dtype)
    coors = torch.full((b, v, 3), -1, dtype=torch.int32)
    for i in range(b):
        cells = torch.randperm(nx * ny, generator=gen)[:n_valid]
        slots = torch.randperm(v, generator=gen)[:n_valid]
        coors[i, slots, 0] = (cells // ny).to(torch.int32)
        coors[i, slots, 1] = (cells % ny).to(torch.int32)
        coors[i, slots, 2] = 0
    return feats.cuda(), coors.cuda()


def check_layout_scatters(grid_xy, v: int, c: int, nblk: int, halo) -> dict:
    """The s2d and blocked scatters and their backwards against their plain
    versions, bit for bit, in f32 and bf16 at batch 1 and 2 (phase 9); then
    their times at the main path's shapes: the s2d scatter at batch 1 (packed
    inference), the blocked scatter, both backwards at batch 2 (the train
    step). Bounds: each input read once, each output written once (the
    backwards read only the kept rows and their halo copies)."""
    from det3d_tpu_torch.kernels import scatter_cuda as sc

    gen = torch.Generator().manual_seed(SEED + 3)
    nx, ny = grid_xy
    nx2, ny2 = nx // 2, ny // 2
    rb, rtot = sc.blocked_rows(grid_xy, nblk, halo)
    result = {name: {"max_abs_err": 0.0} for name in LAYOUT_COUNTERS}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 2):
            for n_valid in (12_000, 0):
                feats, coors = layout_inputs(b, v, c, grid_xy, n_valid, dtype, gen)
                cases = [(f"s2d w_major={wm}", sc.scatter_to_bev_s2d_cuda(feats, coors, grid_xy, wm),
                          sc.scatter_to_bev_s2d_plain(feats, coors, grid_xy, wm)) for wm in (False, True)]
                cases.append(("blocked", sc.scatter_to_bev_s2d_blocked_cuda(feats, coors, grid_xy, nblk, halo),
                              sc.scatter_to_bev_s2d_blocked_plain(feats, coors, grid_xy, nblk, halo)))
                g = torch.randn((b, 4 * c, nx2, ny2), generator=gen).to(dtype).cuda()
                g = g.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)  # as the entry conv returns it
                cases.append(("s2d bwd", sc.scatter_to_bev_s2d_bwd_cuda(g, coors),
                              sc.scatter_to_bev_s2d_bwd_plain(g, coors)))
                g5 = torch.randn((b * nblk, 4 * c, rtot, ny2), generator=gen).to(dtype).cuda()
                g5 = g5.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).unflatten(0, (b, nblk))
                cases.append(("blocked bwd", sc.scatter_to_bev_s2d_blocked_bwd_cuda(g5, coors, halo),
                              sc.scatter_to_bev_s2d_blocked_bwd_plain(g5, coors, halo)))
                torch.cuda.synchronize()
                for name, got, want in cases:
                    equal = got.stride() == want.stride() and torch.equal(bits(got), bits(want))
                    err = (got.float() - want.float()).abs().max().item()
                    print(f"{name:17s} {str(dtype):15s} batch {b} valid={n_valid:5d}: bit-equal={equal}")
                    check(equal, f"{name} {dtype} batch {b} with {n_valid} pillars differs from the plain version")
                    key = {"blocked": "blocked_fwd", "s2d bwd": "s2d_bwd", "blocked bwd": "blocked_bwd"}.get(
                        name, "s2d_fwd")
                    result[key]["max_abs_err"] = max(result[key]["max_abs_err"], err)

        elt = torch.finfo(dtype).bits // 8
        coors_bytes = v * 3 * 4
        for key, b in (("s2d_fwd", 1), ("blocked_fwd", 2), ("s2d_bwd", 2), ("blocked_bwd", 2)):
            feats, coors = layout_inputs(b, v, c, grid_xy, 12_000, dtype, gen)
            bi, x2, y2, phase, keep = sc._s2d_index(coors, grid_xy)
            kept = int(keep.sum())
            if key == "s2d_fwd":
                idx = (bi[keep], x2[keep], y2[keep], phase[keep])
                rows = feats[keep]
                fn = lambda: sc.scatter_to_bev_s2d_cuda(feats, coors, grid_xy)
                plain = lambda: sc.scatter_to_bev_s2d_plain(feats, coors, grid_xy)
                library = lambda: torch.zeros((b, nx2, ny2, 4, c), dtype=dtype, device="cuda").index_put_(idx, rows)
                moved = (b * nx * ny * c + b * v * c) * elt + b * coors_bytes
            elif key == "blocked_fwd":
                _, y2b, phb, places = sc._blocked_places(coors, grid_xy, nblk, halo)
                idx = tuple(torch.cat(parts) for parts in zip(*[
                    (bi[p], blk[p], row[p], y2b[p], phb[p]) for p, blk, row in places]))
                rows = torch.cat([feats[p] for p, _, _ in places])
                fn = lambda: sc.scatter_to_bev_s2d_blocked_cuda(feats, coors, grid_xy, nblk, halo)
                plain = lambda: sc.scatter_to_bev_s2d_blocked_plain(feats, coors, grid_xy, nblk, halo)
                library = lambda: torch.zeros((b, nblk, rtot, ny2, 4, c), dtype=dtype,
                                              device="cuda").index_put_(idx, rows)
                moved = (b * nblk * rtot * ny2 * 4 * c + b * v * c) * elt + b * coors_bytes
            elif key == "s2d_bwd":
                g = torch.randn((b, 4 * c, nx2, ny2), generator=gen).to(dtype).cuda()
                g = g.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
                idx = (bi[keep], x2[keep], y2[keep], phase[keep])
                g5 = g.unflatten(-1, (4, c))
                fn = lambda: sc.scatter_to_bev_s2d_bwd_cuda(g, coors)
                plain = lambda: sc.scatter_to_bev_s2d_bwd_plain(g, coors)
                library = lambda: g5[idx]
                moved = (kept * c + b * v * c) * elt + b * coors_bytes
            else:
                g = torch.randn((b * nblk, 4 * c, rtot, ny2), generator=gen).to(dtype).cuda()
                g = g.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).unflatten(0, (b, nblk))
                copies = sum(int(p.sum()) for p, _, _ in sc._blocked_places(coors, grid_xy, nblk, halo)[3])
                fn = lambda: sc.scatter_to_bev_s2d_blocked_bwd_cuda(g, coors, halo)
                plain = lambda: sc.scatter_to_bev_s2d_blocked_bwd_plain(g, coors, halo)
                library = None  # the halo sum needs a gather and a scatter-add: no one-call equivalent
                moved = (copies * c + b * v * c) * elt + b * coors_bytes
            t = dict(ms=cuda_ms(fn), plain_ms=cuda_ms(plain, iters=10, warmup=2),
                     library_ms=None if library is None else cuda_ms(library),
                     bound_ms=moved / HBM_BYTES_PER_S * 1e3)
            lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
            print(f"{key:12s} {str(dtype):15s} batch {b}: kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={lib} bound_ms={t['bound_ms']:.5f} (bytes: {moved}); "
                  f"host ms per call {host_ms(fn):.4f}")
            result[key][dtype] = t
    return result


@torch.no_grad()
def run_frames(det, frames, counters) -> dict:
    """`Detector.detect` over `frames` after one warm-up frame, with every
    counter set to 0 just before and read just after: ms/frame, peak
    memory, launches."""
    det.detect(frames[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    times, detections = [], []
    for pts_np in frames[1:]:
        t0 = time.perf_counter()
        annos = det.detect(pts_np)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        detections.append(len(annos["score"]))
        for key in ("location", "dimensions", "rotation_y", "score"):
            check(bool(np.isfinite(annos[key]).all()), f"non-finite {key}")
    return dict(ms=statistics.median(times), min=min(times), max=max(times), n=len(times),
                peak=torch.cuda.max_memory_allocated(), launches={k: c.launches for k, c in counters.items()},
                detections=detections)


def run_steps(trainer, state, batch, steps: int, counters) -> dict:
    """`Trainer.train_step` over `steps` steps of one batch after warm-up
    steps, counters set to 0 just before and read just after: ms/step, peak
    memory, launches, the loss by step."""
    for _ in range(TRAIN_WARMUP):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    times, history = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in loss.items()})
    for h in history:
        check(all(np.isfinite(v) for v in h.values()), f"non-finite loss term in {h}")
    check(history[-1]["loss"] < history[0]["loss"], "the loss did not fall on the repeated batch")
    return dict(ms=statistics.median(times), min=min(times), max=max(times), n=steps,
                peak=torch.cuda.max_memory_allocated(), launches={k: c.launches for k, c in counters.items()},
                history=history, metrics=metrics)


TRAIN_COUNTERS = ("matcher_gt_max", "matcher_assign", "scatter_fwd", "scatter_bwd", "fence", "nms")
LAYOUT_COUNTERS = ("s2d_fwd", "s2d_bwd", "blocked_fwd", "blocked_bwd")


def train_counters(layouts: bool = False):
    """The launch counters of the train path's kernels; with `layouts`,
    the layout path's four scatter kernels too."""
    from det3d_tpu_torch.kernels import fence_cuda, matcher_cuda, nms_cuda, scatter_cuda

    counters = dict(zip(TRAIN_COUNTERS, (matcher_cuda.gt_max_counter, matcher_cuda.assign_counter,
                                         scatter_cuda.counter, scatter_cuda.bwd_counter, fence_cuda.counter,
                                         nms_cuda.counter)))
    if layouts:
        counters.update(zip(LAYOUT_COUNTERS, (scatter_cuda.s2d_counter, scatter_cuda.s2d_bwd_counter,
                                              scatter_cuda.blocked_counter, scatter_cuda.blocked_bwd_counter)))
    return counters


def train_stage_breakdown(trainer, state, batch, steps: int) -> dict[str, float]:
    """Median ms of each stage of `Trainer.train_step`, host clock with a
    synchronize after every stage."""
    from det3d_tpu_torch.losses import detection_loss

    spans: dict[str, list[float]] = {}
    for _ in range(steps):
        marks = [("start", time.perf_counter())]

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        dev_batch = trainer.to_device(batch)
        mark("host batch to card")
        frames, tgt = trainer.prepare(dev_batch)
        mark("prepare (voxelize, mask, assign)")
        preds = trainer.model(frames.voxels, frames.num_points_per_voxel, frames.coors, train=True)
        preds = dict(preds, cls_preds=trainer.fence(preds["cls_preds"]))
        mark("forward (+ fence)")
        loss_dict = detection_loss(preds, tgt.labels, tgt.bbox_targets, tgt.dir_targets)
        mark("loss")
        for p in trainer.params:
            p.grad = None
        loss_dict["loss"].backward()
        mark("backward")
        trainer.apply_gradients(state)
        mark("optimizer (clip + Adam)")
        for (_, t0), (name, t1) in zip(marks, marks[1:]):
            spans.setdefault(name, []).append((t1 - t0) * 1e3)
    return {name: statistics.median(v) for name, v in spans.items()}


def count_syncs(fn) -> list[str]:
    """The host-card synchronisations that one call of `fn` makes (as
    torch's sync debug mode reports them), by the line that made them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename.split('/')[-1]}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


def profile_device_time(fn, n: int) -> tuple[float, list[tuple[str, float]]] | None:
    """Device time per call of `fn` from a torch.profiler trace (sum of the
    card's kernel, memset and memcpy spans) and the top device ops per call;
    None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    if not by_name:
        return None
    return sum(by_name.values()), sorted(by_name.items(), key=lambda kv: -kv[1])[:12]


def use_plain_scatters(model) -> None:
    """Set the plain versions in place of every scatter kernel of `model`."""
    from det3d_tpu_torch.kernels import scatter_cuda

    model.scatter = scatter_cuda.scatter_to_bev_plain
    model.scatter_s2d = scatter_cuda.scatter_to_bev_s2d_plain
    model.scatter_s2d_blocked = scatter_cuda.scatter_to_bev_s2d_blocked_plain


def compare_train_steps(cfg32, batch) -> None:
    """One float32 step with the kernels against one with the plain
    versions, from the same weights and batch (phase 8). Tolerances of
    tests/test_torch_train.py: loss terms rtol 1e-5; gradients within 1e-4
    of each tensor's largest; updated parameters within 1e-6 where the
    gradient is above 1e-3 of its tensor's largest, else within 2·lr (Adam's
    first step is about lr·sign(g)); batch statistics rtol 1e-5."""
    from det3d_tpu_torch.kernels import fence_cuda
    from det3d_tpu_torch.train.trainer import Trainer

    runs = []
    for plain in (False, True):
        trainer = Trainer(cfg32)
        state = trainer.init_state(SEED)
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        if plain:
            trainer.assigner = trainer.assigner.plain
            use_plain_scatters(trainer.model)
            trainer.fence = fence_cuda.fence_copy_plain
        state, loss, _ = trainer.train_step(state, batch)
        grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
        runs.append((loss, grads, trainer.model.state_dict(), state.lr))
        del trainer
    (lk, gk, sk, lr), (lp, gp, sp, _) = runs
    for key in lk:
        torch.testing.assert_close(lk[key], lp[key], rtol=1e-5, atol=1e-6)
    print("f32 step, kernels vs plain: loss " + ", ".join(f"{k}={float(lk[k]):.6f}/{float(lp[k]):.6f}" for k in lk))
    worst_g = worst_p = worst_small = 0.0
    for name, g in gk.items():
        scale = gp[name].abs().max().item()
        dg = (g - gp[name]).abs().max().item()
        check(dg <= 1e-4 * scale + 1e-12, f"gradient of {name}: {dg} against scale {scale}")
        worst_g = max(worst_g, dg / max(scale, 1e-30))
        big = gp[name].abs() > 1e-3 * scale
        dp = (sk[name] - sp[name]).abs()
        if big.any():
            check(dp[big].max().item() <= 1e-6, f"updated {name} differs where the gradient is large")
            worst_p = max(worst_p, dp[big].max().item())
        check(dp.max().item() <= 2 * lr, f"updated {name} differs by more than 2·lr")
        worst_small = max(worst_small, dp.max().item())
    for name in sk:
        if "running" in name:
            torch.testing.assert_close(sk[name], sp[name], rtol=1e-5, atol=1e-6)
            check(not torch.equal(sk[name], before[name]), f"{name} was not updated")
    print(f"f32 step, kernels vs plain: gradients within {worst_g:.2e} of each tensor's largest; updated "
          f"params within {worst_p:.2e} where |g| is large, {worst_small:.2e} overall (lr {lr}); batch stats equal "
          "to rtol 1e-5")



def small_config():
    """A 32x32-grid geometry with the default 9 anchors per location."""
    from det3d_tpu_torch.config import load_config

    return load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5,
        "max_points": 4096, "compute_dtype": "float32",
    })


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.data.synthetic import sample_scene, synthetic_cloud
    from det3d_tpu_torch.kernels import build, nms_cuda, scatter_cuda
    from det3d_tpu_torch.pipeline import Detector

    t_start = time.time()
    phase("1. environment")
    card = card_line()
    print("nvidia-smi:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("cudnn.allow_tf32", torch.backends.cudnn.allow_tf32,
          "cuda.matmul.allow_tf32", torch.backends.cuda.matmul.allow_tf32)

    phase("2. build")
    t0 = time.time()
    logs = build.build_all()
    for name, log in logs.items():
        print(f"--- {name}.cu (ptxas -v)")
        print("\n".join(line for line in log.splitlines() if "ptxas" in line or "error" in line.lower()))
    print(f"built {sorted(logs)} in {time.time() - t0:.1f} s")

    cfg = load_config("configs/ntusl_20cm.json", max_points=120_000)
    check(cfg.compute_dtype == "bfloat16", "ntusl_20cm computes in bf16")
    det = Detector(cfg).init_weights(SEED)
    frames = [synthetic_cloud(cfg.max_points, N_POINTS, seed=SEED + i) for i in range(N_FRAMES + 1)]

    phase("3. kernels vs plain versions on the card")
    grid_xy = (cfg.grid_size[0], cfg.grid_size[1])
    scatter = check_scatter(grid_xy, cfg.max_voxels, 64)
    pts = torch.from_numpy(frames[0]).cuda()
    candidates = det.infer_candidates(pts, N_POINTS)
    nms = check_nms(candidates, det.postprocess.params.nms_iou_threshold)

    phase("4. main path at full width (ntusl_20cm, bf16)")
    print(f"grid {cfg.grid_size}, {cfg.max_voxels} pillars x {cfg.max_num_points} points, "
          f"{det.anchor_set.num_anchors} anchors, {N_POINTS} points per frame")
    run = run_frames(det, frames, {"scatter": scatter_cuda.counter, "nms": nms_cuda.counter})
    launches, frame_ms = run["launches"], run["ms"]
    print(f"ms/frame median {frame_ms:.3f} (host clock around detect + synchronize; "
          f"min {run['min']:.3f}, max {run['max']:.3f}) over {run['n']} frames")
    print(f"peak memory allocated {run['peak']} bytes; detections per frame {run['detections']}")
    print(f"launches on the main path: {launches}")
    for name, n in launches.items():
        check(n == run["n"], f"{name} kernel launched {n} times over {run['n']} frames")
    print("stage breakdown, median ms (synchronized after each stage):")
    for name, ms in stage_breakdown(det, frames[1:]).items():
        print(f"  {name:36s} {ms:.3f}")
    traced = device_time(det, frames[1:6])
    if traced is None:
        print("device time per frame: not measured (the profiler trace holds no device events)")
    else:
        busy, top = traced
        print(f"device time per frame (torch.profiler, 5 frames): {busy:.3f} ms = "
              f"{100 * busy / frame_ms:.1f}% of the {frame_ms:.3f} ms median frame")
        for name, ms in top:
            print(f"  {ms:8.3f} ms  {name[:100]}")
    d = det.infer(torch.from_numpy(frames[1]).cuda(), N_POINTS)
    ncls, post = len(cfg.class_specs), det.postprocess.params.nms_post_max_size
    check(tuple(d.boxes.shape) == (ncls, post, 7) and tuple(d.valid.shape) == (ncls, post), "Detections shape")
    check(bool(torch.isfinite(d.boxes).all()) and bool(torch.isfinite(d.scores).all()), "finite detections")

    phase("5. full path, kernels vs plain versions (f32), and the card vs the CPU")
    cfg32 = cfg.replace(compute_dtype="float32")
    det32 = Detector(cfg32).init_weights(SEED)
    pts = torch.from_numpy(frames[2]).cuda()
    with_kernels = det32.infer(pts, N_POINTS)
    det32.model.scatter = scatter_cuda.scatter_to_bev_plain
    det32.postprocess.nms_keep = nms_cuda.nms_keep_plain
    with_plain = det32.infer(pts, N_POINTS)
    assert_detections_close(with_kernels, with_plain, "ntusl_20cm f32, kernels vs plain")

    small = small_config()
    on_card = Detector(small).init_weights(SEED)
    on_cpu = Detector(small, device="cpu").init_weights(SEED)
    rng = np.random.RandomState(SEED)
    for i in range(3):
        padded, n = on_card.pad_points(sample_scene(small, rng, (2, 6), ground_points=1200)["points"])
        a = on_card.infer(torch.from_numpy(padded).cuda(), int(n))
        b = on_cpu.infer(torch.from_numpy(padded), int(n))
        assert_detections_close(a, b, f"small geometry frame {i}, card vs CPU")

    phase("6. train-path kernels vs plain versions on the card")
    from det3d_tpu_torch.train.trainer import Trainer, host_batch

    trainer = Trainer(cfg)
    state = trainer.init_state(SEED)
    batch = host_batch(cfg, train_scenes(cfg, SEED))
    print(f"batch of {TRAIN_BATCH}: points {batch.num_points.tolist()}, valid gt {batch.gt_valid.sum(1).tolist()} "
          f"(classes {[np.bincount(c[v], minlength=4)[1:].tolist() for c, v in zip(batch.gt_classes, batch.gt_valid)]})")
    dev_batch = trainer.to_device(batch)
    matcher = check_matcher(trainer, dev_batch)
    scatter_bwd = check_scatter_bwd(grid_xy, cfg.max_voxels, 64)
    with torch.no_grad():
        vox, tgt = trainer.prepare(dev_batch)
        preds = trainer.model(vox.voxels, vox.num_points_per_voxel, vox.coors)
    fence = check_fence(preds)
    del vox, tgt, preds  # so that the peaks below count only their own phase

    phase("7. train step at full width (ntusl_20cm, bf16, batch 2)")
    run = run_steps(trainer, state, batch, TRAIN_STEPS, train_counters())
    train_launches, step_ms, history, metrics = run["launches"], run["ms"], run["history"], run["metrics"]
    print(f"ms/step median {step_ms:.3f} (host clock around train_step + synchronize; min {run['min']:.3f}, "
          f"max {run['max']:.3f}) over {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up steps")
    print(f"peak memory allocated {run['peak']} bytes")
    print("loss by step: " + " ".join(f"{h['loss']:.4f}" for h in history))
    print(f"last step: {history[-1]}; metrics tp {metrics['tp'].tolist()} fp {metrics['fp'].tolist()} "
          f"fn {metrics['fn'].tolist()}")
    print(f"launches over {TRAIN_STEPS} steps: {train_launches}")
    expected = {name: TRAIN_STEPS for name in TRAIN_COUNTERS}
    expected["nms"] = 0
    check(train_launches == expected, f"train-path launches {train_launches}, expected {expected}")
    syncs = count_syncs(lambda: trainer.train_step(state, batch))
    print(f"host-card synchronisations in one train_step: {len(syncs)} "
          f"({', '.join(f'{k} x{v}' for k, v in sorted(collections.Counter(syncs).items()))})")
    print("stage breakdown, median ms over 5 steps (synchronized after each stage):")
    for name, ms in train_stage_breakdown(trainer, state, batch, 5).items():
        print(f"  {name:36s} {ms:.3f}")
    traced = profile_device_time(lambda: trainer.train_step(state, batch), 3)
    if traced is None:
        print("device time per step: not measured (the profiler trace holds no device events)")
    else:
        busy, top = traced
        print(f"device time per step (torch.profiler, 3 steps): {busy:.3f} ms = "
              f"{100 * busy / step_ms:.1f}% of the {step_ms:.3f} ms median step")
        for name, ms in top:
            print(f"  {ms:8.3f} ms  {name[:100]}")
    del trainer, state

    phase("8. f32 train step, kernels vs plain versions")
    compare_train_steps(cfg32, batch)

    phase("9. layout kernels vs plain versions on the card")
    from det3d_tpu_torch.models.pointpillars import Layout, block0_blocking

    nblk, halo = block0_blocking(grid_xy)
    layout_k = check_layout_scatters(grid_xy, cfg.max_voxels, 64, nblk, halo)

    phase("10. packed inference at full width (ntusl_20cm + pack_w, bf16)")
    counters = train_counters(layouts=True)
    frame_runs = {}
    for name, flags, layout in (("packed", dict(pack_w=True), Layout(True, False, False)),
                                ("packed + blocked", dict(pack_w=True, block0_blocked=True),
                                 Layout(True, True, False))):
        det_l = Detector(cfg.replace(**flags)).init_weights(SEED)
        check(det_l.model.layout(1, False) == layout, f"{name}: layout {det_l.model.layout(1, False)}")
        run = run_frames(det_l, frames, counters)
        frame_runs[name] = run
        print(f"{name}: ms/frame median {run['ms']:.3f} (min {run['min']:.3f}, max {run['max']:.3f}) over "
              f"{run['n']} frames; peak memory allocated {run['peak']} bytes")
        print(f"{name}: launches {run['launches']}")
        want = {k: 0 for k in counters}
        want.update(nms=run["n"], **{"blocked_fwd" if layout.block0_blocked else "s2d_fwd": run["n"]})
        check(run["launches"] == want, f"{name}: launches {run['launches']}, expected {want}")
        print(f"{name}: stage breakdown, median ms (synchronized after each stage):")
        for stage, ms in stage_breakdown(det_l, frames[1:]).items():
            print(f"  {stage:36s} {ms:.3f}")
        traced = device_time(det_l, frames[1:6])
        if traced is not None:
            print(f"{name}: device time per frame (torch.profiler, 5 frames): {traced[0]:.3f} ms = "
                  f"{100 * traced[0] / run['ms']:.1f}% of the median frame")
        del det_l
    pts = torch.from_numpy(frames[2]).cuda()
    dense32 = Detector(cfg32).init_weights(SEED)
    with torch.no_grad():
        frame, _ = dense32.preprocess(pts, N_POINTS)
        args = (frame.voxels[None], frame.num_points_per_voxel[None], frame.coors[None])
        dense_cls = dense32.model(*args)["cls_preds"]
    del dense32
    for name, flags in (("packed", dict(pack_w=True)), ("packed + blocked", dict(pack_w=True, block0_blocked=True))):
        det_l = Detector(cfg32.replace(**flags)).init_weights(SEED)
        with torch.no_grad():
            cls = det_l.model(*args)["cls_preds"]
        with_kernels = det_l.infer(pts, N_POINTS)
        use_plain_scatters(det_l.model)
        det_l.postprocess.nms_keep = nms_cuda.nms_keep_plain
        with_plain = det_l.infer(pts, N_POINTS)
        assert_detections_close(with_kernels, with_plain, f"ntusl_20cm f32 {name}, kernels vs plain")
        # the same weights on the dense network: one function, summed in
        # other orders by other convolutions (f32, TF32 off)
        scale = dense_cls.abs().max().item()
        err = (cls - dense_cls).abs().max().item()
        print(f"f32 {name} vs dense cls_preds: max abs diff {err:.3e} (largest |cls_preds| {scale:.3f})")
        check(err <= PACKED_VS_DENSE_TOL * max(scale, 1.0), f"{name} cls_preds differ from the dense network's")
        del det_l

    phase("11. packed train step at full width (ntusl_20cm + pack_w, bf16, batch 2)")
    step_runs = {}
    for name, flags, layout in (
        ("packed + blocked (shipped train levers)", dict(pack_w=True), Layout(True, True, True)),
        ("packed", dict(pack_w=True, block0_blocked_train=False, late_blocked_train=False),
         Layout(True, False, False)),
    ):
        trainer = Trainer(cfg.replace(**flags))
        check(trainer.model.layout(TRAIN_BATCH, True) == layout, f"{name}: layout")
        state = trainer.init_state(SEED)
        n = TRAIN_STEPS if layout.block0_blocked else LAYOUT_TRAIN_STEPS
        run = run_steps(trainer, state, batch, n, counters)
        step_runs[name] = run
        losses = [h["loss"] for h in run["history"]]
        print(f"{name}: ms/step median {run['ms']:.3f} (min {run['min']:.3f}, max {run['max']:.3f}) over {n} "
              f"steps after {TRAIN_WARMUP} warm-up steps; peak memory allocated {run['peak']} bytes")
        print(f"{name}: loss by step: " + " ".join(f"{v:.4f}" for v in losses))
        print(f"{name}: launches {run['launches']}")
        want = {k: n for k in ("matcher_gt_max", "matcher_assign", "fence")}
        want.update({k: 0 for k in ("scatter_fwd", "scatter_bwd", "nms")})
        want.update({k: n if (k.startswith("blocked") == layout.block0_blocked) else 0 for k in LAYOUT_COUNTERS})
        check(run["launches"] == want, f"{name}: launches {run['launches']}, expected {want}")
        print(f"{name}: stage breakdown, median ms over 5 steps (synchronized after each stage):")
        for stage, ms in train_stage_breakdown(trainer, state, batch, 5).items():
            print(f"  {stage:36s} {ms:.3f}")
        if layout.block0_blocked:
            traced = profile_device_time(lambda: trainer.train_step(state, batch), 3)
            if traced is not None:
                print(f"{name}: device time per step (torch.profiler, 3 steps): {traced[0]:.3f} ms = "
                      f"{100 * traced[0] / run['ms']:.1f}% of the median step")
                for op, ms in traced[1][:8]:
                    print(f"  {ms:8.3f} ms  {op[:100]}")
        del trainer, state
    compare_train_steps(cfg32.replace(pack_w=True), batch)

    kernels = [
        {
            "name": "scatter_to_bev", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/scatter.cu",
            "replaces": "det3d_tpu/kernels/scatter_pallas.py:40",
            "launches": launches["scatter"], "max_abs_err": scatter["max_abs_err"],
            **{k: scatter[torch.bfloat16][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes",
        },
        {
            "name": "nms_keep", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/nms.cu",
            "replaces": "det3d_tpu/kernels/nms_pallas.py:30",
            "launches": launches["nms"], "library_ms": None, **nms,
        },
        {
            "name": "scatter_to_bev_bwd", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/scatter.cu",
            "replaces": "det3d_tpu/kernels/scatter_pallas.py:290",
            "launches": train_launches["scatter_bwd"], "max_abs_err": scatter_bwd["max_abs_err"],
            **{k: scatter_bwd[torch.bfloat16][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes",
        },
        {
            "name": "matcher_gt_max", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/matcher.cu",
            "replaces": "det3d_tpu/kernels/matcher_pallas.py:66",
            "launches": train_launches["matcher_gt_max"], "max_abs_err": matcher["gt_max_err"],
            "ms": matcher["gt_max_ms"], "plain_ms": matcher["gt_max_plain_ms"],
            "bound_ms": matcher["gt_max_bound_ms"], "bound_by": matcher["gt_max_bound_by"], "library_ms": None,
        },
        {
            "name": "matcher_assign", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/matcher.cu",
            "replaces": "det3d_tpu/kernels/matcher_pallas.py:139",
            "launches": train_launches["matcher_assign"], "max_abs_err": matcher["max_abs_err"],
            "ms": matcher["assign_ms"], "plain_ms": matcher["assign_plain_ms"],
            "bound_ms": matcher["assign_bound_ms"], "bound_by": matcher["assign_bound_by"], "library_ms": None,
        },
        {
            "name": "fence_copy", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/fence.cu",
            "replaces": "det3d_tpu/kernels/fence_pallas.py:23",
            "launches": train_launches["fence"], "bound_by": "bytes", **fence,
        },
    ]
    blocked_train = step_runs["packed + blocked (shipped train levers)"]["launches"]
    for name, key, replaces, launches in (
        ("scatter_to_bev_s2d", "s2d_fwd", 93, frame_runs["packed"]["launches"]["s2d_fwd"]),
        ("scatter_to_bev_s2d_bwd", "s2d_bwd", 178, step_runs["packed"]["launches"]["s2d_bwd"]),
        ("scatter_to_bev_s2d_blocked", "blocked_fwd", 358, blocked_train["blocked_fwd"]),
        ("scatter_to_bev_s2d_blocked_bwd", "blocked_bwd", 421, blocked_train["blocked_bwd"]),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": "det3d_tpu_torch/kernels/csrc/scatter.cu",
            "replaces": f"det3d_tpu/kernels/scatter_pallas.py:{replaces}", "launches": launches,
            "max_abs_err": layout_k[key]["max_abs_err"], "bound_by": "bytes",
            **{k: layout_k[key][torch.bfloat16][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        })
    print(f"\ntotal {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
