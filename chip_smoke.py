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
     keep masks equal; times from CUDA events;
  4. the main path at full width: configs/ntusl_20cm.json (800x800 grid,
     16k pillars x 15 points, 1.44M anchors, bf16) with seeded random
     weights, ~100k-point frames through `Detector.detect`; every kernel of
     the path must launch on every frame;
  5. the full path in float32 with the kernels against the same path with
     the plain versions on the card, and a small geometry on the card
     against the CPU, at the tolerances of tests/test_golden_e2e.py.
The last lines are the kernels table (JSON), the card's name and power
limit, and {"ok": true, "device": {...}}. Needs one CUDA card; imports
nothing of the JAX package.
"""

from __future__ import annotations

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
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
# operations per box pair in the NMS suppression test: iw and ih (min, max,
# sub, add, max each), inter, union (add, sub), the division, the compare;
# the per-box areas are counted once per box, not per pair
NMS_OPS_PER_PAIR = 15


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
    """Mean device time of one call, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


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


def nms_cases(candidates, gen: torch.Generator):
    """(name, boxes (3, K, 4), valid (3, K)) cases on the card."""
    k = max(c.valid.shape[0] for c in candidates)
    real = torch.zeros((len(candidates), k, 4), device="cuda")
    for ci, c in enumerate(candidates):
        real[ci, : c.standup.shape[0]] = c.standup
    # ~20% invalid, as the score gate leaves a real frame's tail
    some_invalid = torch.rand((len(candidates), k), generator=gen) >= 0.2
    centers = torch.rand((3, 1000, 2), generator=gen) * 80 - 40
    dims = torch.rand((3, 1000, 2), generator=gen) * 7 + 1
    rand_boxes = torch.cat([centers - dims / 2, centers + dims / 2], dim=-1).cuda()
    return [
        ("random boxes", rand_boxes, torch.ones((3, 1000), dtype=torch.bool, device="cuda")),
        ("real frame, 20% invalid", real.contiguous(), some_invalid.cuda()),
        ("real frame, all invalid", real.contiguous(), torch.zeros((len(candidates), k), dtype=torch.bool, device="cuda")),
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
        print(f"nms {name:24s}: keep equal={equal} kept={int(got.sum())} of {int(valid.sum())} valid")
        check(equal, f"nms keep mask differs from the plain version on '{name}'")
    _, boxes, valid = cases[1]
    ms = cuda_ms(lambda: nc.nms_keep_cuda(boxes, valid, iou_threshold))
    plain_ms = cuda_ms(lambda: nc.nms_keep_plain(boxes, valid, iou_threshold), iters=5, warmup=1)
    nv = valid.sum(dim=1).double()
    ops = float((nv * (nv - 1) / 2).sum()) * NMS_OPS_PER_PAIR
    moved = boxes.numel() * 4 + 2 * valid.numel()
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    print(f"nms (3 x {boxes.shape[1]}, one launch) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms=none bound_ms={bound_ms:.6f} ({bound_by})")
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
        canvas = model.scatter(feats.contiguous(), frame.coors[None].contiguous(), model.grid_xy)
        mark("BEV scatter (kernel)")
        x = model.rpn(canvas.permute(0, 3, 1, 2))
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
    det.detect(frames[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scatter_cuda.counter.launches = 0
    nms_cuda.counter.launches = 0
    times, counts = [], []
    for pts_np in frames[1:]:
        t0 = time.perf_counter()
        annos = det.detect(pts_np)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(len(annos["score"]))
        for key in ("location", "dimensions", "rotation_y", "score"):
            check(bool(np.isfinite(annos[key]).all()), f"non-finite {key}")
    launches = {"scatter": scatter_cuda.counter.launches, "nms": nms_cuda.counter.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"ms/frame median {statistics.median(times):.3f} (host clock around detect + synchronize; "
          f"min {min(times):.3f}, max {max(times):.3f}) over {len(times)} frames")
    print(f"peak memory allocated {peak} bytes; detections per frame {counts}")
    print(f"launches on the main path: {launches}")
    for name, n in launches.items():
        check(n == len(times), f"{name} kernel launched {n} times over {len(times)} frames")
    print("stage breakdown, median ms (synchronized after each stage):")
    for name, ms in stage_breakdown(det, frames[1:]).items():
        print(f"  {name:36s} {ms:.3f}")
    traced = device_time(det, frames[1:6])
    if traced is None:
        print("device time per frame: not measured (the profiler trace holds no device events)")
    else:
        busy, top = traced
        print(f"device time per frame (torch.profiler, 5 frames): {busy:.3f} ms = "
              f"{100 * busy / statistics.median(times):.1f}% of the {statistics.median(times):.3f} ms median frame")
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
    ]
    print(f"\ntotal {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
