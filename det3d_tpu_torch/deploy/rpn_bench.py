"""Standalone RPN microbenchmark.

Counterpart of the JAX package's deploy/rpn_bench.py (reference
rpn_builder.py:108-130): time the backbone alone, the heaviest stage, on
one canvas in both of the port's layouts:
  - dense (the port's default, `pack_w` False): the (B, C, nx, ny) canvas;
  - packed (`pack_w`): the same canvas as the 4-phase space-to-depth map
    (B, 4C, nx/2, ny/2), the RPN's block0 and upsample branches packed.
Both run from one set of seeded weights on the canvas's channels_last
memory, as the scatters hand it over. On the card each time is device
time, as the JAX bench reads its TPU's: the card's spans in a
torch.profiler trace of `iters` calls after warm-up calls, summed, per
call (the eager RPN launches faster than the host can queue it, so a
clock around the calls would time the host); the wall time between CUDA
events is printed beside it. On the CPU, host wall clock.
"""

from __future__ import annotations

import time

import torch

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.models.pointpillars import RPN, compute_dtype, init_weights
from det3d_tpu_torch.utils.device import resolve_device

CHANNELS = 64
WARMUP = 3
INPUTS = 4  # distinct canvases, cycled


def s2d(canvas: torch.Tensor) -> torch.Tensor:
    """Dense NHWC (B, nx, ny, C) → the s2d canvas (B, nx/2, ny/2, 4C), phase
    (x % 2)·2 + y % 2, as `scatter_to_bev_s2d` lays it out."""
    b, nx, ny, c = canvas.shape
    return canvas.reshape(b, nx // 2, 2, ny // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, nx // 2, ny // 2, 4 * c)


def _time_ms(fn, inputs, iters: int, device: torch.device) -> tuple[float, float | None]:
    """(ms per call, wall ms per call between CUDA events or None): device
    time from the profiler on the card, host wall clock on the CPU."""
    for i in range(WARMUP):
        fn(inputs[i % len(inputs)])
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        return (time.perf_counter() - t0) * 1e3 / iters, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize(device)
    busy = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    if busy == 0:
        raise RuntimeError("the profiler trace holds no device events")
    return busy / 1e3 / iters, start.elapsed_time(end) / iters


@torch.no_grad()
def bench_rpn(cfg: Config, iters: int = 100, device=None) -> dict[str, float]:
    """{label: ms per call} of the dense and the packed RPN at batch 1 on
    `device` ("cuda" unless the caller names the CPU)."""
    device = resolve_device(device)
    nx, ny = cfg.grid_size[0], cfg.grid_size[1]
    dtype = compute_dtype(cfg)
    rpn = init_weights(RPN().to(device), 0)
    gen = torch.Generator().manual_seed(0)
    dense = [(torch.randn((1, nx, ny, CHANNELS), generator=gen) * 0.1).to(device, dtype) for _ in range(INPUTS)]
    how = "device time, torch.profiler" if device.type == "cuda" else "host clock"
    results = {}
    for label, pack, inputs in (
        ("dense[default]", False, [x.permute(0, 3, 1, 2) for x in dense]),
        ("packed", True, [s2d(x).permute(0, 3, 1, 2) for x in dense]),
    ):
        ms, wall = _time_ms(lambda x: rpn(x, pack_w=pack), inputs, iters, device)
        results[label] = ms
        shape = "x".join(str(s) for s in inputs[0].shape)
        beside = "" if wall is None else f"; {wall:.3f} ms between CUDA events"
        print(f"RPN {label:15s} NCHW {shape:18s} ({dtype}, {device.type}): {ms:.3f} ms avg [{how}{beside}]")
    return results
