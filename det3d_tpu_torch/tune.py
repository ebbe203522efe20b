"""Config autotuner: measure the config's layout levers on the device and
write a tuned config JSON.

The port's counterpart of the JAX package's tune.py, with its six levers,
their candidates and modes, its workload and its greedy protocol:

  inference-path levers (measured on `Detector.infer_jit`):
    pack_w          w-parity packed network on the space-to-depth canvas
    fuse_in_stats   upsample-branch Gram InstanceNorm statistics
    block0_blocked  blocked-halo canvas + batch-over-blocks block0
    split_head      per-parity neck emission + two half-width head calls
  train-path levers (measured on `Trainer.train_step_jit`):
    pack_w          (the same packing in the train step)
    block0_blocked_train  blocked-halo block0 in the train step
    late_blocked_train    blocks 1-2 batch-over-row-blocks in the train step

Every candidate computes the same function (each lever has an equality
test under tests/), so tuning is a decision on time alone. Per mode:
measure the config as it is, then flip one lever at a time (carrying the
earlier winners) and keep a flip only when it beats the incumbent by
`margin`; a lever of both modes is decided by the first mode that measures
it (inference), so a flip rejected there never enters the tuned config
through the train step. The workload is the JAX tuner's: six distinct
`synthetic_cloud` frames of min(100 000, max_points) points cycled through
`infer_iters` frames, and four `sample_scene` batches at `batch_size`
cycled through `train_iters` steps; `max_points` is 120 000 unless the
config or the caller names it. The tuned JSON is the source JSON plus the
winners plus `_tuned_on` (the card's name, or "cpu").

Where the port differs, and why:
  * the port's default network is dense (`pack_w` False, config.py), and
    five levers act on the packed network only (`PACKED_ONLY`): one of
    them is flipped only when the config it would be measured on has
    `pack_w` on, and is otherwise reported in `report["skipped"]` — timing
    an inert key would let noise adopt it;
  * the JAX tuner's TPU-only levers are timed on the card only: under
    `device="cpu"` the three blocked levers are skipped, as the JAX tuner
    skips them off a TPU, since the plain versions' times say nothing of
    the card's; on the CPU a bf16 config trains in float32 (inference
    keeps its dtype), as the JAX tuner does on its CPU backend;
  * on the card a window's time is its device time, the sum of the
    card's kernel, memset and copy spans in a torch.profiler trace over the
    window, divided by its frames or steps: the host clock moves by ±15 %
    between calls (PERF.md), and the trials replay captured graphs
    (`infer_jit`, `train_step_jit`), which pay no host launch cost a
    lever could change; each trial also records the host clock's ms of an
    unprofiled window beside it. On the CPU the host
    clock is the only time. Each mode keeps the best of its windows (3 for
    inference, 2 for training), as the JAX tuner does;
  * the default output is `<config>_torch_tuned.json`, beside the JAX
    tuner's `<config>_tuned.json`, which it leaves alone.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from det3d_tpu_torch.config import Config, _loads_tolerant, load_config
from det3d_tpu_torch.utils.device import resolve_device

# (lever, candidates, modes it affects, timed on the card only)
LEVERS = (
    ("pack_w", (True, False), ("infer", "train"), False),
    ("fuse_in_stats", (True, False), ("infer",), False),
    ("block0_blocked", (False, True), ("infer",), True),
    ("block0_blocked_train", (False, True), ("train",), True),
    ("late_blocked_train", (False, True), ("train",), True),
    ("split_head", (True, False), ("infer",), False),
)
PACKED_ONLY = frozenset({"fuse_in_stats", "block0_blocked", "split_head", "block0_blocked_train",
                         "late_blocked_train"})
PACKED_ONLY_REASON = "acts on the packed network only; pack_w is off"
CARD_ONLY_REASON = "timed on the card only: the plain versions' CPU times say nothing of the card's"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_span_ms(prof) -> float:
    """The device spans (kernels, memsets, copies) of a finished
    torch.profiler trace, summed, in ms: read from its raw events, the ones
    `prof.events()` keeps, without building that event tree of every host
    op (seconds a window). No device span is an error, never a fall back
    to the host clock."""
    from torch.autograd import DeviceType

    spans = [e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and not getattr(e, "is_hidden_event", lambda: False)()]
    if not spans:
        raise RuntimeError("the profiler trace holds no device events: no device time to decide by")
    return sum(spans) / 1e6


def device_ms(fn, n: int, device: torch.device) -> float:
    """Device ms per call of `fn` over n calls (`device_span_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        _sync(device)
    return device_span_ms(prof) / n


def _windows(fn, n: int, windows: int, device: torch.device) -> dict:
    """The best of `windows` windows of n calls of fn(i) → {ms (the
    deciding time), device_ms (None on the CPU), host_ms}."""
    host = dev = float("inf")
    for _ in range(windows):
        _sync(device)
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        _sync(device)
        host = min(host, (time.perf_counter() - t0) / n * 1e3)
        if device.type == "cuda":
            dev = min(dev, device_ms(fn, n, device))
    device_best = dev if device.type == "cuda" else None
    return {"ms": host if device_best is None else device_best, "device_ms": device_best, "host_ms": host}


def _free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _infer_inputs(cfg: Config, num_clouds: int = 6):
    """Distinct clouds with the JAX tuner's workload recipe (the scatter
    levers' times depend on the pillar occupancy)."""
    from det3d_tpu_torch.data.synthetic import synthetic_cloud

    n = min(100_000, cfg.max_points)
    return [synthetic_cloud(cfg.max_points, n, seed=s) for s in range(num_clouds)], n


def measure_infer(cfg: Config, iters: int, windows: int = 3, device=None) -> dict:
    """ms/frame of `Detector.infer_jit` (the JAX tuner's `det.infer_jit`)
    on clouds already on the device, best window → {ms, device_ms,
    host_ms}."""
    from det3d_tpu_torch.pipeline import Detector

    device = resolve_device(device)
    det = Detector(cfg, device).init_weights(0)
    host_clouds, n = _infer_inputs(cfg)
    clouds = [torch.from_numpy(c).to(device) for c in host_clouds]

    def frame(i):
        return det.infer_jit(clouds[i % len(clouds)], n)

    frame(0)  # warm-up and capture
    out = _windows(frame, iters, windows, device)
    del det, clouds
    _free(device)
    return out


def measure_train(cfg: Config, iters: int, windows: int = 2, device=None) -> dict:
    """ms/step of `Trainer.train_step_jit` (the JAX tuner's
    `train_step_jit`) over four batches already on the device, the state
    chained forward, best window → {ms, device_ms, host_ms}."""
    from det3d_tpu_torch.data.synthetic import sample_scene
    from det3d_tpu_torch.train.trainer import Trainer, host_batch

    device = resolve_device(device)
    trainer = Trainer(cfg, device)
    state = trainer.init_state(0)
    rng = np.random.RandomState(0)
    batches = [trainer.to_device(host_batch(cfg, [sample_scene(cfg, rng) for _ in range(cfg.batch_size)]))
               for _ in range(4)]

    def step(i):
        return trainer.train_step_jit(state, batches[i % len(batches)])

    step(0)  # warm-up and capture
    out = _windows(step, iters, windows, device)
    del trainer, state, batches
    _free(device)
    return out


def tune(
    config_path: str,
    out_path: str | None = None,
    mode: str = "both",
    infer_iters: int = 32,
    train_iters: int = 12,
    batch_size: int = 2,
    margin: float = 0.02,
    only_levers: tuple[str, ...] | None = None,
    config_overrides: dict | None = None,
    device=None,
) -> dict:
    """Greedy per-mode lever search on `device` ("cuda" unless the caller
    names another); writes the tuned JSON and returns the report: the JAX
    tuner's keys (backend, config, modes with each trial, chosen, skipped,
    out) and `timed_by`; each trial holds `ms` (the deciding time),
    `device_ms` and `host_ms`."""
    device = resolve_device(device)
    known = {name for name, _, _, _ in LEVERS}
    if only_levers is not None:
        only_levers = tuple(s.strip() for s in only_levers)
        unknown = set(only_levers) - known
        if unknown:
            raise ValueError(f"unknown lever(s) {sorted(unknown)}; known: {sorted(known)}")

    on_card = device.type == "cuda"
    if not on_card:
        print(f"WARNING: tuning on the '{device.type}' device — lever winners are DEVICE-LOCAL; do not deploy a "
              "CPU-tuned config to the card; the tuned JSON records the device in _tuned_on")
    raw = _loads(config_path)
    config_overrides = dict(config_overrides or {})
    if "max_points" not in config_overrides and "max_points" not in raw:
        config_overrides["max_points"] = 120_000
    chosen: dict[str, object] = {}
    decided: set[str] = set()
    report: dict = {"backend": device.type, "config": str(config_path), "modes": {}, "chosen": chosen,
                    "skipped": [],
                    "timed_by": "device time (torch.profiler)" if on_card else "host clock (cpu)"}

    def skip(lever: str, reason: str) -> None:
        if not any(s["lever"] == lever for s in report["skipped"]):
            report["skipped"].append({"lever": lever, "reason": reason})

    def build_cfg(extra: dict, train: bool) -> Config:
        cfg = load_config(dict(raw), batch_size=batch_size, **{**config_overrides, **chosen, **extra})
        if train and cfg.compute_dtype != "float32" and not on_card:
            # the JAX tuner's CPU promotion: the train step computes in f32,
            # inference is timed in the configured dtype
            cfg = cfg.replace(compute_dtype="float32")
        return cfg

    for mode_name, measure, iters in (
        ("infer", lambda e: measure_infer(build_cfg(e, False), infer_iters, device=device), infer_iters),
        ("train", lambda e: measure_train(build_cfg(e, True), train_iters, device=device), train_iters),
    ):
        if mode not in (mode_name, "both"):
            continue
        unit = "ms/frame" if mode_name == "infer" else "ms/step"
        best = measure({})
        best_ms = best["ms"]
        print(f"[{mode_name}] baseline: {best_ms:.3f} {unit} (host {best['host_ms']:.3f})")
        trials = [{"levers": dict(chosen), **best}]
        for lever, candidates, lever_modes, card_only in LEVERS:
            if mode_name not in lever_modes:
                continue
            if only_levers is not None and lever not in only_levers:
                continue
            if lever in decided:  # adopted or rejected by an earlier mode
                continue
            if card_only and not on_card:
                skip(lever, CARD_ONLY_REASON)
                continue
            current_cfg = build_cfg({}, mode_name == "train")
            if lever in PACKED_ONLY and not current_cfg.pack_w:
                skip(lever, PACKED_ONLY_REASON)
                continue
            decided.add(lever)
            current = getattr(current_cfg, lever)
            for cand in candidates:
                if cand == current:
                    continue
                got = measure({lever: cand})
                trials.append({"levers": {**chosen, lever: cand}, **got})
                verdict = "keep" if got["ms"] < best_ms * (1.0 - margin) else "reject"
                print(f"[{mode_name}] {lever}={cand}: {got['ms']:.3f} {unit} (host {got['host_ms']:.3f}; "
                      f"incumbent {best_ms:.3f}) -> {verdict}")
                if verdict == "keep":
                    best_ms = got["ms"]
                    chosen[lever] = cand
        report["modes"][mode_name] = {"final_ms": best_ms, "unit": unit, "iters": iters, "trials": trials}

    # the source JSON + the winning lever values; load_config ignores _tuned_on
    tuned = dict(raw)
    tuned.update(chosen)
    tuned["_tuned_on"] = torch.cuda.get_device_name(device) if on_card else "cpu"
    if out_path is None:
        p = Path(config_path)
        out_path = str(p.with_name(p.stem + "_torch_tuned.json"))
    Path(out_path).write_text(json.dumps(tuned, indent=1) + "\n")
    report["out"] = out_path
    print(f"tuned config -> {out_path}  (levers: {chosen or 'all defaults win'})")
    return report


def _loads(path: str) -> dict:
    return _loads_tolerant(Path(path).read_text())
