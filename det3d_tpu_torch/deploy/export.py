"""Export: the whole points → detections function as one `torch.export`
program, with its weights.

Counterpart of the JAX package's deploy/export.py (reference:
framework/trt_utils.py:6-47, train.py:348-424 `trt_export`): where the JAX
package serializes the StableHLO of its fused pipeline, the port exports
`pipeline.DetectorModule` (voxelize → network → decode → NMS → compaction)
with `torch.export` at the static (max_points, C) shape. The voxelizer,
the BEV scatter, the RPN's InstanceNorm + ReLU pairs and NMS are the
custom ops `det3d::voxelize`, `det3d::scatter_to_bev`, `det3d::in_relu`
and `det3d::nms_keep`, so the program holds them as nodes and the runtime
launches the hand-written kernels; the weights and every device constant
of the path (the anchor-mask vectors, the anchors, the post-processor's
thresholds) travel inside it as parameters and buffers, the grid and the
voxelizer's caps as its node's arguments.

The program is traced on the device it will run on (the card unless the
caller names the CPU): a constant the trace creates, such as a fill value,
carries that device, so an artifact runs on the device type it was
exported for. The JAX exporter's two-stage split (candidates | NMS) is not
ported: it works around a TPU compiler limit and the port writes one
program.

Artifact layout (`out_dir/`):
    detector.pt2  — `torch.export.save` of the program, weights included
    config.json   — the config, in the JAX exporter's layout
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.utils.device import resolve_device

PROGRAM = "detector.pt2"
CONFIG = "config.json"


def config_json(cfg: Config) -> str:
    """The config as the JAX exporter writes it (deploy/export.py:34-37):
    every field, `detection_range_raw` under its own name, which
    `runtime.read_config` maps back to `detection_range`."""
    d = dataclasses.asdict(cfg)
    d["class_specs"] = [dataclasses.asdict(s) for s in cfg.class_specs]
    return json.dumps(d, indent=1)


def export_detector(cfg: Config, *, checkpoint: str | None = None, out_dir: str | Path, device=None,
                    fcfs: bool = True) -> Path:
    """Export `cfg`'s detector with the weights of `checkpoint` (a model
    directory's `latest.pth` or a `.pth` file), or `init_weights(0)`, to
    `out_dir` on `device` ("cuda" unless the caller names the CPU); `fcfs`
    is the voxelizer's slot order (`Detector(fcfs=...)`), part of the
    program."""
    from det3d_tpu_torch.pipeline import Detector

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    device = resolve_device(device)
    det = Detector(cfg, device, fcfs=fcfs)
    if checkpoint:
        from det3d_tpu_torch.train.checkpoint import load_latest_state

        load_latest_state(cfg, checkpoint, det)
    else:
        det.init_weights(0)

    t0 = time.perf_counter()
    points = torch.zeros((cfg.max_points, cfg.num_point_features), dtype=torch.float32, device=device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    with torch.no_grad():
        program = torch.export.export(det.module, (points, count), strict=False)
    torch.export.save(program, out / PROGRAM)
    (out / CONFIG).write_text(config_json(cfg))
    size = (out / PROGRAM).stat().st_size
    print(f"exported detector ({cfg.max_points} points, {device.type}) in {time.perf_counter() - t0:.1f} s, "
          f"{size} bytes → {out}")
    return out
