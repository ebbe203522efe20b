"""Deployment runtime: load an exported artifact and run it.

Counterpart of the JAX package's deploy/runtime.py (reference:
networks/pointpillars_trt.py:10-77, train.py:273-345 `trt_eval`). Loading
needs the config (host-side padding and annos) and the kernel ops
(`kernels.scatter_cuda`, `kernels.nms_cuda`, `kernels.norm_cuda`,
`kernels.voxelize_cuda` register `det3d::*`), not the model code:
`ExportedDetector` imports neither `models` nor `pipeline`. The weights
are loaded once and stay on the device.

On the card the runtime runs the program twice to warm it up (the
kernels' build, cuDNN's first calls) and captures it as ONE CUDA graph
over static buffers (`utils.graphs.CapturedCall`): the points
(max_points, C) float32, the count () int32 and the Detections. `infer`
copies a frame into those buffers from pinned host memory and replays the
graph: one host dispatch per frame, the counterpart of the JAX runtime's
`jax.jit(deserialize(...).call)`. A capture that fails raises; nothing
falls back to running the program op by op. On the CPU (and with
`cuda_graph=False`, to measure what the graph saves) the program's module
runs op by op.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from det3d_tpu_torch.config import Config, load_config
from det3d_tpu_torch.deploy.export import CONFIG, PROGRAM
from det3d_tpu_torch.kernels import nms_cuda, norm_cuda, scatter_cuda, voxelize_cuda  # noqa: F401  (the det3d ops)
from det3d_tpu_torch.postprocess import Detections, to_annos
from det3d_tpu_torch.utils.device import resolve_device
from det3d_tpu_torch.utils.graphs import CapturedCall
from det3d_tpu_torch.utils.npmath import pad_cloud


def read_config(artifact_dir: str | Path) -> Config:
    """The artifact's config.json → Config, with the JAX runtime's two
    edits (deploy/runtime.py:42-44): the derived class specs dropped and
    `detection_range_raw` read back as `detection_range`."""
    raw = json.loads((Path(artifact_dir) / CONFIG).read_text())
    raw.pop("class_specs", None)
    raw["detection_range"] = raw.pop("detection_range_raw")
    return load_config(raw)


class ExportedDetector:
    """Runs a detector artifact (see deploy/export.py) on `device` ("cuda"
    unless the caller names the CPU), which must be the device type it
    was exported for."""

    def __init__(self, artifact_dir: str | Path, device=None, *, cuda_graph: bool = True):
        self.dir = Path(artifact_dir)
        self.cfg = read_config(self.dir)
        self.device = resolve_device(device)
        program = torch.export.load(self.dir / PROGRAM)
        exported_on = {t.device.type for t in program.state_dict.values()}
        if exported_on != {self.device.type}:
            raise ValueError(f"{self.dir} was exported for {sorted(exported_on)}, not {self.device.type}")
        self.module = program.module()
        self.call = None
        if self.device.type == "cuda" and cuda_graph:
            self._capture()

    def _capture(self) -> None:
        """Warm up on a side stream, then capture one CUDA graph of the
        program over static input and output buffers; the runner keeps it
        only if the capture succeeds."""
        shape = (self.cfg.max_points, self.cfg.num_point_features)
        call = CapturedCall(torch.no_grad()(self.module), self.device)
        call.capture(torch.zeros(shape), torch.zeros((), dtype=torch.int32))
        self.call = call

    @property
    def graph(self) -> torch.cuda.CUDAGraph | None:
        return None if self.call is None else self.call.graph

    def pad_points(self, points: np.ndarray) -> tuple[np.ndarray, np.int32]:
        """Pad/truncate a host point cloud to the static (max_points, C)."""
        return pad_cloud(points, self.cfg.max_points)

    @torch.no_grad()
    def infer(self, points, num_points) -> Detections:
        """A padded frame (max_points, C) and its point count → Detections
        on the device. Under a CUDA graph the Detections are the graph's
        output buffers, which the next `infer` overwrites."""
        points = torch.as_tensor(points, dtype=torch.float32)
        count = torch.as_tensor(num_points, dtype=torch.int32)
        if self.call is None:
            return Detections(*self.module(points.to(self.device), count.to(self.device)))
        return Detections(*self.call(points, count))

    def detect(self, points: np.ndarray) -> dict:
        """Host-facing: raw numpy point cloud → annos dict."""
        padded, n = self.pad_points(points)
        return to_annos(self.cfg, self.infer(padded, n))


def infer_exported(cfg: Config, artifact_dir: str | Path, *, synthetic: bool = True, num_frames: int = 64,
                   seed: int = 1, device=None, range_threshold: float = 80.0) -> dict:
    """Offline eval driven by the exported artifact (reference trt_eval,
    train.py:273-345): every frame through `ExportedDetector.detect`, the
    first left out of the average, then the official mAP. `cfg` names the
    frames (its data paths); the artifact's own config runs them."""
    from det3d_tpu_torch.apps.infer_app import frame_source
    from det3d_tpu_torch.eval.ap import get_official_eval_result

    runner = ExportedDetector(artifact_dir, device)
    reader, gt_annos, frames = frame_source(cfg, synthetic, num_frames, seed, runner.pad_points)
    dt_annos, total = [], 0.0
    for i, (pts, n) in enumerate(frames):
        t0 = time.perf_counter()
        dt_annos.append(to_annos(runner.cfg, runner.infer(pts, n)))
        if i > 0:
            total += time.perf_counter() - t0
    avg_ms = 1e3 * total / max(len(dt_annos) - 1, 1)
    print(f"point reader: {reader}; exported-artifact avg: {avg_ms:.2f} ms/frame "
          f"({'CUDA graph' if runner.graph is not None else 'op by op'})")
    _, eval_str = get_official_eval_result(gt_annos, dt_annos, list(runner.cfg.detect_class), range_threshold,
                                           device=runner.device)
    print(eval_str)
    return {"dt_annos": dt_annos, "gt_annos": gt_annos, "avg_ms": avg_ms, "eval_str": eval_str, "reader": reader}
