"""End-to-end detector: raw points → detections, on one device.

Counterpart of the JAX package's pipeline.py (reference: InferData.get →
net(example) → Inference.infer_gpu, framework/dataset.py:199-231,
networks/pointpillars8_shared.py:346-382, framework/inference.py:26-138):
voxelization, the anchor mask, the network and post-processing run on the
detector's device with no host round trip until `detect` formats the
result. PyTorch runs eagerly, so the stages are plain method calls; the two
CUDA kernels (the BEV scatter of the config's layout, NMS) each launch once
per frame on the card, or once per batch in `infer_batch`.

With a spatial group (`Detector(cfg, spatial=mesh)`,
`parallel/mesh.make_spatial_infer`) the network's scatter, RPN and head
run on this rank's slab of the canvas (`parallel/spatial.py`); voxelize,
the anchor mask and the PFN before them, and decode and NMS on the gathered
preds after them, run whole on every rank of the group, as JAX runs them
replicated, so every rank holds the frame's `Detections`.

The whole points → detections function is one module, `DetectorModule`,
whose buffers hold every device constant of the path, so that
`deploy/export.py` exports it as it is and the live detector and the
exported program run the same code.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from det3d_tpu_torch.anchors import AnchorSet, build_anchors
from det3d_tpu_torch.config import Config
from det3d_tpu_torch.models.pointpillars import PointPillars, init_weights
from det3d_tpu_torch.ops.anchor_mask import compute_anchors_mask, compute_anchors_mask_separable
from det3d_tpu_torch.ops.voxelize import VoxelizedFrame, VoxelizerSpec, grid_tensors, voxelize
from det3d_tpu_torch.parallel.spatial import SpatialPlan
from det3d_tpu_torch.postprocess import Detections, PostProcessor, PostProcessParams, frame_preds, to_annos
from det3d_tpu_torch.utils.device import resolve_device
from det3d_tpu_torch.utils.npmath import pad_cloud

__all__ = ["Detector", "DetectorModule", "resolve_device"]


class DetectorModule(nn.Module):
    """points → detections as one module: the network, the post-processor
    and, as buffers that no state_dict carries, the voxel grid's constants
    and the anchor mask's index vectors (or corner cells).

    `forward(points (max_points, C), num_points)` is one frame →
    (boxes, scores, valid), the fields of `Detections`; `forward_batch` is B
    frames through the network at batch B and one NMS call. `spatial`: a
    `parallel.spatial.SpatialPlan`, the network split over its group.
    `fcfs`: the voxelizer's slot order (`ops.voxelize.voxelize`), a
    constant of the module that an export bakes in."""

    def __init__(self, cfg: Config, anchor_set: AnchorSet, params: PostProcessParams | None, device,
                 spatial=None, fcfs: bool = True):
        super().__init__()
        self.spatial = spatial
        self.fcfs = fcfs
        self.spec = VoxelizerSpec.from_config(cfg)
        self.grid_xy = (cfg.grid_size[0], cfg.grid_size[1])
        self.mask_shape = (anchor_set.num_channels, *cfg.feature_map_size[:2])
        self.model = PointPillars(cfg).to(device).eval()
        self.postprocess = PostProcessor(cfg, anchor_set, params, device)
        for name, t in zip(("voxel_size", "grid_offset", "grid_size"), grid_tensors(self.spec, device)):
            self.register_buffer(name, t, persistent=False)
        vectors = anchor_set.mask_index_vectors
        self.mask_channels = 0 if vectors is None else len(vectors)
        if vectors is None:
            self.register_buffer("corner_cells", torch.from_numpy(anchor_set.corner_cells).to(device),
                                 persistent=False)
        else:
            for c, channel in enumerate(vectors):
                for j, v in enumerate(channel):
                    self.register_buffer(f"mask_{c}_{j}", torch.as_tensor(v, dtype=torch.int64).to(device),
                                         persistent=False)

    def preprocess(self, points: torch.Tensor, num_points) -> tuple[VoxelizedFrame, torch.Tensor]:
        """Voxelize + anchor occupancy mask (nch, fx, fy)."""
        frame = voxelize(points, num_points, self.spec, (self.voxel_size, self.grid_offset, self.grid_size),
                         fcfs=self.fcfs)
        return frame, self.anchors_mask(frame.coors)

    def anchors_mask(self, coors: torch.Tensor) -> torch.Tensor:
        """Anchor occupancy mask from pillar coordinates, spatial
        anchor-major (nch, fx, fy); the separable path where the anchors
        allow it, element-identical to the flat one."""
        if self.mask_channels:
            vectors = [tuple(getattr(self, f"mask_{c}_{j}") for j in range(4)) for c in range(self.mask_channels)]
            return compute_anchors_mask_separable(coors, vectors, self.grid_xy)
        return compute_anchors_mask(coors, self.corner_cells, self.grid_xy).reshape(self.mask_shape)

    def candidates(self, points: torch.Tensor, num_points):
        """Everything before NMS: voxelize → model → decode."""
        frame, anchors_mask = self.preprocess(points, num_points)
        preds = self.model(frame.voxels[None], frame.num_points_per_voxel[None], frame.coors[None],
                           spatial=self.spatial)
        return self.postprocess.decode_stage(frame_preds(preds, 0), anchors_mask)

    def forward(self, points: torch.Tensor, num_points) -> tuple[torch.Tensor, ...]:
        return tuple(self.postprocess.finalize_stage(self.candidates(points, num_points)))

    def forward_batch(self, points: torch.Tensor, num_points) -> tuple[torch.Tensor, ...]:
        """points (B, max_points, C), num_points (B,): each frame voxelized
        and masked, the network once at batch B, each frame decoded, one NMS
        call over the (B·ncls, kmax, 4) standup boxes, then the rank cap and
        compaction per frame → (B, ...) fields of `Detections`."""
        if self.spatial is not None:
            raise ValueError("a spatial detector partitions within one frame: no batch")
        frames = [self.preprocess(points[i], num_points[i]) for i in range(points.shape[0])]
        preds = self.model(*(torch.stack([getattr(f, k) for f, _ in frames])
                             for k in ("voxels", "num_points_per_voxel", "coors")))
        candidates = [self.postprocess.decode_stage(frame_preds(preds, i), mask)
                      for i, (_, mask) in enumerate(frames)]
        return tuple(self.postprocess.finalize_frames(candidates))


class Detector:
    """Owns the `DetectorModule` (the model and its weights included) on
    one device, and the host conveniences around it. `spatial`: a spatial
    group (`parallel.mesh.make_spatial_mesh`) over which each frame's
    network is split; the dense network only (`PointPillars.check_spatial`).
    `fcfs`: pillar slots in first-occurrence order (the reference's
    selection when `max_voxels` binds), or with `fcfs=False` in cell-id
    order, one sort fewer (the JAX package's `Detector(cfg, fcfs=...)`)."""

    def __init__(self, cfg: Config, device=None, *, fcfs: bool = True,
                 postprocess_params: PostProcessParams | None = None, spatial=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.anchor_set: AnchorSet = build_anchors(cfg)
        plan = None if spatial is None else SpatialPlan.of(spatial, cfg.grid_size[0])
        self.module = DetectorModule(cfg, self.anchor_set, postprocess_params, self.device, plan, fcfs)
        if plan is not None:
            self.module.model.check_spatial()
        self.spatial = plan
        self.model = self.module.model
        self.postprocess = self.module.postprocess

    # -- weights -----------------------------------------------------------
    def init_weights(self, seed: int) -> "Detector":
        """Seeded random weights (see models.pointpillars.init_weights)."""
        init_weights(self.model, seed)
        return self

    def load_state_dict(self, state_dict: dict) -> "Detector":
        """Reference-layout weights (e.g. from `weights.variables_to_state_dict`),
        loaded strictly."""
        self.model.load_state_dict(state_dict, strict=True)
        return self

    # -- stages ------------------------------------------------------------
    def preprocess(self, points: torch.Tensor, num_points) -> tuple[VoxelizedFrame, torch.Tensor]:
        """Voxelize + anchor occupancy mask (nch, fx, fy)."""
        return self.module.preprocess(points, num_points)

    def anchors_mask(self, coors: torch.Tensor) -> torch.Tensor:
        return self.module.anchors_mask(coors)

    @torch.no_grad()
    def infer_candidates(self, points: torch.Tensor, num_points):
        """Everything before NMS: voxelize → model → decode."""
        return self.module.candidates(points, num_points)

    @torch.no_grad()
    def infer(self, points: torch.Tensor, num_points) -> Detections:
        """Single frame, end to end: points (max_points, C) on the
        detector's device and the true point count → Detections."""
        return Detections(*self.module(points, num_points))

    @torch.no_grad()
    def infer_batch(self, points: torch.Tensor, num_points) -> Detections:
        """B frames: points (B, max_points, C) on the detector's device and
        their counts (B,) → Detections with a leading frame axis; the
        counterpart of the JAX package's `jax.vmap(det.infer)`. The network
        runs once at batch B and NMS once for the batch."""
        return Detections(*self.module.forward_batch(points, num_points))

    # -- host conveniences -------------------------------------------------
    def pad_points(self, points: np.ndarray) -> tuple[np.ndarray, np.int32]:
        """Pad/truncate a host point cloud to the static (max_points, C)."""
        return pad_cloud(points, self.cfg.max_points)

    def detect(self, points: np.ndarray) -> dict:
        """Host-facing: raw numpy point cloud → annos dict."""
        padded, n = self.pad_points(points)
        det = self.infer(torch.from_numpy(padded).to(self.device), int(n))
        return to_annos(self.cfg, det)
