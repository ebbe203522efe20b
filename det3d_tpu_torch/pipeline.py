"""End-to-end detector: raw points → detections, on one device.

Counterpart of the JAX package's pipeline.py (reference: InferData.get →
net(example) → Inference.infer_gpu, framework/dataset.py:199-231,
networks/pointpillars8_shared.py:346-382, framework/inference.py:26-138):
voxelization, the anchor mask, the network and post-processing run on the
detector's device with no host round trip until `detect` formats the
result. PyTorch runs eagerly, so the stages are plain method calls; the two
CUDA kernels (BEV scatter, NMS) each launch once per frame on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from det3d_tpu_torch.anchors import AnchorSet, build_anchors
from det3d_tpu_torch.config import Config
from det3d_tpu_torch.models.pointpillars import PointPillars, init_weights
from det3d_tpu_torch.ops.anchor_mask import compute_anchors_mask, compute_anchors_mask_separable
from det3d_tpu_torch.ops.voxelize import VoxelizedFrame, VoxelizerSpec, voxelize
from det3d_tpu_torch.postprocess import Detections, PostProcessor, PostProcessParams, to_annos


def resolve_device(device=None) -> torch.device:
    """The detector's device: "cuda" unless the caller names another. A
    CUDA device without a card is an error, never a silent CPU run."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class Detector:
    """Owns the model (its weights included), the anchors and the
    post-processor on one device."""

    def __init__(self, cfg: Config, device=None, *, postprocess_params: PostProcessParams | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.spec = VoxelizerSpec.from_config(cfg)
        self.anchor_set: AnchorSet = build_anchors(cfg)
        self.model = PointPillars(cfg).to(self.device).eval()
        self.postprocess = PostProcessor(cfg, self.anchor_set, postprocess_params, self.device)
        self._grid_xy = (cfg.grid_size[0], cfg.grid_size[1])
        vectors = self.anchor_set.mask_index_vectors
        self._mask_vectors = None if vectors is None else [
            tuple(torch.as_tensor(v, dtype=torch.int64, device=self.device) for v in ch) for ch in vectors
        ]
        self._corner_cells = torch.from_numpy(self.anchor_set.corner_cells).to(self.device)

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
        frame = voxelize(points, num_points, self.spec)
        return frame, self.anchors_mask(frame.coors)

    def anchors_mask(self, coors: torch.Tensor) -> torch.Tensor:
        """Anchor occupancy mask from pillar coordinates, spatial
        anchor-major (nch, fx, fy); the separable path where the anchors
        allow it, element-identical to the flat one."""
        if self._mask_vectors is not None:
            return compute_anchors_mask_separable(coors, self._mask_vectors, self._grid_xy)
        fms = self.cfg.feature_map_size
        return compute_anchors_mask(coors, self._corner_cells, self._grid_xy).reshape(
            self.anchor_set.num_channels, fms[0], fms[1]
        )

    @torch.no_grad()
    def infer_candidates(self, points: torch.Tensor, num_points):
        """Everything before NMS: voxelize → model → decode."""
        frame, anchors_mask = self.preprocess(points, num_points)
        preds = self.model(frame.voxels[None], frame.num_points_per_voxel[None], frame.coors[None])
        preds = {k: v[0] for k, v in preds.items()}
        return self.postprocess.decode_stage(preds, anchors_mask)

    @torch.no_grad()
    def infer(self, points: torch.Tensor, num_points) -> Detections:
        """Single frame, end to end: points (max_points, C) on the
        detector's device and the true point count → Detections."""
        return self.postprocess.finalize_stage(self.infer_candidates(points, num_points))

    # -- host conveniences -------------------------------------------------
    def pad_points(self, points: np.ndarray) -> tuple[np.ndarray, np.int32]:
        """Pad/truncate a host point cloud to the static (max_points, C)."""
        n = min(points.shape[0], self.cfg.max_points)
        out = np.zeros((self.cfg.max_points, points.shape[1]), np.float32)
        out[:n] = points[:n]
        return out, np.int32(n)

    def detect(self, points: np.ndarray) -> dict:
        """Host-facing: raw numpy point cloud → annos dict."""
        padded, n = self.pad_points(points)
        det = self.infer(torch.from_numpy(padded).to(self.device), int(n))
        return to_annos(self.cfg, det)
