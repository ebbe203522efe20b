"""Training step: padded points + gt boxes → loss, gradients and one update,
all on the trainer's device.

Counterpart of the JAX package's train/trainer.py (reference:
train.py:23-162): voxelize → anchor mask → target assignment → forward
(masked PFN batch statistics) → fence on `cls_preds` → loss → backward →
clip by global norm (10.0) → Adam (lr from the state). PyTorch runs
eagerly and updates in place: the model holds the parameters and batch
statistics, the `TrainState` the optimizer's moments, step and lr, and
`train_step` returns the state it was given, updated. On the card the
step launches the matcher's two kernels once (all samples and classes),
the scatter's forward and backward kernels once each, and the fence once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.kernels.fence_cuda import s2b_fence
from det3d_tpu_torch.losses import detection_loss
from det3d_tpu_torch.ops.voxelize import VoxelizedFrame
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.targets import TargetAssignment, make_target_assigner
from det3d_tpu_torch.train.metrics import binary_counts

MAX_GRAD_NORM = 10.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class TrainBatch(NamedTuple):
    """Static-shape batch (numpy from `host_batch`, or tensors)."""

    points: np.ndarray | torch.Tensor      # (B, max_points, C) float32
    num_points: np.ndarray | torch.Tensor  # (B,) int32
    gt_boxes: np.ndarray | torch.Tensor    # (B, G, 7) float32
    gt_classes: np.ndarray | torch.Tensor  # (B, G) int32, 1-based
    gt_valid: np.ndarray | torch.Tensor    # (B, G) bool


@dataclasses.dataclass
class TrainState:
    """Adam's state for the trainer's model parameters (in
    `model.parameters()` order); the parameters and batch statistics
    themselves live in the model."""

    step: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    lr: float


def _bias_correction(decay: float, count: int) -> float:
    # 1 - decay**count in float32, as optax computes it
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))


class Trainer:
    """One optimizer step at a time on `device` ("cuda" unless the caller
    names another; see `pipeline.resolve_device`)."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.detector = Detector(cfg, device)
        self.device = self.detector.device
        self.model = self.detector.model
        self.params = list(self.model.parameters())
        self.assigner = make_target_assigner(cfg, self.detector.anchor_set, self.device)
        self.fence = s2b_fence

    # -- state -------------------------------------------------------------
    def init_state(self, seed: int | None = None) -> TrainState:
        """Fresh optimizer state at step 0 with the config's lr; with a
        `seed`, seeded random weights first (`init_weights`), otherwise the
        model's current weights (for example JAX weights loaded with
        `detector.load_state_dict`)."""
        if seed is not None:
            self.detector.init_weights(seed)
        return TrainState(step=0, mu=[torch.zeros_like(p) for p in self.params],
                          nu=[torch.zeros_like(p) for p in self.params], lr=float(self.cfg.learning_rate))

    @staticmethod
    def override_lr(state: TrainState, lr: float) -> TrainState:
        """The state with another learning rate (as after a restore)."""
        return dataclasses.replace(state, lr=float(lr))

    # -- the step's stages -------------------------------------------------
    def to_device(self, batch: TrainBatch) -> TrainBatch:
        return TrainBatch(*(torch.as_tensor(a).to(self.device) for a in batch))

    def prepare(self, batch: TrainBatch) -> tuple[VoxelizedFrame, TargetAssignment]:
        """Per sample voxelize + anchor mask, then one target assignment for
        the stacked batch (trainer.py:124-161 of the JAX package)."""
        frames, masks = [], []
        for i in range(batch.points.shape[0]):
            frame, mask = self.detector.preprocess(batch.points[i], batch.num_points[i])
            frames.append(frame)
            masks.append(mask)
        frames = VoxelizedFrame(*(torch.stack(x) for x in zip(*frames)))
        tgt = self.assigner(batch.gt_boxes, batch.gt_classes, batch.gt_valid, torch.stack(masks))
        return frames, tgt

    def forward_loss(self, frames: VoxelizedFrame, tgt: TargetAssignment):
        """Train-mode forward, the fence on `cls_preds` (as the JAX step,
        trainer.py:199-211), and the loss: (loss dict, preds)."""
        preds = self.model(frames.voxels, frames.num_points_per_voxel, frames.coors, train=True)
        preds = dict(preds, cls_preds=self.fence(preds["cls_preds"]))
        loss_dict = detection_loss(preds, tgt.labels, tgt.bbox_targets, tgt.dir_targets)
        return loss_dict, preds

    @torch.no_grad()
    def apply_gradients(self, state: TrainState) -> TrainState:
        """Clip by global norm in optax's form (g if norm < 10 else
        g / norm * 10, written as g / d * m with d, m = 1 or norm, 10, so no
        host sync), then Adam with optax's order of operations (b1 0.9,
        b2 0.999, eps 1e-8, eps_root 0), then params += update."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < MAX_GRAD_NORM
        grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))  # p.grad stays as it was
        torch._foreach_mul_(grads, torch.where(keep, 1.0, MAX_GRAD_NORM))

        state.step += 1
        torch._foreach_mul_(state.mu, ADAM_B1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - ADAM_B1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - ADAM_B2)
        torch._foreach_mul_(state.nu, ADAM_B2)
        torch._foreach_add_(state.nu, sq)
        mu_hat = torch._foreach_div(state.mu, _bias_correction(ADAM_B1, state.step))
        denom = torch._foreach_div(state.nu, _bias_correction(ADAM_B2, state.step))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(updates, -state.lr)
        torch._foreach_add_(self.params, updates)
        return state

    # -- the step ----------------------------------------------------------
    def train_step(self, state: TrainState, batch: TrainBatch):
        """One optimizer step → (state, loss dict, metric counts)."""
        batch = self.to_device(batch)
        frames, tgt = self.prepare(batch)
        loss_dict, preds = self.forward_loss(frames, tgt)
        for p in self.params:
            p.grad = None
        loss_dict["loss"].backward()
        with torch.no_grad():
            metrics = binary_counts(tgt.labels, preds["cls_preds"])
        self.apply_gradients(state)
        return state, {k: v.detach() for k, v in loss_dict.items()}, metrics


def host_batch(cfg: Config, samples: list[dict]) -> TrainBatch:
    """Collate host samples (each with 'points', 'gt_boxes', 'gt_classes')
    into a static-shape numpy TrainBatch (reference merge_second_batch,
    framework/utils.py:23-48, under the pad-to-max contract)."""
    b = len(samples)
    g = cfg.max_gt_boxes
    points = np.zeros((b, cfg.max_points, cfg.num_point_features), np.float32)
    num_points = np.zeros((b,), np.int32)
    gt_boxes = np.zeros((b, g, 7), np.float32)
    gt_boxes[..., 3:6] = 1.0  # keep the masked encode's logs finite
    gt_classes = np.zeros((b, g), np.int32)
    gt_valid = np.zeros((b, g), bool)
    for i, s in enumerate(samples):
        pts = s["points"]
        n = min(pts.shape[0], cfg.max_points)
        points[i, :n] = pts[:n]
        num_points[i] = n
        gb = s.get("gt_boxes", np.zeros((0, 7), np.float32))
        ng = min(gb.shape[0], g)
        if ng and "gt_classes" not in s:
            raise KeyError("sample has gt_boxes but no gt_classes: every box needs a 1-based class id")
        gt_boxes[i, :ng] = gb[:ng]
        gt_classes[i, :ng] = np.asarray(s.get("gt_classes", ()), np.int32)[:ng]
        gt_valid[i, :ng] = True
    return TrainBatch(points, num_points, gt_boxes, gt_classes, gt_valid)
