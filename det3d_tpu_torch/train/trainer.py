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

`Trainer(device_global_augment=True)` runs the global augmentation
(flip, rotation, scaling, translation) inside the step on the device, as
the JAX trainer's option of that name does, with the dataset's host chain
keeping only the per-object noise (`DetectionDataset(device_global_augment=True)`).

`train_step(state, batch, mesh)` is the per-rank body of a data-parallel
step (`parallel/mesh.make_sharded_train_step`; the JAX step's `axis_name`,
trainer.py:166-234): the batch is this rank's slice, the PFN's batch
statistics are synced over the mesh, the gradients averaged over it in
one all-reduce before the clip and Adam, the loss terms averaged and the
metric counts summed, so every rank applies the one-process step's update
at the global batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.data import augment as agm
from det3d_tpu_torch.kernels.fence_cuda import s2b_fence
from det3d_tpu_torch.losses import detection_loss
from det3d_tpu_torch.ops import geometry
from det3d_tpu_torch.ops.voxelize import VoxelizedFrame
from det3d_tpu_torch.parallel.mesh import pmean, pmean_gradients, psum
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.postprocess import Detections
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


def augment_seed(aug_seed: int, step: int, rank: int | None = None) -> int:
    """The seed of a step's augmentation draws: a function of the run's seed
    and the step alone (the JAX trainer's `fold_in(key, step)`), so a
    resumed run draws what the uninterrupted one drew; in a data-parallel
    step also of the rank (its `fold_in(key, axis_index)`), so that each
    rank draws its own transforms."""
    entropy = (aug_seed, step) if rank is None else (aug_seed, step, rank)
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


class Trainer:
    """One optimizer step at a time on `device` ("cuda" unless the caller
    names another; see `pipeline.resolve_device`).

    `device_global_augment=True`: each sample of a step is flipped, rotated,
    scaled and translated on the device before it is voxelized
    (`data/augment.apply_global_augment`, the batch in one set of
    launches), with parameters drawn per sample from a generator seeded by
    `augment_seed(aug_seed, state.step)`; then the range filter updates
    `gt_valid` and the yaw wraps by 2π, which the host chain does otherwise
    (`device_augment`)."""

    def __init__(self, cfg: Config, device=None, *, device_global_augment: bool = False, aug_seed: int = 0):
        self.cfg = cfg
        self.detector = Detector(cfg, device)
        self.device = self.detector.device
        self.model = self.detector.model
        self.params = list(self.model.parameters())
        self.assigner = make_target_assigner(cfg, self.detector.anchor_set, self.device)
        self.fence = s2b_fence
        self.device_global_augment = device_global_augment
        self.aug_seed = int(aug_seed)
        if device_global_augment:
            # made once: a constant built per step would be a host-card copy
            dr = cfg.detection_range
            self.aug_generator = torch.Generator(device=self.device)
            self.aug_range = torch.tensor([dr[0], dr[1], dr[3], dr[4]], dtype=torch.float32, device=self.device)
            self.aug_unit = geometry.unit_corners(0.5, self.device, torch.float32)

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

    def augment_params(self, step: int, batch: int, rank: int | None = None) -> dict:
        """The step's global-augmentation parameters, one row per sample,
        drawn on the trainer's device (no host round trip); `rank`: this
        rank's draws in a data-parallel step."""
        self.aug_generator.manual_seed(augment_seed(self.aug_seed, step, rank))
        return agm.sample_global_augment_params(self.aug_generator, batch, self.device)

    def device_augment(self, points, gt_boxes, gt_valid, params: dict):
        """The global transforms on the device, then the host path's range
        filter as a `gt_valid` update and its 2π yaw wrap (the JAX trainer's
        `_device_augment_one`, trainer.py:104-122), for one sample or, with
        a leading batch axis on everything, for a batch at once. The
        scale's re-fit folds yaw into (-π/2, π/2); the wrap keeps the host's
        2π period all the same, as a π period would alias headings that
        differ by π and break the direction targets."""
        points, gt_boxes = agm.apply_global_augment(points, gt_boxes, params)
        keep = geometry.filter_gt_box_outside_range(gt_boxes.reshape(-1, 7), self.aug_range, self.aug_unit)
        yaw = geometry.limit_period(gt_boxes[..., 6:], period=2 * math.pi)
        return points, torch.cat([gt_boxes[..., :6], yaw], dim=-1), gt_valid & keep.reshape(gt_valid.shape)

    def prepare(self, batch: TrainBatch, step: int = 0,
                rank: int | None = None) -> tuple[VoxelizedFrame, TargetAssignment]:
        """(The global augmentation of step `step`, where the trainer applies
        it, drawn for `rank` in a data-parallel step, then) per sample
        voxelize + anchor mask, then one target assignment for the stacked
        batch (trainer.py:124-161 of the JAX package)."""
        points, gt_boxes, gt_valid = batch.points, batch.gt_boxes, batch.gt_valid
        if self.device_global_augment:
            params = self.augment_params(step, points.shape[0], rank)
            points, gt_boxes, gt_valid = self.device_augment(points, gt_boxes, gt_valid, params)
        frames, masks = [], []
        for i in range(points.shape[0]):
            frame, mask = self.detector.preprocess(points[i], batch.num_points[i])
            frames.append(frame)
            masks.append(mask)
        frames = VoxelizedFrame(*(torch.stack(x) for x in zip(*frames)))
        tgt = self.assigner(gt_boxes, batch.gt_classes, gt_valid, torch.stack(masks))
        return frames, tgt

    def forward_loss(self, frames: VoxelizedFrame, tgt: TargetAssignment, mesh=None):
        """Train-mode forward (its batch statistics synced over `mesh`), the
        fence on `cls_preds` (as the JAX step, trainer.py:199-211), and the
        loss: (loss dict, preds)."""
        preds = self.model(frames.voxels, frames.num_points_per_voxel, frames.coors, train=True, mesh=mesh)
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
    def train_step(self, state: TrainState, batch: TrainBatch, mesh=None):
        """One optimizer step → (state, loss dict, metric counts). With
        `mesh` (a `parallel.mesh.DataMesh`), the per-rank body of a
        data-parallel step on this rank's slice of the batch: sync-BN, and
        the gradients and losses averaged and the counts summed over the
        ranks (the JAX step's `pmean` / `psum`, trainer.py:226-234). The
        losses are means per sample over the local batch, so their mean
        over equal slices is the global batch's."""
        batch = self.to_device(batch)
        frames, tgt = self.prepare(batch, state.step, None if mesh is None else mesh.rank)
        loss_dict, preds = self.forward_loss(frames, tgt, mesh)
        for p in self.params:
            p.grad = None
        loss_dict["loss"].backward()
        with torch.no_grad():
            metrics = binary_counts(tgt.labels, preds["cls_preds"])
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        if mesh is not None:
            pmean_gradients(self.params, mesh)
            loss_dict, metrics = pmean(loss_dict, mesh), psum(metrics, mesh)
        self.apply_gradients(state)
        return state, loss_dict, metrics

    # -- eval forward (for the in-training eval loop) -----------------------
    def eval_step(self, points, num_points) -> Detections:
        """Inference of one padded frame (max_points, C) on the trainer's
        model: the JAX Trainer.eval_step (trainer.py:250-267). The model
        takes its mode from `train=`, never from `module.training`, so an
        eval between two steps leaves the next step as it was."""
        return self.detector.infer(torch.as_tensor(points, device=self.device), int(num_points))


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
