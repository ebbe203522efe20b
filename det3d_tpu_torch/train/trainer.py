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
`train_step_jit` is the same step as one captured CUDA graph, replayed
with one host dispatch (`CapturedTrainStep`; the JAX trainer's jitted,
donating step), with a mesh the data-parallel or hybrid step with its
collectives inside the graph, and `eval_step_jit` the detector's captured
frame.

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

`train_step(state, batch, mesh=HybridMesh)` is the per-rank body of the
hybrid data x spatial step (`parallel/mesh.make_spatial_train`, a
`Trainer(spatial=...)`): the batch is this rank's data group's slice, the
same on every rank of its spatial group, which splits the RPN along x and
computes the matcher, the loss and the metrics whole from the gathered
preds. Sync-BN, the loss mean and the metric sums run over the data group
(over the world they would count each sample sp times); the gradients,
each rank's share of the sum over its spatial group, take one all-reduce
over the world divided by dp; the augmentation draws by the data rank, so
that a spatial group draws one transform.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.data import augment as agm
from det3d_tpu_torch.kernels.fence_cuda import s2b_fence
from det3d_tpu_torch.losses import detection_loss
from det3d_tpu_torch.ops import geometry
from det3d_tpu_torch.ops.voxelize import VoxelizedFrame
from det3d_tpu_torch.parallel.mesh import HybridMesh, groups, pmean, pmean_gradients, psum
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.postprocess import Detections
from det3d_tpu_torch.targets import TargetAssignment, make_target_assigner
from det3d_tpu_torch.train.metrics import binary_counts
from det3d_tpu_torch.utils.graphs import CapturedCall

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


def fill_adam_scalars(scalars: list[torch.Tensor], step: int, lr: float) -> None:
    """Step `step`'s two bias corrections (float32 on the host, as optax
    computes them) and -lr into three 0-d tensors. `fill_` passes a host
    scalar as a kernel argument: no copy and no sync, and a captured update
    reads each step's values from the same tensors."""
    for t, value in zip(scalars, (_bias_correction(ADAM_B1, step), _bias_correction(ADAM_B2, step), -lr)):
        t.fill_(value)


@torch.no_grad()
def clip_and_adam(params: list[torch.Tensor], mu: list[torch.Tensor], nu: list[torch.Tensor],
                  scalars: list[torch.Tensor]) -> None:
    """Clip the parameters' `.grad` by global norm in optax's form (g if
    norm < 10 else g / norm * 10, written as g / d * m with d, m = 1 or
    norm, 10, so no host sync), then Adam with optax's order of operations
    (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) on the moments in place, then
    params += update; `scalars` from `fill_adam_scalars`. Device ops only."""
    bias1, bias2, neg_lr = scalars
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < MAX_GRAD_NORM
    grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))  # p.grad stays as it was
    torch._foreach_mul_(grads, torch.where(keep, 1.0, MAX_GRAD_NORM))

    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - ADAM_B1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - ADAM_B2)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_add_(nu, sq)
    mu_hat = torch._foreach_div(mu, bias1)
    denom = torch._foreach_div(nu, bias2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    updates = torch._foreach_div(mu_hat, denom)
    torch._foreach_mul_(updates, neg_lr)
    torch._foreach_add_(params, updates)


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
    (`device_augment`).

    `spatial`: a spatial group over which the network is split (the
    detector's); `fence=False` leaves the fence out of the step (the JAX
    trainer's `s2b_fence`; `make_spatial_train`'s default)."""

    def __init__(self, cfg: Config, device=None, *, device_global_augment: bool = False, aug_seed: int = 0,
                 spatial=None, fence: bool = True):
        self.cfg = cfg
        self.detector = Detector(cfg, device, spatial=spatial)
        self.device = self.detector.device
        self.model = self.detector.model
        self.params = list(self.model.parameters())
        self.assigner = make_target_assigner(cfg, self.detector.anchor_set, self.device)
        self.fence = s2b_fence if fence else _no_fence
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

    def prepare(self, batch: TrainBatch, step: int = 0, rank: int | None = None,
                aug: dict | None = None) -> tuple[VoxelizedFrame, TargetAssignment]:
        """(The global augmentation of step `step`, where the trainer applies
        it, drawn for `rank` in a data-parallel step, or with the draws
        `aug`, then) per sample voxelize + anchor mask, then one target
        assignment for the stacked batch (trainer.py:124-161 of the JAX
        package)."""
        points, gt_boxes, gt_valid = batch.points, batch.gt_boxes, batch.gt_valid
        if self.device_global_augment:
            params = aug if aug is not None else self.augment_params(step, points.shape[0], rank)
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
        preds = self.model(frames.voxels, frames.num_points_per_voxel, frames.coors, train=True, mesh=mesh,
                           spatial=self.detector.spatial)
        preds = dict(preds, cls_preds=self.fence(preds["cls_preds"]))
        loss_dict = detection_loss(preds, tgt.labels, tgt.bbox_targets, tgt.dir_targets)
        return loss_dict, preds

    def apply_gradients(self, state: TrainState) -> TrainState:
        """One optimizer update from the parameters' `.grad`: the state's
        step advances, its bias corrections and -lr go into three 0-d
        tensors (`fill_adam_scalars`), then `clip_and_adam` on its moments.
        The captured step launches the same kernels, its three tensors
        filled before each replay."""
        state.step += 1
        scalars = [torch.empty((), dtype=self.params[0].dtype, device=self.params[0].device) for _ in range(3)]
        fill_adam_scalars(scalars, state.step, state.lr)
        clip_and_adam(self.params, state.mu, state.nu, scalars)
        return state

    # -- the step ----------------------------------------------------------
    def augment_draws(self, step: int, batch, rank: int | None = None) -> dict | None:
        """The step's global-augmentation parameters where the trainer
        applies it, else None."""
        return self.augment_params(step, batch.points.shape[0], rank) if self.device_global_augment else None

    def forward_backward(self, batch: TrainBatch, aug: dict | None = None, mesh=None):
        """prepare → forward and fence → loss → backward into the
        parameters' `.grad` (set to None first) → (loss dict, metric
        counts), on device tensors: the body that the eager and the
        captured step share."""
        frames, tgt = self.prepare(batch, aug=aug)
        loss_dict, preds = self.forward_loss(frames, tgt, mesh)
        for p in self.params:
            p.grad = None
        loss_dict["loss"].backward()
        with torch.no_grad():
            metrics = binary_counts(tgt.labels, preds["cls_preds"])
        return {k: v.detach() for k, v in loss_dict.items()}, metrics

    def train_step(self, state: TrainState, batch: TrainBatch, mesh=None):
        """One optimizer step → (state, loss dict, metric counts). With
        `mesh` (a `parallel.mesh.DataMesh`), the per-rank body of a
        data-parallel step on this rank's slice of the batch: sync-BN, and
        the gradients and losses averaged and the counts summed over the
        ranks (the JAX step's `pmean` / `psum`, trainer.py:226-234). The
        losses are means per sample over the local batch, so their mean
        over equal slices is the global batch's. With a `HybridMesh`, the
        hybrid step (see the module docstring)."""
        data = _data_axis(mesh)
        batch = self.to_device(batch)
        aug = self.augment_draws(state.step, batch, None if data is None else data.rank)
        loss_dict, metrics = self.forward_backward(batch, aug, data)
        loss_dict, metrics = self.reduce_over(mesh, loss_dict, metrics)
        self.apply_gradients(state)
        return state, loss_dict, metrics

    def reduce_over(self, mesh, loss_dict: dict, metrics: dict) -> tuple[dict, dict]:
        """A step's reductions after its backward (none without `mesh`): the
        parameters' `.grad` averaged over the ranks (over the world, divided
        by dp, on a `HybridMesh`), the loss terms averaged and the metric
        counts summed over the data axis → (loss dict, metric counts)."""
        if isinstance(mesh, HybridMesh):
            pmean_gradients(self.params, mesh.world, mesh.dp)
        elif mesh is not None:
            pmean_gradients(self.params, mesh)
        data = _data_axis(mesh)
        if data is not None:
            loss_dict, metrics = pmean(loss_dict, data), psum(metrics, data)
        return loss_dict, metrics

    @functools.cached_property
    def train_step_jit(self) -> "CapturedTrainStep":
        """`train_step(state, batch, mesh=None)` as one captured CUDA graph
        on the card (op by op on the CPU): the JAX trainer's
        `jax.jit(train_step, donate_argnums=(0,))`, and with a mesh the
        JAX package's jitted sharded and hybrid steps
        (`parallel/mesh.make_sharded_train_step`, `make_spatial_train`).
        See `CapturedTrainStep`."""
        return CapturedTrainStep(self)

    # -- eval forward (for the in-training eval loop) -----------------------
    def eval_step(self, points, num_points) -> Detections:
        """Inference of one padded frame (max_points, C) on the trainer's
        model: the JAX Trainer.eval_step (trainer.py:250-267). The model
        takes its mode from `train=`, never from `module.training`, so an
        eval between two steps leaves the next step as it was."""
        return self.detector.infer(torch.as_tensor(points, device=self.device), int(num_points))

    @property
    def eval_step_jit(self):
        """The compiled eval forward: the detector's `infer_jit` (the JAX
        trainer's `eval_step_jit`, trainer.py:254-266), for a spatial
        trainer with the frame's collectives over its spatial group inside
        the graph. The graph reads the parameters and running statistics in
        place, so it sees every update of the train step, eager or
        captured."""
        return self.detector.infer_fn


class CapturedTrainStep:
    """`Trainer.train_step_jit`: `train_step(state, batch, mesh)` as one
    `utils.graphs.CapturedCall` over static buffers — the batch's upload,
    `prepare`, forward and fence, the loss, the backward into the
    parameters' `.grad` (graph-pool tensors after the capture), the step's
    collectives over the mesh (`Trainer.reduce_over`, and with it the
    sync-BN and, on a spatial trainer, the halo, InstanceNorm and preds
    collectives) and the clip and Adam on the moments — with the live
    model's parameters and running statistics read and updated in place.

    The mesh (None, a `DataMesh`, or a `HybridMesh` for a spatial trainer)
    is the one of the first call; a call with another raises. Every rank of
    the mesh must step alike, as the eager step needs: each warms up and
    captures at its first call.

    The graph owns the moments of the first state it is given: a state
    whose moments are other tensors (a restored checkpoint, `init_state`)
    is copied into them in place and never recaptured, as JAX's donated
    state is chained forward; the returned state holds the owned moments.
    The step count and lr stay on the host: before each replay the step's
    bias corrections and -lr are filled into three 0-d device tensors, and
    with `device_global_augment` the step's draws are made outside the
    graph (`Trainer.augment_params`, a generator seeded per step and data
    rank) and copied into static inputs. The loss dict and metric counts
    are the graph's buffers, overwritten by the next call."""

    def __init__(self, trainer: Trainer):
        # the trainer caches this callable: a strong reference back would
        # make a cycle that keeps the graph's pool until the collector runs
        self._trainer = weakref.ref(trainer)
        self.mesh = None
        self.mu: list[torch.Tensor] | None = None
        self.nu: list[torch.Tensor] | None = None
        self.call: CapturedCall | None = None
        self.scalars = [torch.zeros((), dtype=trainer.params[0].dtype, device=trainer.device) for _ in range(3)]

    @property
    def captures(self) -> int:
        return 0 if self.call is None else self.call.captures

    def __call__(self, state: TrainState, batch: TrainBatch, mesh=None):
        t = self._trainer()
        if self.call is None:
            self.mesh = mesh
            self.mu, self.nu = state.mu, state.nu
            body = functools.partial(_captured_body, self._trainer, self.mu, self.nu, self.scalars, self.mesh)
            spatial = [] if t.detector.spatial is None else [t.detector.spatial.mesh]
            self.call = CapturedCall(body, t.device, preserve=[*t.params, *t.model.buffers(), *self.mu, *self.nu],
                                     meshes=[*groups(self.mesh), *spatial])
        elif mesh is not self.mesh:
            raise ValueError("this trainer's step was captured for another mesh: a trainer's captured step "
                             "serves one mesh (its eager step takes any: train_step(state, batch, mesh=...))")
        elif not all(a is b for a, b in zip(state.mu + state.nu, self.mu + self.nu)):
            with torch.no_grad():
                for owned, given in zip(self.mu + self.nu, state.mu + state.nu):
                    owned.copy_(given)
            state = dataclasses.replace(state, mu=self.mu, nu=self.nu)
        data = _data_axis(self.mesh)
        aug = t.augment_draws(state.step, batch, None if data is None else data.rank)
        state.step += 1
        fill_adam_scalars(self.scalars, state.step, state.lr)
        loss_dict, metrics = self.call(TrainBatch(*batch), *(() if aug is None else (aug,)))
        return state, loss_dict, metrics


def _captured_body(trainer_ref, mu, nu, scalars, mesh, batch: TrainBatch, aug: dict | None = None):
    """The captured step's function: it holds no `CapturedTrainStep`, so
    the callable and its graph go as soon as the trainer does."""
    trainer = trainer_ref()
    loss_dict, metrics = trainer.forward_backward(batch, aug, _data_axis(mesh))
    loss_dict, metrics = trainer.reduce_over(mesh, loss_dict, metrics)
    clip_and_adam(trainer.params, mu, nu, scalars)
    return loss_dict, metrics


def _data_axis(mesh):
    """The group of a step's data axis: the mesh, or a `HybridMesh`'s data
    group."""
    return mesh.data if isinstance(mesh, HybridMesh) else mesh


def _no_fence(x: torch.Tensor) -> torch.Tensor:
    return x


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
