"""End-to-end detector: raw points → detections, on one device.

Counterpart of the JAX package's pipeline.py (reference: InferData.get →
net(example) → Inference.infer_gpu, framework/dataset.py:199-231,
networks/pointpillars8_shared.py:346-382, framework/inference.py:26-138):
voxelization, the anchor mask, the network and post-processing run on the
detector's device with no host round trip until `detect` formats the
result. PyTorch runs eagerly, so the stages are plain method calls; the two
CUDA kernels (the BEV scatter of the config's layout, NMS) each launch once
per frame on the card, or once per batch in `infer_batch`. The compiled
entry points, `infer_jit` and `infer_batch_jit`, capture the same module
as one CUDA graph (one per batch size) and replay it, the JAX detector's
`infer_jit` and `jax.jit(jax.vmap(infer))`; `detect` goes through
`infer_jit`, as the JAX detector's does.

With a spatial group (`Detector(cfg, spatial=mesh)`,
`parallel/mesh.make_spatial_infer`) the network's scatter, RPN and head
run on this rank's slab of the canvas (`parallel/spatial.py`); voxelize,
the anchor mask and the PFN before them, and decode and NMS on the gathered
preds after them, run whole on every rank of the group, as JAX runs them
replicated, so every rank holds the frame's `Detections`; `infer_jit`
captures the frame with its collectives, as JAX jits it.

The whole points → detections function is one module, `DetectorModule`,
whose buffers hold every device constant of the path, so that
`deploy/export.py` exports it as it is and the live detector and the
exported program run the same code.

The center model (`cfg.head == "center"`, CenterPoint-PP:
`models/centerpoint.py`, `postprocess.CenterPostProcessor`) takes the same
module, entry points and stages (both post-processors decode a frame or a
batch, `decode_frame` / `decode_frames`, for `finalize_stage` /
`finalize_frames`): it has no anchors, so no anchor mask; its network's
predictions are one dict a task, its decode takes every task of every frame
at once and its NMS call is rotated, one row a task of every frame.

Tracing (`utils.timing`, on while a profiler runs): `detect` is the root
span of a frame, `pad_points` the span `pad`; `forward` and
`forward_batch` place the stage marks `start`, `preprocess` (voxelize and
the anchor mask), `neck` (placed by the network between its RPN and its
head), `network`, `decode` (decode, gate and top-k) and `postprocess` (NMS,
finalize), which a captured call's graph holds as event nodes;
`CapturedInfer` counts `call.rows_staged` (the rows a call stages, B ×
`max_points`), `call.rows_real` (the points in them) and `nms.rows` (the
rows of the call's NMS, B × classes or tasks).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from det3d_tpu_torch.anchors import AnchorSet, build_anchors
from det3d_tpu_torch.config import Config
from det3d_tpu_torch.models.centerpoint import CenterPointPP
from det3d_tpu_torch.models.centerpoint import init_weights as init_center_weights
from det3d_tpu_torch.models.pointpillars import PointPillars, init_weights
from det3d_tpu_torch.ops.anchor_mask import compute_anchors_mask, compute_anchors_mask_separable
from det3d_tpu_torch.ops.voxelize import VoxelizedFrame, VoxelizerSpec, grid_tensors, voxelize
from det3d_tpu_torch.parallel.spatial import SpatialPlan
from det3d_tpu_torch.postprocess import (CenterPostProcessor, Detections, PostProcessor, PostProcessParams,
                                         to_annos)
from det3d_tpu_torch.utils import timing
from det3d_tpu_torch.utils.device import resolve_device
from det3d_tpu_torch.utils.graphs import CapturedCall
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

    def __init__(self, cfg: Config, anchor_set: AnchorSet | None, params: PostProcessParams | None, device,
                 spatial=None, fcfs: bool = True):
        super().__init__()
        self.spatial = spatial
        self.fcfs = fcfs
        self.center = cfg.center
        self.spec = VoxelizerSpec.from_config(cfg)
        self.grid_xy = (cfg.grid_size[0], cfg.grid_size[1])
        for name, t in zip(("voxel_size", "grid_offset", "grid_size"), grid_tensors(self.spec, device)):
            self.register_buffer(name, t, persistent=False)
        if self.center:
            if spatial is not None:
                raise ValueError("the center model has no spatial path")
            self.model = CenterPointPP(cfg).to(device).eval()
            self.postprocess = CenterPostProcessor(cfg, device)
            self.nms_rows = len(cfg.tasks)
            return
        self.nms_rows = len(cfg.class_specs)
        self.mask_shape = (anchor_set.num_channels, *cfg.feature_map_size[:2])
        self.model = PointPillars(cfg).to(device).eval()
        self.postprocess = PostProcessor(cfg, anchor_set, params, device)
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

    def preprocess(self, points: torch.Tensor, num_points) -> tuple[VoxelizedFrame, torch.Tensor | None]:
        """Voxelize + anchor occupancy mask (nch, fx, fy); the center model
        has no anchors and no mask (None)."""
        frame = voxelize(points, num_points, self.spec, (self.voxel_size, self.grid_offset, self.grid_size),
                         fcfs=self.fcfs)
        return frame, None if self.center else self.anchors_mask(frame.coors)

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
        timing.mark("preprocess")
        preds = self.model(frame.voxels[None], frame.num_points_per_voxel[None], frame.coors[None],
                           spatial=self.spatial)
        timing.mark("network")
        out = self.postprocess.decode_frame(preds, anchors_mask)
        timing.mark("decode")
        return out

    def forward(self, points: torch.Tensor, num_points) -> tuple[torch.Tensor, ...]:
        timing.mark("start")
        out = tuple(self.postprocess.finalize_stage(self.candidates(points, num_points)))
        timing.mark("postprocess")
        return out

    def forward_batch(self, points: torch.Tensor, num_points) -> tuple[torch.Tensor, ...]:
        """points (B, max_points, C), num_points (B,): each frame voxelized
        and masked, the network once at batch B, each frame decoded, one NMS
        call over the (B·ncls, kmax, 4) standup boxes, then the rank cap and
        compaction per frame → (B, ...) fields of `Detections`."""
        if self.spatial is not None:
            raise ValueError("a spatial detector partitions within one frame: no batch")
        timing.mark("start")
        frames = [self.preprocess(points[i], num_points[i]) for i in range(points.shape[0])]
        timing.mark("preprocess")
        preds = self.model(*(torch.stack([getattr(f, k) for f, _ in frames])
                             for k in ("voxels", "num_points_per_voxel", "coors")))
        timing.mark("network")
        candidates = self.postprocess.decode_frames(preds, [mask for _, mask in frames])
        timing.mark("decode")
        out = tuple(self.postprocess.finalize_frames(candidates))
        timing.mark("postprocess")
        return out


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
        self.anchor_set: AnchorSet | None = None if cfg.center else build_anchors(cfg)
        plan = None if spatial is None else SpatialPlan.of(spatial, cfg.grid_size[0])
        self.module = DetectorModule(cfg, self.anchor_set, postprocess_params, self.device, plan, fcfs)
        if plan is not None:
            self.module.model.check_spatial()
        self.spatial = plan
        self.model = self.module.model
        self.postprocess = self.module.postprocess
        self._batch_jits: dict[int, CapturedInfer] = {}

    # -- weights -----------------------------------------------------------
    def init_weights(self, seed: int) -> "Detector":
        """Seeded random weights (see models.pointpillars.init_weights,
        models.centerpoint.init_weights)."""
        (init_center_weights if self.cfg.center else init_weights)(self.model, seed)
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

    # -- the compiled entry points -----------------------------------------
    @functools.cached_property
    def infer_jit(self) -> "CapturedInfer":
        """`infer(points, num_points)` as one captured CUDA graph on the
        card, op by op on the CPU (`utils.graphs.CapturedCall`): the JAX
        detector's `infer_jit`. It replays the config's scatter and NMS's
        two launches with the rest of the frame, reads the weights in place
        (so it sees every update and `load_state_dict`), and returns
        Detections in its own buffers, which the next call overwrites. A
        spatial detector's graph holds the frame's collectives too (the
        halo all-gathers, the InstanceNorm all-reduces, the preds gather;
        JAX's `make_spatial_infer` jit): every rank of its group calls it
        for the same frames."""
        return CapturedInfer(self.module.forward, self.device,
                             meshes=[] if self.spatial is None else [self.spatial.mesh], nms_rows=self.module.nms_rows)

    def infer_batch_jit(self, points, num_points) -> Detections:
        """`infer_batch` as captured CUDA graphs, one per batch size (the JAX
        app's `jax.jit(jax.vmap(det.infer))`): points (B, max_points, C)
        and counts (B,), on the host or the device; Detections with a
        leading frame axis, in the graph's buffers."""
        b = int(points.shape[0])
        if b not in self._batch_jits:
            self._batch_jits[b] = CapturedInfer(self.module.forward_batch, self.device, nms_rows=b * self.module.nms_rows)
        return self._batch_jits[b](points, num_points)

    # -- host conveniences -------------------------------------------------
    def pad_points(self, points: np.ndarray) -> tuple[np.ndarray, np.int32]:
        """Pad/truncate a host point cloud to the static (max_points, C)."""
        with timing.span("pad"):
            return pad_cloud(points, self.cfg.max_points)

    @property
    def infer_fn(self):
        """The frame function every caller of a frame uses (`detect`, the
        infer, serve and train apps' eval): `infer_jit`, called with
        (points, num_points) on the host or the device → Detections."""
        return self.infer_jit

    def detect(self, points: np.ndarray) -> dict:
        """Host-facing: raw numpy point cloud → annos dict, through
        `infer_fn` (`infer_jit`, as the JAX detector's `detect`)."""
        with timing.span("detect"):
            padded, n = self.pad_points(points)
            return to_annos(self.cfg, self.infer_fn(padded, n))


class CapturedInfer:
    """A detector function of (points, counts) → Detections as a
    `CapturedCall` under `torch.no_grad()`, the counts as int32 buffers (0-d
    for one frame, (B,) for a batch); `meshes`: the groups it issues
    collectives over; `nms_rows`: the rows of its NMS call, counted a call
    while recording."""

    def __init__(self, fn, device, meshes=(), nms_rows: int = 0):
        self.call = CapturedCall(torch.no_grad()(fn), device, meshes=meshes)
        self.nms_rows = int(nms_rows)

    @property
    def captures(self) -> int:
        return self.call.captures

    def __call__(self, points, num_points) -> Detections:
        # counted where the counts are on the host: reading them off the card would wait for it
        if timing.recording() and not (isinstance(num_points, torch.Tensor) and num_points.is_cuda):
            timing.count("call.rows_staged", np.prod(points.shape[:-1]))
            timing.count("call.rows_real", np.sum(np.asarray(num_points)))
        if self.nms_rows and timing.recording():
            timing.count("nms.rows", self.nms_rows)
        return Detections(*self.call(points, torch.as_tensor(num_points, dtype=torch.int32)))
