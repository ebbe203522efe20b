"""Anchor target assignment on the device (static shapes).

Counterpart of the JAX package's targets.py (reference: AnchorAssigner.
assign, framework/anchor_assigner.py:337-457). Per class: nearest-axis BEV
IoU of every anchor against the class's gt, bidirectional argmax,
force-matching of each gt's best anchors (ties included), thresholding to
labels {-1, 0, 1}, the regression encode of the matched gt and the
direction target. Semantics, as in the JAX package:
  * excluded anchors (mask 0) get IoU -1 against every gt, so they are
    never selected or force-matched, and end with label -1, target 0,
    weight 0;
  * gt padding gets IoU -1, so with no valid gt every included anchor's
    best IoU is -1 and its label is 0;
  * a gt whose best IoU is exactly 0 force-matches nothing;
  * dir is (yaw target + anchor yaw) > 0 for every anchor, masked ones
    included: a zero target on a π/2 anchor gives 1.

`TargetAssigner` works on a batch and dispatches on the device of its
input: CUDA tensors go through `kernels/matcher_cuda.py` (two launches per
call, all classes and samples; the kernels cull by the anchor chunks'
bounding boxes, `chunk_boxes`), CPU tensors through the plain dense
`_assign_one_class` per sample and class.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from det3d_tpu_torch.anchors import AnchorSet
from det3d_tpu_torch.config import Config
from det3d_tpu_torch.kernels import matcher_cuda
from det3d_tpu_torch.ops.geometry import box_encode_transposed, iou_matrix, rbbox2d_to_near_bbox


class TargetAssignment(NamedTuple):
    """Spatial anchor-major target maps with a leading batch axis: the
    anchor axes are (nch, fx, fy), the preds contract's form; row-major
    flatten of (nch, fx, fy) is the flat anchor order."""

    labels: torch.Tensor                # (B, nch, fx, fy) int32 in {-1, 0, 1}
    bbox_targets: torch.Tensor          # (B, 7, nch, fx, fy) float32, channel-major
    bbox_outside_weights: torch.Tensor  # (B, nch, fx, fy) float32
    dir_targets: torch.Tensor           # (B, nch, fx, fy) int32 in {0, 1}


def gt_standup(gt_boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) gt boxes → (..., 4) nearest-axis standup boxes of their
    [x, y, l, w, yaw] (gathered by slices, which copy nothing to the card)."""
    bev = torch.cat([gt_boxes[..., 0:2], gt_boxes[..., 3:5], gt_boxes[..., 6:7]], dim=-1)
    return rbbox2d_to_near_bbox(bev)


def _overlaps(anchors_bv, anchors_mask, gt_boxes, gt_valid) -> torch.Tensor:
    """(G, Ac) IoU of the class's gt against its anchors; -1 for padding gt
    and excluded anchors."""
    overlap = iou_matrix(gt_standup(gt_boxes), anchors_bv, eps=0.0)
    return torch.where(gt_valid[:, None] & anchors_mask[None, :], overlap, -1.0)


def gt_max_one_class(anchors_bv, anchors_mask, gt_boxes, gt_valid) -> torch.Tensor:
    """(G,) best IoU of each gt over the class's included anchors (-1 where
    there is none): the plain twin of the matcher's pass 1."""
    return _overlaps(anchors_bv, anchors_mask, gt_boxes, gt_valid).amax(dim=1)


def _assign_one_class(
    anchors: torch.Tensor,       # (Ac, 7)
    anchors_bv: torch.Tensor,    # (Ac, 4)
    anchors_mask: torch.Tensor,  # (Ac,) bool
    gt_boxes: torch.Tensor,      # (G, 7) padded
    gt_valid: torch.Tensor,      # (G,) bool (this class & real)
    matched_threshold: float,
    unmatched_threshold: float,
):
    """Dense one-class assignment (the JAX package's `_assign_one_class`):
    labels (Ac,) int32, targets (7, Ac) float32, weights (Ac,) float32,
    dir (Ac,) int32."""
    overlap = _overlaps(anchors_bv, anchors_mask, gt_boxes, gt_valid)   # (G, Ac)
    included = anchors_mask
    anchor_to_gt_argmax = torch.argmax(overlap, dim=0)  # first maximum on ties
    anchor_to_gt_max = overlap.amax(dim=0)
    gt_to_anchor_max = overlap.amax(dim=1)
    # gts with zero best overlap must not force-match (reference :374-375)
    force = (
        (overlap == gt_to_anchor_max[:, None])
        & (gt_to_anchor_max[:, None] > 0)
        & gt_valid[:, None]
        & included[None, :]
    )
    pos = force.any(dim=0) | (anchor_to_gt_max >= matched_threshold)
    bg = anchor_to_gt_max < unmatched_threshold
    labels = torch.where(pos, 1, torch.where(bg, 0, -1)).to(torch.int32)
    labels = torch.where(included, labels, -1)

    matched_gt_t = gt_boxes.T[:, anchor_to_gt_argmax]                  # (7, Ac)
    encoded_t = box_encode_transposed(matched_gt_t, anchors.T)
    fg = labels > 0
    targets = torch.where(fg[None, :], encoded_t, 0.0)
    # direction from the (possibly zero-filled) yaw target, as reference
    # get_direction_target (:454-457)
    dirs = ((targets[-1] + anchors[:, -1]) > 0).to(torch.int32)
    return labels, targets, fg.to(torch.float32), dirs


def chunk_boxes(anchors_bv: np.ndarray, chunk: int) -> np.ndarray:
    """(A, 4) standup boxes → (ceil(A / chunk), 4) float32: the bounding box
    [min x1, min y1, max x2, max y2] of every `chunk` consecutive anchors
    (the last chunk may be short). A gt whose standup box is disjoint from a
    chunk's box overlaps none of the chunk's anchors, whatever the anchor
    set's order; the matcher kernels skip such pairs."""
    starts = np.arange(0, anchors_bv.shape[0], chunk)
    if starts.size == 0:
        return np.zeros((0, 4), np.float32)
    lo = np.minimum.reduceat(anchors_bv[:, :2], starts, axis=0)
    hi = np.maximum.reduceat(anchors_bv[:, 2:], starts, axis=0)
    return np.ascontiguousarray(np.concatenate([lo, hi], axis=1), dtype=np.float32)


class TargetAssigner:
    """`assigner(gt_boxes, gt_classes, gt_valid, anchors_mask)` for a batch:
    gt_boxes (B, G, 7) float32 padded to `cfg.max_gt_boxes` (padding rows
    with nonzero dims, see `pad_gt`), gt_classes (B, G) int32 1-based in
    `cfg.class_specs` order, gt_valid (B, G) bool, anchors_mask
    (B, nch, fx, fy) bool → TargetAssignment. The anchor set lives on
    `device`."""

    def __init__(self, cfg: Config, anchor_set: AnchorSet, device):
        self.grid_hw = anchor_set.grid_hw
        hw = self.grid_hw[0] * self.grid_hw[1]
        self.channels = [anchor_set.class_channels[s.name] for s in cfg.class_specs]
        starts = [c0 * hw for c0, _ in self.channels] + [anchor_set.num_anchors]
        if starts[0] != 0 or any(c1 != n for (_, c1), (n, _) in zip(self.channels, self.channels[1:])):
            raise ValueError("class channel ranges must tile the anchor set in class order")
        self.thresholds = [(s.matched_threshold, s.unmatched_threshold) for s in cfg.class_specs]
        self.tables = matcher_cuda.MatcherTables(
            anchors=torch.from_numpy(anchor_set.anchors).to(device),
            anchors_bv=torch.from_numpy(np.ascontiguousarray(anchor_set.anchors_bv)).to(device),
            class_start=torch.tensor(starts, dtype=torch.int32, device=device),
            thresholds=torch.tensor(self.thresholds, dtype=torch.float32, device=device),
            anchors_t=torch.from_numpy(np.ascontiguousarray(anchor_set.anchors.T)).to(device),
            chunk_bv=torch.from_numpy(chunk_boxes(anchor_set.anchors_bv, matcher_cuda.CHUNK)).to(device),
        )

    def __call__(self, gt_boxes, gt_classes, gt_valid, anchors_mask) -> TargetAssignment:
        if anchors_mask.device.type == "cuda":
            return self.kernel(gt_boxes, gt_classes, gt_valid, anchors_mask)
        if anchors_mask.device.type == "cpu":
            return self.plain(gt_boxes, gt_classes, gt_valid, anchors_mask)
        raise ValueError(f"unsupported device {anchors_mask.device}")

    def _spatial(self, labels, targets, weights, dirs) -> TargetAssignment:
        b = labels.shape[0]
        fx, fy = self.grid_hw
        return TargetAssignment(
            labels=labels.reshape(b, -1, fx, fy),
            bbox_targets=targets.reshape(b, 7, -1, fx, fy),
            bbox_outside_weights=weights.reshape(b, -1, fx, fy),
            dir_targets=dirs.reshape(b, -1, fx, fy),
        )

    def kernel(self, gt_boxes, gt_classes, gt_valid, anchors_mask) -> TargetAssignment:
        """The CUDA matcher: one launch of each pass for the whole batch."""
        b = anchors_mask.shape[0]
        out = matcher_cuda.match_cuda(
            self.tables, anchors_mask.reshape(b, -1), gt_boxes, gt_standup(gt_boxes), gt_classes, gt_valid
        )
        return self._spatial(*out)

    def plain(self, gt_boxes, gt_classes, gt_valid, anchors_mask) -> TargetAssignment:
        """The plain dense path, per sample and class, on any device."""
        hw = self.grid_hw[0] * self.grid_hw[1]
        anchors, anchors_bv = self.tables.anchors, self.tables.anchors_bv
        per_sample = []
        for i in range(anchors_mask.shape[0]):
            parts = []
            for ci, ((c0, c1), (mth, uth)) in enumerate(zip(self.channels, self.thresholds)):
                rows = slice(c0 * hw, c1 * hw)
                parts.append(_assign_one_class(
                    anchors[rows], anchors_bv[rows], anchors_mask[i, c0:c1].reshape(-1),
                    gt_boxes[i], gt_valid[i] & (gt_classes[i] == ci + 1), mth, uth,
                ))
            per_sample.append([torch.cat([p[k] for p in parts], dim=-1) for k in range(4)])
        return self._spatial(*(torch.stack([s[k] for s in per_sample]) for k in range(4)))

    def gt_max_plain(self, gt_boxes, gt_classes, gt_valid, anchors_mask) -> torch.Tensor:
        """(B, G) each gt's best IoU over its class's included anchors, -1
        where there is none: the plain twin of `matcher_cuda.gt_max_bits_cuda`
        followed by `decode_gt_max`."""
        hw = self.grid_hw[0] * self.grid_hw[1]
        out = torch.full(gt_valid.shape, -1.0, device=gt_boxes.device)
        for i in range(anchors_mask.shape[0]):
            for ci, (c0, c1) in enumerate(self.channels):
                cls_valid = gt_valid[i] & (gt_classes[i] == ci + 1)
                best = gt_max_one_class(
                    self.tables.anchors_bv[c0 * hw : c1 * hw], anchors_mask[i, c0:c1].reshape(-1),
                    gt_boxes[i], cls_valid,
                )
                out[i] = torch.where(cls_valid, best, out[i])
        return out


def make_target_assigner(cfg: Config, anchor_set: AnchorSet, device) -> TargetAssigner:
    """The batch target assigner of `cfg` with its anchor set on `device`."""
    return TargetAssigner(cfg, anchor_set, device)


def pad_gt(cfg: Config, gt_boxes: np.ndarray, gt_classes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host helper: pad variable gt to (max_gt_boxes, ...) static shapes;
    padding rows get unit dims so the masked encode's logs stay finite."""
    g = cfg.max_gt_boxes
    n = min(gt_boxes.shape[0], g)
    boxes = np.zeros((g, 7), np.float32)
    boxes[:, 3:6] = 1.0
    classes = np.zeros((g,), np.int32)
    valid = np.zeros((g,), bool)
    boxes[:n] = gt_boxes[:n]
    classes[:n] = gt_classes[:n]
    valid[:n] = True
    return boxes, classes, valid
