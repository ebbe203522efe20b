"""Training losses: sigmoid focal classification + smooth-L1 localisation
(sin-difference yaw) + softmax direction, normalised per sample by its
positive count.

Counterpart of the JAX package's losses.py (reference:
framework/loss_generator.py): weights and reductions of `generate`
(:26-72) under `NormByNumPositives` (:91-94), focal loss γ=2 α=0.25
(:131-163), smooth-L1 σ=3 with unit code weights (:173-197), and the
direction softmax with per-anchor positive weights (:56-63). All in
float32 on the preds contract's spatial channel-major layouts, in the JAX
package's order of operations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossWeights(NamedTuple):
    cls_weight: float = 1.0
    loc_weight: float = 0.25
    dir_weight: float = 0.2


def prepare_loss_weights(labels: torch.Tensor):
    """Per-anchor cls/reg weights under NormByNumPositives
    (reference: framework/loss_generator.py:74-94): each sample's weights
    are divided by its positive count (at least 1)."""
    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0
    cls_weights = negatives.to(torch.float32) + positives.to(torch.float32)
    reg_weights = positives.to(torch.float32)
    anchor_axes = tuple(range(1, labels.dim()))
    pos_normalizer = torch.clamp(positives.to(torch.float32).sum(dim=anchor_axes, keepdim=True), min=1.0)
    return cls_weights / pos_normalizer, reg_weights / pos_normalizer, cared


def _smooth_l1(d: torch.Tensor) -> torch.Tensor:
    ad = torch.abs(d)
    cut = 1.0 / 9.0  # sigma = 3
    lt = (ad <= cut).to(torch.float32)
    return lt * 0.5 * torch.square(ad * 3.0) + (ad - 0.5 * cut) * (1.0 - lt)


def detection_loss(
    preds: dict[str, torch.Tensor],
    labels: torch.Tensor,       # (B, nch, fx, fy) int32
    reg_targets: torch.Tensor,  # (B, 7, nch, fx, fy) channel-major
    dir_targets: torch.Tensor,  # (B, nch, fx, fy) int32
    weights: LossWeights = LossWeights(),
) -> dict[str, torch.Tensor]:
    """Total detection loss and its components (reference:
    framework/loss_generator.py:26-72), each a float32 scalar."""
    batch = labels.shape[0]
    cls_weights, reg_weights, cared = prepare_loss_weights(labels)

    # classification: k = 1, squeezed onto the labels' shape
    cls_logits = preds["cls_preds"].to(torch.float32).reshape(labels.shape)
    cls_targets = (labels * cared.to(labels.dtype)).to(torch.float32)
    ce = torch.clamp(cls_logits, min=0.0) - cls_logits * cls_targets + torch.log1p(torch.exp(-torch.abs(cls_logits)))
    probs = torch.sigmoid(cls_logits)
    p_t = cls_targets * probs + (1 - cls_targets) * (1 - probs)
    alpha_w = cls_targets * 0.25 + (1 - cls_targets) * 0.75
    cls_loss = torch.square(1.0 - p_t) * alpha_w * ce * cls_weights  # γ = 2

    cls_loss_reduced = cls_loss.sum() / batch * weights.cls_weight
    pos = (labels > 0).to(torch.float32)
    neg = (labels == 0).to(torch.float32)
    cls_pos_loss = (pos * cls_loss).sum() / batch
    cls_neg_loss = (neg * cls_loss).sum() / batch

    # localisation, channel-major (B, 7, nch, fx, fy); the yaw residual is
    # sin(p − t), the difference of the reference's sin(p)cos(t) and
    # cos(p)sin(t) terms (loss_generator.py:122-128)
    box_p = preds["box_preds"].to(torch.float32)
    reg_t = reg_targets.to(torch.float32)
    diff6 = box_p[:, :6] - reg_t[:, :6]
    diff_yaw = torch.sin(box_p[:, 6] - reg_t[:, 6])
    loc_loss_reduced = (
        ((_smooth_l1(diff6) * reg_weights[:, None]).sum() + (_smooth_l1(diff_yaw) * reg_weights).sum())
        / batch
        * weights.loc_weight
    )

    # direction: 2-logit softmax cross-entropy on positive anchors
    dir_logits = preds["dir_preds"].to(torch.float32)  # (B, 2, nch, fx, fy)
    l0, l1 = dir_logits[:, 0], dir_logits[:, 1]
    m = torch.maximum(l0, l1)
    lse = m + torch.log(torch.exp(l0 - m) + torch.exp(l1 - m))
    picked = torch.where(dir_targets > 0, l1, l0)
    anchor_axes = tuple(range(1, labels.dim()))
    dir_w = pos / torch.clamp(pos.sum(dim=anchor_axes, keepdim=True), min=1.0)
    dir_loss = ((lse - picked) * dir_w).sum() / batch

    loss = loc_loss_reduced + cls_loss_reduced + dir_loss * weights.dir_weight
    return {
        "loss": loss,
        "cls_loss": cls_loss_reduced,
        "loc_loss": loc_loss_reduced,
        "dir_loss": dir_loss,
        "cls_pos_loss": cls_pos_loss,
        "cls_neg_loss": cls_neg_loss,
    }
