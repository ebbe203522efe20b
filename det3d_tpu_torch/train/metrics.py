"""Running precision/recall of the anchor classification logits in training.

Counterpart of the JAX package's train/metrics.py (reference:
framework/metrics.py:5-67): thresholds [0.1, 0.3, 0.5, 0.7], TP / (TP+FN)
and TP / (TP+FP) accumulated over steps. `binary_counts` runs on the
device; `RunningMetrics` is a small host-side accumulator.
"""

from __future__ import annotations

import numpy as np
import torch

THRESHOLDS = (0.1, 0.3, 0.5, 0.7)


def binary_counts(labels: torch.Tensor, cls_logits: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-threshold float32 TP/FP/FN counts (4,) over anchors with label
    != -1. labels (B, nch, fx, fy) int32; cls_logits (B, 1, nch, fx, fy), or
    any shape that reshapes to the labels' (reference metrics.py:54-67)."""
    scores = torch.sigmoid(cls_logits.to(torch.float32)).reshape(labels.shape)
    weights = (labels != -1).to(torch.float32)
    trues = labels > 0
    falses = labels == 0
    # float32 compares against each threshold (no host-to-card copy)
    pred_true = torch.stack([scores > t for t in THRESHOLDS])  # (T, B, ...)
    axes = tuple(range(1, pred_true.dim()))
    tp = (weights[None] * (trues[None] & pred_true)).sum(dim=axes)
    fp = (weights[None] * (falses[None] & pred_true)).sum(dim=axes)
    fn = (weights[None] * (trues[None] & ~pred_true)).sum(dim=axes)
    return {"tp": tp, "fp": fp, "fn": fn}


class RunningMetrics:
    """Host-side accumulator with the reference's update/clear/print surface
    (framework/metrics.py:14-51)."""

    def __init__(self) -> None:
        self.clear()

    def clear(self) -> None:
        n = len(THRESHOLDS)
        self.rec_count = np.zeros(n)
        self.rec_total = np.zeros(n)
        self.prec_count = np.zeros(n)
        self.prec_total = np.zeros(n)

    def update(self, counts: dict) -> None:
        tp, fp, fn = (np.asarray(torch.as_tensor(counts[k]).cpu()) for k in ("tp", "fp", "fn"))
        rec = tp + fn
        prec = tp + fp
        upd_r = rec > 0
        upd_p = prec > 0
        self.rec_count[upd_r] += rec[upd_r]
        self.rec_total[upd_r] += tp[upd_r]
        self.prec_count[upd_p] += prec[upd_p]
        self.prec_total[upd_p] += tp[upd_p]

    @property
    def value(self):
        prec = self.prec_total / np.maximum(self.prec_count, 1.0)
        rec = self.rec_total / np.maximum(self.rec_count, 1.0)
        return prec, rec

    def __str__(self) -> str:
        prec, rec = self.value
        return "  ".join(
            "@%.2f prec:%.5f, rec:%.5f" % (t, prec[i], rec[i]) for i, t in enumerate(THRESHOLDS)
        )
