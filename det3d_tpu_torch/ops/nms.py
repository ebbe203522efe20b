"""Fixed-shape greedy NMS: the plain PyTorch version.

Counterpart of the JAX package's `ops/nms.py` (reference: framework/nms.py).
It is the reference the CUDA kernel (`kernels/nms_cuda.py`) is held against,
and the path the kernel wrapper takes for tensors on the CPU. The JAX
package's `greedy_nms` is `rank_cap(greedy_keep(...), post_max_size)` here.

Parity notes:
  * the reference's `iou_device` uses the legacy *pixel* convention, adding
    +1 to widths/heights/areas (framework/nms.py:105-116) even though the
    boxes are metric; reproduced verbatim so keep-sets match;
  * boxes arrive sorted by descending score (the caller's top-k);
  * the output keep mask is capped at `post_max_size` by rank
    (framework/inference.py:697-698).
"""

from __future__ import annotations

import torch


def iou_pixel_convention(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., K, 4) minmax boxes → (..., K, K), with the +1
    pixel convention. The operation order is part of the contract: the CUDA
    kernel evaluates the same expressions in the same order, unfused."""
    a = boxes[..., :, None, :]
    b = boxes[..., None, :, :]
    width = torch.clamp(
        torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]) + 1.0, min=0.0
    )
    height = torch.clamp(
        torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]) + 1.0, min=0.0
    )
    inter = width * height
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    return inter / (area_a + area_b - inter)


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Exact greedy keep mask of (..., K, 4) pre-sorted boxes → (..., K) bool,
    without the rank cap.

    Frontier iteration, as in the JAX package: every round keeps each live
    candidate with no live higher-scored overlapper (its suppressors are all
    dead, so it is decided) and kills everything the new keeps suppress. The
    kept set equals the sequential sweep's; rounds equal the depth of the
    suppression chains."""
    k = boxes.shape[-2]
    idx = torch.arange(k, device=boxes.device)
    # overlap[i, j]: higher-scored i suppresses j (strict upper triangle)
    overlap = (
        (iou_pixel_convention(boxes) > iou_threshold)
        & valid[..., None, :]
        & valid[..., :, None]
        & (idx[:, None] < idx[None, :])
    )
    overlap_f = overlap.to(torch.float32)
    kept = torch.zeros_like(valid)
    remaining = valid.clone()
    while bool(remaining.any()):
        rem_f = remaining.to(torch.float32)[..., None, :]
        blocked = (rem_f @ overlap_f)[..., 0, :] > 0.0
        ready = remaining & ~blocked
        suppressed = (ready.to(torch.float32)[..., None, :] @ overlap_f)[..., 0, :] > 0.0
        kept = kept | ready
        remaining = remaining & ~ready & ~suppressed
    return kept


def rank_cap(keep: torch.Tensor, post_max_size: int) -> torch.Tensor:
    """Keep only the first `post_max_size` kept boxes (by score rank)."""
    rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    return keep & (rank < post_max_size)

