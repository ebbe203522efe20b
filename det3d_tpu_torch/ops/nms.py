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

`greedy_keep_rotated` is the same greedy keep over rotated BEV boxes
[cx, cy, dx, dy, angle] under `ops/rotated_iou.py`'s IoU (criterion -1),
the NMS of the center model (CenterPoint's `rotate_nms_pcdet`, IoU over a
threshold suppresses): only pairs whose circumscribed circles meet
(`circles_meet`) are clipped, since boxes whose circles do not meet do not
overlap; the CUDA kernel (`csrc/nms.cu`, the rotated `mask_tiles`) makes the
same test and the same IoU, operation for operation, its two sums in a
fixed order (`ordered_sum`).
"""

from __future__ import annotations

import torch

from det3d_tpu_torch.ops.rotated_iou import rotated_iou

CIRCLE_SLACK = 1e-5   # relative room on the circles' reach: a pair on the edge is clipped, not skipped
PAIR_CHUNK = 1 << 16  # pairs clipped at once by the plain rotated version


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
    return frontier_keep(overlap, valid)


def frontier_keep(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy keep mask from the suppression matrix `overlap[..., i, j]`
    (higher-scored i suppresses j; strict upper triangle, valid rows and
    columns only), by frontier rounds."""
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


def ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over `dim` as x[0] + x[1] + ... left to right, each addition
    rounded on its own, on every device: the rotated IoU's sums as the
    kernel makes them."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def circles_meet(rboxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 5) rotated boxes → (..., K, K) bool: the circles about their
    centres through their corners meet (with CIRCLE_SLACK of room). Boxes
    whose circles do not meet do not overlap."""
    reach = torch.sqrt(rboxes[..., 2] * rboxes[..., 2] + rboxes[..., 3] * rboxes[..., 3]) * 0.5
    dx = rboxes[..., :, None, 0] - rboxes[..., None, :, 0]
    dy = rboxes[..., :, None, 1] - rboxes[..., None, :, 1]
    r = (reach[..., :, None] + reach[..., None, :]) * (1.0 + CIRCLE_SLACK)
    return dx * dx + dy * dy <= r * r


def rotated_suppression(rboxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """(..., K, 5) rotated boxes in descending score order → (..., K, K)
    bool: i < j, both valid, their circles meet and their rotated IoU
    (row box first) exceeds the threshold."""
    k = rboxes.shape[-2]
    idx = torch.arange(k, device=rboxes.device)
    cand = circles_meet(rboxes) & valid[..., None, :] & valid[..., :, None] & (idx[:, None] < idx[None, :])
    out = torch.zeros_like(cand)
    where = cand.nonzero(as_tuple=True)
    lead, i, j = where[:-2], where[-2], where[-1]
    for s in range(0, i.shape[0], PAIR_CHUNK):
        sl = slice(s, s + PAIR_CHUNK)
        a = rboxes[(*(t[sl] for t in lead), i[sl])][:, None, :]
        b = rboxes[(*(t[sl] for t in lead), j[sl])][:, None, :]
        out[(*(t[sl] for t in lead), i[sl], j[sl])] = rotated_iou(a, b, total=ordered_sum)[:, 0, 0] > iou_threshold
    return out


def greedy_keep_rotated(rboxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Exact greedy keep mask of (..., K, 5) pre-sorted rotated boxes →
    (..., K) bool, without the rank cap."""
    return frontier_keep(rotated_suppression(rboxes, valid, iou_threshold), valid)
