"""PointPillars network in PyTorch, for inference and training.

Counterpart of the dense path of the JAX package's models/pointpillars.py
(reference: networks/pointpillars8_shared.py): PFN → BEV scatter → RPN →
SharedHead. Module names and nesting are the reference's, so
`state_dict()` keys are those of `weights.variables_to_state_dict` and a
JAX checkpoint loads with `strict=True`.

Parameters stay float32; convolutions and matmuls run in the config's
compute dtype (weights cast per call), normalisation statistics in float32,
as in the JAX package. `forward(..., train=True)` is the JAX model's
`train=True`: the PFN batch norm normalises with masked batch statistics
and updates its running statistics; otherwise it uses the running ones.

Layouts at the public boundary are the JAX package's: the canvas is
(B, nx, ny, C), and the predictions are spatial channel-major —
cls (B, 1, nch, fx, fy), box (B, 7, nch, fx, fy), dir (B, 2, nch, fx, fy).
The canvas permuted to (B, C, nx, ny) is an NCHW tensor in channels_last
memory, which the convolutions take without a copy.

Layout paths (Config.pack_w, block0_blocked, block0_blocked_train,
late_blocked_train; selected in `PointPillars.forward` by the JAX model's
rules, see `PointPillars.layout`). The dense network is the port's default
and main path. With `pack_w` the network runs the JAX package's w-parity
packed form: the space-to-depth canvas (B, nx/2, ny/2, 4C) from
`scatter_to_bev_s2d` feeds block0 as packed maps, whose channel p·C + c
holds column 2w + p (in channels_last memory a packed (B, 2C, H, W/2) map
is the same memory as the dense (B, C, H, W) one), through convolutions
whose kernels are the dense kernels' taps rearranged with structured zeros
(`pack_*_kernel`, `packed_conv`); the upsample branches emit packed maps
and the neck's concatenation unpacks them. `block0_blocked*` runs block0
batch-over-row-blocks on the blocked-halo canvas of
`scatter_to_bev_s2d_blocked` (VALID-row convolutions, `instance_norm_blocked`),
`late_blocked_train` runs blocks 1-2 so in training. The packing acts on
the weights at each call: the modules, parameters and `state_dict` keys are
the dense network's whatever the layout, so one checkpoint serves all of
them.

The packed inference network also takes the JAX package's two inference
options (`PointPillars.neck`): `fuse_in_stats`, each upsample branch's
InstanceNorm statistics from the Gram matrix of its coarse input
(`gram_moments`) and IN + ReLU applied in the branch's epilogue, the branch
emitted per column parity; and `split_head` (`RPN(split_out=True)`), one
320-channel neck map per column parity, which the shared head turns into a
pair of predictions with fy/2 columns each (column 2·y2 + p of the full
map) and the decode consumes as a pair. `head: "multi"` selects `MultiHead`,
one reduce + prediction head per class, in the same preds contract.

In inference the dense and the packed (unblocked) RPN run each
InstanceNorm + ReLU pair as one op, `kernels.norm_cuda.in_relu` (a
hand-written kernel on the card), wherever `_takes_fused` finds a bf16 or
float32 map on the card with no gradient wanted; training, the blocked,
spatial and Gram-statistic paths, float64 and the CPU keep the plain pair.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.kernels.norm_cuda import broadcast as _bc
from det3d_tpu_torch.kernels.norm_cuda import in_moments as _in_moments
from det3d_tpu_torch.kernels.norm_cuda import in_relu, instance_norm
from det3d_tpu_torch.kernels.norm_cuda import moments_from_sums as _moments_from_sums
from det3d_tpu_torch.kernels.norm_cuda import parity_sum as _parity_sum
from det3d_tpu_torch.kernels.scatter_cuda import scatter_to_bev, scatter_to_bev_s2d, scatter_to_bev_s2d_blocked
from det3d_tpu_torch.parallel.mesh import all_reduce_sum
from det3d_tpu_torch.parallel.spatial import gather_rows, halo_conv, spatial_instance_norm
from det3d_tpu_torch.utils import timing

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}") from None


class PFN(nn.Module):
    """Pillar Feature Net: decorate → 1x1 conv → BN → ReLU → max over the
    pillar's point slots (reference networks/pointpillars8_shared.py:11-60).
    `pfn_layers` holds the reference's Conv1d(9, 64, 1) and BatchNorm1d."""

    def __init__(self, voxel_size, offset, dtype: torch.dtype, in_channels: int = 9, out_channels: int = 64):
        super().__init__()
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.offset = tuple(float(v) for v in offset)
        self.dtype = dtype
        self.pfn_layers = nn.ModuleList(
            [nn.Conv1d(in_channels, out_channels, 1, bias=False), nn.BatchNorm1d(out_channels)]
        )

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor, coors: torch.Tensor,
                train: bool = False, mesh=None) -> torch.Tensor:
        # voxels (B, V, P, 4) f32, num_points (B, V) int32, coors (B, V, 3);
        # mesh: the sync-BN group of a data-parallel step (JAX's axis_name)
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x_offset = vx / 2 + self.offset[0]
        y_offset = vy / 2 + self.offset[1]
        p = voxels.shape[-2]

        counts = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None, None]
        points_mean = voxels[..., :3].sum(dim=-2, keepdim=True) / counts
        f_cluster = voxels[..., :3] - points_mean
        cx = coors[..., 0:1].to(voxels.dtype) * vx + x_offset
        cy = coors[..., 1:2].to(voxels.dtype) * vy + y_offset
        f_center = torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy], dim=-1)
        features = torch.cat([voxels, f_cluster, f_center], dim=-1)

        # zero decorated features on padding slots (reference :45-54)
        slot = torch.arange(p, device=voxels.device)
        mask = slot[None, None, :] < num_points[..., None]
        features = features * mask[..., None].to(features.dtype)

        conv, bn = self.pfn_layers
        x = F.linear(features.to(self.dtype), conv.weight[:, :, 0].to(self.dtype))
        if train:
            mean, var = masked_batch_stats(x, mask, bn, mesh)
        else:
            mean, var = bn.running_mean, bn.running_var
        # batch norm in float32
        y = (x.float() - mean) * torch.rsqrt(var + bn.eps)
        x = (y * bn.weight + bn.bias).to(self.dtype)
        x = torch.relu(x)
        # max over ALL point slots, padding included: a padding slot carries
        # relu(BN(0)), a floor of the max in every non-full pillar, exactly
        # as in the reference (:57-60)
        x = x.amax(dim=-2)
        # empty pillar slots are zeroed (their coords drop out of the scatter)
        return torch.where((num_points > 0)[..., None], x, 0.0).to(self.dtype)


def masked_batch_stats(x: torch.Tensor, mask: torch.Tensor, bn: nn.BatchNorm1d, mesh=None):
    """Training statistics of the PFN batch norm (the JAX package's
    MaskedBatchNorm, models/pointpillars.py:51-104): float32 mean and biased
    variance over the valid point slots only, per channel of x (..., C);
    `mask` (...) marks the valid slots. Updates `bn`'s running statistics
    with the unbiased variance sum_sq / max(count - 1, 1), as torch's
    BatchNorm1d stores it. `nn.BatchNorm1d`'s own train forward would
    average the padding slots too, so it holds the parameters only.

    `mesh` (a `parallel.mesh.DataMesh`, JAX's `axis_name`): sync-BN.
    [count, Σx] and then Σ m(x - mean)² are summed over the ranks
    (`all_reduce_sum`, differentiable), so every rank normalises with the
    global batch's statistics and stores the same running ones."""
    m = mask.to(torch.float32)[..., None]
    xf = x.to(torch.float32)
    red = tuple(range(x.dim() - 1))
    count = m.sum()
    sum_x = (xf * m).sum(dim=red)
    if mesh is not None:
        sums = all_reduce_sum(torch.cat([count[None], sum_x]), mesh)
        count, sum_x = sums[0], sums[1:]
    denom = torch.clamp(count, min=1.0)
    mean = sum_x / denom
    sum_sq = (m * (xf - mean) ** 2).sum(dim=red)
    if mesh is not None:
        sum_sq = all_reduce_sum(sum_sq, mesh)
    with torch.no_grad():
        # torch's convention: momentum is the share of the new batch statistic
        var_unbiased = sum_sq / torch.clamp(count - 1.0, min=1.0)
        bn.running_mean.copy_((1 - bn.momentum) * bn.running_mean + bn.momentum * mean)
        bn.running_var.copy_((1 - bn.momentum) * bn.running_var + bn.momentum * var_unbiased)
    return mean, sum_sq / denom


def _reduce_cc(a: torch.Tensor, packed: bool, n: int) -> torch.Tensor:
    """Per-(sample, channel) float32 mean of an NCHW map over n elements,
    with the packed parity merge (the JAX package's `_reduce_cc`)."""
    s = a.to(torch.promote_types(a.dtype, torch.float32)).sum(dim=(2, 3))
    if packed:
        s = _parity_sum(s).repeat(1, 2)
    return s / n


def _bc5(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, C) statistics broadcast over a blocked map's (B, nblk, C, R, W) view."""
    return t[:, None, :, None, None].to(like.dtype)


class InstanceNormFn(torch.autograd.Function):
    """`instance_norm` with the analytic backward of the JAX package's
    `_in_bwd` (models/pointpillars.py:321-332):
        dx = r·(g − mean(g) − x̂·mean(g·x̂)),  x̂ = (x − μ)·r,
    two float32 reductions and one elementwise pass over the cotangent, in
    place of autograd through the single-pass moments (another rounding of
    the same function, at a higher cost); the means merge the parities of a
    packed map."""

    @staticmethod
    def forward(ctx, x, packed=False):
        mean, inv, n = _in_moments(x, packed)
        ctx.save_for_backward(x, mean, inv)
        ctx.n, ctx.packed = n, packed
        return (x - _bc(mean, x)) * _bc(inv, x)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv = ctx.saved_tensors
        inv_c = _bc(inv, x)
        xhat = (x - _bc(mean, x)) * inv_c
        m_g = _reduce_cc(g, ctx.packed, ctx.n)
        m_gx = _reduce_cc(g * xhat, ctx.packed, ctx.n)
        dx = inv_c * (g - _bc(m_g, g) - xhat * _bc(m_gx, g))
        return dx.to(x.dtype), None


def _instance_norm(x: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """`instance_norm` under no_grad, `InstanceNormFn` when a gradient is wanted."""
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormFn.apply(x, packed)
    return instance_norm(x, packed)


class InstanceNorm(nn.Module):
    """Instance norm as a module, so Sequential indices match the
    reference's (it holds no parameters or buffers)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _instance_norm(x)


def _takes_fused(x: torch.Tensor) -> bool:
    """Whether `in_relu` takes the InstanceNorm + ReLU of map x: a bf16 or
    float32 map with no gradient wanted, on the card or traced by
    `torch.export`. A map on the card that the kernel does not take raises
    there, on the live and the exported path alike."""
    return (x.dtype in (torch.bfloat16, torch.float32) and not (torch.is_grad_enabled() and x.requires_grad)
            and (x.is_cuda or torch.compiler.is_exporting()))


def in_relu_route(x: torch.Tensor, packed: bool, fused) -> torch.Tensor:
    """relu(InstanceNorm(x)): `fused` (`in_relu`, or a stand-in a caller
    set) where `_takes_fused`, else the pair as training runs it
    (`_instance_norm`, then ReLU)."""
    if _takes_fused(x):
        return fused(x, packed)
    return torch.relu(_instance_norm(x, packed))


# --- blocked-halo instance norm ---------------------------------------------
#
# A blocked map is NCHW (B·nblk, C, R, W) in channels_last memory: nblk row
# blocks of each sample, each with `top` and `bot` margin rows that duplicate
# the neighbouring blocks' rows (zeros past the canvas edge) around
# `valid_rows` rows of its own. `_blocks` views it as (B, nblk, C, R, W).


def _blocks(x: torch.Tensor, nblk: int) -> torch.Tensor:
    return x.unflatten(0, (-1, nblk))


def _zero_margins(y5: torch.Tensor, top: int, bot: int) -> torch.Tensor:
    """Zero the first block's top and the last block's bottom margin rows
    (outside the canvas), in place."""
    if top:
        y5[:, 0, :, :top] = 0
    if bot:
        y5[:, -1, :, y5.shape[3] - bot:] = 0
    return y5


class InstanceNormBlockedFn(torch.autograd.Function):
    """InstanceNorm over a blocked-halo map (the JAX package's
    `_instance_norm_blocked`, models/pointpillars.py:688-771): statistics
    from the valid rows [top, top + valid_rows) of every block, each canvas
    row counted once; the whole map, margins included, normalised, so that
    duplicated rows stay equal to their originals; then the out-of-canvas
    margin rows re-zeroed, as the dense convolution's zero padding reads
    them. The analytic backward, with ĝ = g after the same re-zeroing:
        dx = r·(ĝ − 1_valid·(mean_n(ĝ) + x̂·mean_n(ĝ·x̂))),
    where the ĝ sums run over the whole blocked map (every output depends on
    μ and r) while the divisor n and the correction's rows are the valid
    rows only (μ and r depend on them alone)."""

    @staticmethod
    def forward(ctx, x, nblk, top, bot, valid_rows, packed):
        x5 = _blocks(x, nblk)
        xs = x5[:, :, :, top:top + valid_rows].float()
        mean, inv, n = _moments_from_sums(xs.sum(dim=(1, 3, 4)), (xs * xs).sum(dim=(1, 3, 4)),
                                          nblk * valid_rows * x.shape[3], packed)
        ctx.save_for_backward(x, mean, inv)
        ctx.args = (nblk, top, bot, valid_rows, packed, n)
        y5 = (x5 - _bc5(mean, x)) * _bc5(inv, x)
        return _zero_margins(y5, top, bot).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv = ctx.saved_tensors
        nblk, top, bot, valid_rows, packed, n = ctx.args
        x5 = _blocks(x, nblk)
        g5 = _zero_margins(_blocks(g, nblk).clone(), top, bot)
        inv_c = _bc5(inv, x)
        xhat = (x5 - _bc5(mean, x)) * inv_c
        s_g = g5.float().sum(dim=(1, 3, 4))
        s_gx = (g5 * xhat).float().sum(dim=(1, 3, 4))
        if packed:
            s_g, s_gx = _parity_sum(s_g).repeat(1, 2), _parity_sum(s_gx).repeat(1, 2)
        rowmask = torch.zeros((x5.shape[3], 1), dtype=g.dtype, device=g.device)
        rowmask[top:top + valid_rows] = 1
        dx = inv_c * (g5 - rowmask * (_bc5(s_g / n, g) + xhat * _bc5(s_gx / n, g)))
        return dx.flatten(0, 1).to(x.dtype), None, None, None, None, None


def instance_norm_blocked(x: torch.Tensor, nblk: int, top: int, bot: int, valid_rows: int,
                          packed: bool = True) -> torch.Tensor:
    """`InstanceNormBlockedFn` on a blocked map (B·nblk, C, R, W)."""
    return InstanceNormBlockedFn.apply(x, nblk, top, bot, valid_rows, packed)


# --- Gram-statistic InstanceNorm of an upsample branch ------------------------


@contextlib.contextmanager
def _ieee_f32_matmul():
    """float32 matmuls in full float32 (no TF32) inside the block, whatever
    the process has chosen: the variance below is a difference of two large
    sums, which TF32's 10-bit mantissa would lose."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gram_moments(x: torch.Tensor, kf: torch.Tensor, n_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """InstanceNorm statistics of an upsample branch's output computed from
    its coarse input alone (the JAX package's `_gram_moments`,
    models/pointpillars.py:338-362): the branch is a 1x1 map per phase,
    out_ph = x @ kf[:, ph, :], so per output channel o
        s1_o = Σ_ph (Σ_hw x) · kf[:, ph, o],
        s2_o = Σ_ph kf[:, ph, o]ᵀ (Σ_hw x xᵀ) kf[:, ph, o].
    x: NCHW (B, C, H, W) in channels_last memory, any dtype; kf: float32
    (C, P, O); n_out: the output's elements per channel. The sums and the
    (C, C) Gram matrix are float32 → (mean, rsqrt(var + 1e-3)), (B, O)."""
    with _ieee_f32_matmul():
        b, c = x.shape[:2]
        xm = x.float().permute(0, 2, 3, 1).reshape(b, -1, c)           # (B, H·W, C), a view
        sx = xm.sum(dim=1)                                             # (B, C)
        gram = torch.bmm(xm.transpose(1, 2), xm)                       # (B, C, C)
        s1 = torch.einsum("bc,cpo->bo", sx, kf)
        gk = torch.einsum("bcd,dpo->bcpo", gram, kf)
        s2 = torch.einsum("cpo,bcpo->bo", kf, gk)
    mean = s1 / n_out
    var = torch.clamp(s2 / n_out - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + 1e-3)


def _in_relu_epilogue(y: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor, phases: int) -> torch.Tensor:
    """relu(y·scale + shift) in y's dtype with scale = inv and shift =
    −mean·inv tiled over `phases` channel groups (the JAX epilogue, :403-407)."""
    scale, shift = inv.repeat(1, phases), (-mean * inv).repeat(1, phases)
    return torch.relu(y * _bc(scale, y) + _bc(shift, y))


def fused_deconv_split(x: torch.Tensor, weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A strided upsample branch with `fuse_in_stats` (the JAX package's
    `DeconvUpsample(fuse_in_relu=True, split_parity=True)`): the transposed
    convolution (kernel = stride = s), its InstanceNorm + ReLU from the
    Gram statistics of x, and the output's even and odd columns as a pair,
    each (B, O, H·s, W·s/2) — the packed layout's two parities, cut before
    any relayout. `weight` is the ConvTranspose2d kernel (C, O, s, s),
    whose taps (p, q) are the JAX kernel's phases in order."""
    c, o, s, _ = weight.shape
    mean, inv = gram_moments(x, weight.permute(0, 2, 3, 1).reshape(c, s * s, o), x.shape[2] * x.shape[3] * s * s)
    y = _in_relu_epilogue(F.conv_transpose2d(x, weight.to(x.dtype), None, s), mean, inv, 1)
    return y[..., 0::2], y[..., 1::2]


def fused_pointwise_split(x: torch.Tensor, weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The stride-1 branch with `fuse_in_stats` on a packed map (the JAX
    package's `PackedPointwise(fuse_in_relu=True, split_parity=True)`): the
    block-diagonal 1x1, IN + ReLU from Gram statistics in which the two
    parity blocks are the phases (so the statistics merge the parities, as
    the packed InstanceNorm does), and the two parities' channel halves as a
    pair. `weight`: the ConvTranspose2d kernel (C, O, 1, 1)."""
    w = weight[:, :, 0, 0]
    zero = torch.zeros_like(w)
    kf = torch.stack([torch.cat([w, zero]), torch.cat([zero, w])], dim=1)   # (2C, 2, O)
    mean, inv = gram_moments(x, kf, x.shape[2] * x.shape[3] * 2)
    y = _in_relu_epilogue(packed_pointwise(x, weight), mean, inv, 2)
    o = w.shape[1]
    return y[:, :o], y[:, o:]


class Conv2d(nn.Conv2d):
    """Conv2d whose float32 weight is cast to the input's dtype per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d (kernel == stride, no bias) with the weight cast to
    the input's dtype per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None, self.stride)


# --- w-parity packing --------------------------------------------------------
#
# The JAX package's packed block0 (models/pointpillars.py:459-611): a map
# (H, W, C) is held as (H, W/2, 2C) with channel p·C + c holding column
# 2w + p, and every block0 convolution becomes a convolution on packed maps
# whose kernel is the dense (3, 3, C, O) kernel's taps rearranged with
# structured zeros. A tap of the dense kernel at column offset dj lands at
# packed kernel column s, input parity pi, output parity po iff
# dj = 2(s - 1) + pi - po (stride 1) lies in [-1, 1]. The `_*_taps`
# functions build the JAX package's packed HWIO kernels from any HWIO array
# (here an array of flat indices); the port applies the result as an index
# map to its OIHW weights, so a packed kernel is one gather of the
# parameter, differentiable, and exactly the JAX kernel's values.


def _pack_entry_taps(w: np.ndarray, zero: np.ndarray) -> np.ndarray:
    """(3,3,C,O) stride-2 entry kernel → (2,3,4C,2O) on the s2d canvas: row
    taps di = 2(r-1)+a, column taps dj = 2(s-1)+b-2p (`_pack_entry_kernel`)."""
    def tap(di, dj):
        return w[di + 1, dj + 1] if -1 <= di <= 1 and -1 <= dj <= 1 else zero

    return np.stack([np.stack([
        np.concatenate([np.concatenate([tap(2 * (r - 1) + a, 2 * (s - 1) + b - 2 * p) for p in (0, 1)], axis=1)
                        for a in (0, 1) for b in (0, 1)], axis=0)
        for s in (0, 1, 2)]) for r in (0, 1)])


def _pack_res_taps(w: np.ndarray, zero: np.ndarray) -> np.ndarray:
    """(3,3,C,O) stride-1 kernel → (3,3,2C,2O) packed → packed: column taps
    dj = 2(s-1)+pi-po (`_pack_res_kernel`)."""
    def tap(r, dj):
        return w[r, dj + 1] if -1 <= dj <= 1 else zero

    return np.stack([np.stack([
        np.concatenate([np.concatenate([tap(r, 2 * (s - 1) + pi - po) for po in (0, 1)], axis=1)
                        for pi in (0, 1)], axis=0)
        for s in (0, 1, 2)]) for r in (0, 1, 2)])


def _pack_down_taps(w: np.ndarray, zero: np.ndarray) -> np.ndarray:
    """(3,3,C,O) stride-2 kernel → (3,2,2C,O), packed input → dense output:
    column taps dj = 2(s-1)+pi (`_pack_down_kernel`)."""
    def tap(r, dj):
        return w[r, dj + 1] if -1 <= dj <= 1 else zero

    return np.stack([np.stack([
        np.concatenate([tap(r, 2 * (s - 1) + pi) for pi in (0, 1)], axis=0)
        for s in (0, 1)]) for r in (0, 1, 2)])


def _pack_pointwise_taps(w: np.ndarray, zero: np.ndarray) -> np.ndarray:
    """(1,1,C,O) kernel → block-diagonal (1,1,2C,2O): parities never mix in
    a 1x1 (`PackedPointwise`)."""
    return np.concatenate([np.concatenate([w[0, 0], zero], axis=1),
                           np.concatenate([zero, w[0, 0]], axis=1)], axis=0)[None, None]


_PACKERS = {"entry": _pack_entry_taps, "res": _pack_res_taps, "down": _pack_down_taps,
            "pointwise": _pack_pointwise_taps}


@functools.cache
def _pack_index(kind: str, cout: int, cin: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Index map of a packed OIHW kernel into the flat dense OIHW kernel
    (cout, cin, k, k) followed by one zero (index cout·cin·k·k); and its
    inverse, the packed positions of each dense tap (n, K), padded with the
    position one past the packed kernel's end."""
    n = cout * cin * k * k
    flat = np.arange(n).reshape(cout, cin, k, k).transpose(2, 3, 1, 0)  # HWIO
    packed = np.ascontiguousarray(_PACKERS[kind](flat, np.full((cin, cout), n)).transpose(3, 2, 0, 1))
    src = packed.ravel()
    pos = np.flatnonzero(src < n)
    pos = pos[np.argsort(src[pos], kind="stable")]
    counts = np.bincount(src[pos], minlength=n)
    inv = np.full((n, counts.max()), src.size)
    inv[np.repeat(np.arange(n), counts), np.concatenate([np.arange(c) for c in counts])] = pos
    return packed, inv


class _PackKernel(torch.autograd.Function):
    """The packed kernel as a gather of the dense one; the backward sums
    each dense tap's packed copies (at most a few) by a gather of the
    gradient, so the structured zeros' cotangents are never accumulated
    (an index backward would serialise them on the one zero slot)."""

    @staticmethod
    def forward(ctx, w, idx, inv):
        ctx.save_for_backward(inv)
        ctx.shape = w.shape
        return F.pad(w.reshape(-1), (0, 1))[idx]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return F.pad(g.reshape(-1), (0, 1))[inv].sum(-1).reshape(ctx.shape), None, None


_PACK_INDEX_ON_DEVICE: dict = {}


def pack_kernel(w: torch.Tensor, kind: str) -> torch.Tensor:
    """A dense OIHW kernel → its packed OIHW kernel of `kind` ('entry',
    'res', 'down', 'pointwise'): one gather, differentiable. The index maps
    are made once per device; while `torch.export` traces, they are made
    for the program (its constants) and not kept, since what the trace
    makes holds no data."""
    cout, cin, k, _ = w.shape
    key = (kind, cout, cin, k, w.device)
    maps = _PACK_INDEX_ON_DEVICE.get(key)
    if maps is None:
        maps = tuple(torch.from_numpy(a).to(w.device) for a in _pack_index(kind, cout, cin, k))
        if not torch.compiler.is_exporting():
            _PACK_INDEX_ON_DEVICE[key] = maps
    return _PackKernel.apply(w, *maps)


def pack_entry_kernel(w: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) → (2O, 4C, 2, 3): the entry conv on the s2d canvas."""
    return pack_kernel(w, "entry")


def pack_res_kernel(w: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) → (2O, 2C, 3, 3): a stride-1 conv, packed → packed."""
    return pack_kernel(w, "res")


def pack_down_kernel(w: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) → (O, 2C, 3, 2): a stride-2 conv, packed → dense."""
    return pack_kernel(w, "down")


# kind: (packing, stride, the JAX package's ((top, bottom), (left, right))
# padding); the `_valid` kinds take no row padding (halo rows supply it)
_PACKED_CONVS = {
    "entry": ("entry", (1, 2), ((1, 0), (1, 0))),
    "res": ("res", (1, 1), ((1, 1), (1, 1))),
    "down": ("down", (2, 1), ((1, 0), (1, 0))),
    "entry_valid": ("entry", (1, 2), ((0, 0), (1, 0))),
    "res_valid": ("res", (1, 1), ((0, 0), (1, 1))),
    "down_valid": ("down", (2, 1), ((0, 0), (1, 0))),
}


def conv2d_padded(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """F.conv2d with the JAX package's per-side padding ((top, bottom),
    (left, right)). `F.conv2d` pads both sides alike, so an axis whose
    sides differ is padded by `F.pad` (which keeps channels_last) and
    convolved with no padding; an axis whose larger leading pad gives the
    same number of outputs (its extra trailing row is never read) takes the
    symmetric padding and no copy."""
    sym, extra = [], [0, 0, 0, 0]  # F.pad order: left, right, top, bottom
    for axis, ((lo, hi), k, st) in enumerate(zip(padding, w.shape[2:], stride)):
        n = x.shape[2 + axis]
        if lo == hi or (hi < lo and (n + 2 * lo - k) // st == (n + lo + hi - k) // st):
            sym.append(lo)
        else:
            sym.append(0)
            extra[2 - 2 * axis: 4 - 2 * axis] = [lo, hi]
    if any(extra):
        x = F.pad(x, extra)
    return F.conv2d(x, w, None, stride, tuple(sym))


def packed_conv(x: torch.Tensor, weight: torch.Tensor, kind: str) -> torch.Tensor:
    """A block0 convolution on packed maps (the JAX package's `PackedConv`):
    the dense OIHW `weight`, packed for `kind`, in the input's dtype.
    'entry': s2d canvas → packed; 'res': packed → packed; 'down': packed →
    dense; the `_valid` kinds take no row padding."""
    packing, stride, padding = _PACKED_CONVS[kind]
    return conv2d_padded(x, pack_kernel(weight, packing).to(x.dtype), stride, padding)


def packed_pointwise(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The stride-1 upsample branch's 1x1 on a packed map (the JAX package's
    `PackedPointwise`): `weight` is the ConvTranspose2d kernel (C, O, 1, 1),
    applied block-diagonally to both parities."""
    return F.conv2d(x, pack_kernel(weight.transpose(0, 1), "pointwise").to(x.dtype))


def pack_columns(y: torch.Tensor) -> torch.Tensor:
    """Dense (B, O, H, W) in channels_last memory → packed (B, 2O, H, W/2).
    NHWC memory (B, H, W, O) read as (B, H, W/2, 2O) is the packing itself,
    so this is a view; `view` raises rather than copy a map that is not
    channels_last."""
    b, o, h, w = y.shape
    return y.permute(0, 2, 3, 1).view(b, h, w // 2, 2 * o).permute(0, 3, 1, 2)


def unpack_columns(x: torch.Tensor) -> torch.Tensor:
    """Packed (B, 2O, H, W/2) in channels_last memory → dense (B, O, H, W), a view."""
    b, o2, h, w2 = x.shape
    return x.permute(0, 2, 3, 1).view(b, h, 2 * w2, o2 // 2).permute(0, 3, 1, 2)


# --- row blocking -------------------------------------------------------------


def block0_blocking(grid_xy) -> tuple[int, tuple[int, int]]:
    """(nblk, halo) of the blocked-halo block0 at this grid (the JAX
    package's `block0_blocking`): halo (4, 3) rows (the 2-row entry conv
    takes 1 top row, each of the 3 residual convs 1 row a side); nblk the
    largest of 8/4/2 dividing the s2d rows with at least 8 rows a block, or
    1 where none does (the blocked path is then off)."""
    nx2 = grid_xy[0] // 2
    nblk = next((n for n in (8, 4, 2) if nx2 % n == 0 and nx2 // n > 7), 1)
    return nblk, (4, 3)


def late_blocking(rows_out: int) -> int:
    """nblk for a late-blocked block from its output rows (the JAX
    package's `late_blocking`): the largest of 8/4/2 dividing them with at
    least 32 rows a block, or 1 (dense)."""
    return next((n for n in (8, 4, 2) if rows_out % n == 0 and rows_out // n >= 32), 1)


def unblock_rows(x: torch.Tensor, bsz: int) -> torch.Tensor:
    """Blocked (B·nblk, C, R, W) with no margins left → (B, C, nblk·R, W):
    in channels_last memory the blocks of a sample are consecutive rows, so
    this is a reshape (a view where the map is channels_last)."""
    n, c, r, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(bsz, n // bsz * r, w, c).permute(0, 3, 1, 2)


def reblock_rows(x: torch.Tensor, nblk: int, rb2: int, m: int) -> torch.Tensor:
    """(B, C, H, W) → halo'd input blocks (B·nblk, C, Rin, W) for a stride-2
    entry conv with one top pad row (the JAX package's `_reblock_rows`):
    block i's output rows are [i·rb2 − m, (i+1)·rb2 + m), so its input rows
    are [2(i·rb2 − m) − 1, 2((i+1)·rb2 + m − 1) + 2); rows outside the map
    are zero, the dense conv's zero padding. One zero fill and one copy per
    block; autograd sums the halo copies' cotangents into their source rows."""
    bsz, c, h, w = x.shape
    rin = 2 * (rb2 + 2 * m) + 1
    xn = x.permute(0, 2, 3, 1)
    out = xn.new_zeros((bsz, nblk, rin, w, c))
    for i in range(nblk):
        lo = 2 * (i * rb2 - m) - 1
        lo_c, hi_c = max(lo, 0), min(lo + rin, h)
        out[:, i, lo_c - lo:hi_c - lo] = xn[:, lo_c:hi_c]
    return out.view(bsz * nblk, rin, w, c).permute(0, 3, 1, 2)


class Resnet2(nn.Module):
    """Full-pre-activation residual unit, (IN → ReLU → 3x3 conv) x n plus
    identity; `conv_block` indices 2 and 5 hold the convs, as in the
    reference's `Resnet2` (:418-431)."""

    def __init__(self, dim: int, num_convs: int):
        super().__init__()
        layers: list[nn.Module] = []
        for _ in range(num_convs):
            layers += [InstanceNorm(), nn.ReLU(), Conv2d(dim, dim, 3, padding=1, bias=False)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, fused) -> torch.Tensor:
        """`fused`: the IN + ReLU op of `in_relu_route`."""
        h = x
        for conv in self._convs():
            h = conv(in_relu_route(h, False, fused))
        return x + h

    def _convs(self):
        return [self.conv_block[3 * i + 2] for i in range(len(self.conv_block) // 3)]

    def forward_packed(self, x: torch.Tensor, fused) -> torch.Tensor:
        """The unit on a packed map (the JAX package's `PreActResidual`,
        packed=True)."""
        h = x
        for conv in self._convs():
            h = packed_conv(in_relu_route(h, True, fused), conv.weight, "res")
        return x + h

    def forward_blocked(self, x: torch.Tensor, nblk: int, valid_rows: int, top_in: int,
                        packed: bool) -> torch.Tensor:
        """The unit on a blocked map (B·nblk, C, R, W) with `top_in` margin
        rows a side (the JAX package's `_BlockedPreActResidual`): each conv
        is VALID in rows and takes one margin row a side; the identity is
        cropped to match."""
        h = x
        convs = self._convs()
        for i, conv in enumerate(convs):
            h = torch.relu(instance_norm_blocked(h, nblk, top_in - i, top_in - i, valid_rows, packed))
            if packed:
                h = packed_conv(h, conv.weight, "res_valid")
            else:
                h = F.conv2d(h, conv.weight.to(h.dtype), None, 1, (0, 1))
        k = len(convs)
        return x[:, :, k:x.shape[2] - k] + h

    def forward_spatial(self, x: torch.Tensor, spatial, level: int) -> torch.Tensor:
        """The unit on this rank's slab of a level-`level` map
        (`parallel.spatial`): InstanceNorms over the whole map, convolutions
        with halo rows."""
        n = spatial.global_rows(level) * x.shape[3]
        h = x
        for conv in self._convs():
            h = halo_conv(torch.relu(spatial_instance_norm(h, spatial.mesh, n)), conv, spatial.mesh)
        return x + h


class RPN(nn.Module):
    """Three strided blocks (depths 2/4/4, widths 64/128/256) and three
    upsample branches (64/128/128 at strides 1/2/4) concatenated to 320
    channels at half the canvas resolution (reference :114-181).

    Block b is [3x3 stride-2 conv, IN, ReLU, Resnet2(2) x depth/2,
    Resnet2(1)]. torch's padding=1 on an even input equals the JAX
    package's (1, 0) padding: the last row and column of padding are never
    read.

    `forward(x, pack_w, block0_blocked, late_blocked, fuse_in_stats,
    split_out)` runs the JAX package's RPN with those flags on the same
    modules and parameters: `pack_w` takes the s2d canvas (B, 4C, nx/2,
    ny/2), block0 and the upsample branches packed; `block0_blocked` takes
    the blocked canvas (B, nblk, R, ny/2, 4C) instead; `late_blocked` runs
    blocks 2-3 (the JAX package's blocks 1-2) batch-over-row-blocks where
    `late_blocking` finds blocks; with packing, `fuse_in_stats` runs the
    branches' IN + ReLU from Gram statistics (`fused_deconv_split`,
    `fused_pointwise_split`) and `split_out` returns one (B, 320, H, W/2)
    map per column parity instead of the merged (B, 320, H, W) map.

    `spatial` (a `parallel.spatial.SpatialPlan`): x is this rank's slab of
    the dense canvas, and the dense network runs on the slabs, its 3x3
    convolutions with halo rows and its InstanceNorms over the whole map
    (`_forward_spatial`); the result is the rank's slab of the features."""

    def __init__(
        self,
        in_channels: int = 64,
        layer_nums=(2, 4, 4),
        num_filters=(64, 128, 256),
        upsample_strides=(1, 2, 4),
        num_upsample_filters=(64, 128, 128),
    ):
        super().__init__()
        cin = in_channels
        for b, (depth, width, stride, up_width) in enumerate(
            zip(layer_nums, num_filters, upsample_strides, num_upsample_filters), start=1
        ):
            layers: list[nn.Module] = [
                Conv2d(cin, width, 3, stride=2, padding=1, bias=False), InstanceNorm(), nn.ReLU()
            ]
            layers += [Resnet2(width, n) for n in [2] * (depth // 2) + [1]]
            self.add_module(f"block{b}", nn.Sequential(*layers))
            self.add_module(
                f"deconv{b}",
                nn.Sequential(
                    ConvTranspose2d(width, up_width, stride, stride=stride, bias=False),
                    InstanceNorm(),
                    nn.ReLU(),
                ),
            )
            cin = width
        self.num_blocks = len(layer_nums)
        # the InstanceNorm + ReLU of the inference forward (`in_relu_route`);
        # a caller may set the plain version in its place to compare the two
        self.in_relu = in_relu
        self.layer_nums = tuple(layer_nums)
        self.upsample_strides = tuple(upsample_strides)
        self.num_upsample_filters = tuple(num_upsample_filters)
        self.out_channels = sum(num_upsample_filters)

    def forward(self, x: torch.Tensor, pack_w: bool = False, block0_blocked: bool = False,
                late_blocked: bool = False, fuse_in_stats: bool = False, split_out: bool = False,
                spatial=None):
        if spatial is not None:
            return self._forward_spatial(x, spatial)
        if not pack_w:
            ups = []
            for b in range(1, self.num_blocks + 1):
                block = getattr(self, f"block{b}")
                x = in_relu_route(block[0](x), False, self.in_relu)
                for unit in block[3:]:
                    x = unit(x, self.in_relu)
                ups.append(in_relu_route(getattr(self, f"deconv{b}")[0](x), False, self.in_relu))
            return torch.cat(ups, dim=1)
        return self._forward_packed(x, block0_blocked, late_blocked, fuse_in_stats, split_out)

    def _forward_spatial(self, x: torch.Tensor, spatial) -> torch.Tensor:
        """The dense RPN on this rank's slab of the canvas: block b's entry
        conv (stride 2) and its units on level b, every upsample branch on
        the rank's slab of level 1, whose bounds are every level's times
        its stride (`slab_bounds`), so the branches concatenate row for row."""
        mesh = spatial.mesh
        ups = []
        for b in range(1, self.num_blocks + 1):
            block = getattr(self, f"block{b}")
            x = halo_conv(x, block[0], mesh)
            n = spatial.global_rows(b) * x.shape[3]
            x = torch.relu(spatial_instance_norm(x, mesh, n))
            for unit in block[3:]:
                x = unit.forward_spatial(x, spatial, b)
            u = getattr(self, f"deconv{b}")[0](x)
            ups.append(torch.relu(spatial_instance_norm(u, mesh, spatial.global_rows(1) * u.shape[3])))
        return torch.cat(ups, dim=1)

    def _forward_packed(self, x: torch.Tensor, block0_blocked: bool, late_blocked: bool,
                        fuse_in_stats: bool, split_out: bool):
        """The JAX package's `RPN.__call__` with pack_w (models/pointpillars.py:947-1043)."""
        ups = []
        for b in range(1, self.num_blocks + 1):
            block = getattr(self, f"block{b}")
            depth = self.layer_nums[b - 1]
            if b == 1 and block0_blocked:
                x = self._blocked_block0(x)
            elif b > 1 and late_blocked and depth == 4 and late_blocking(x.shape[2] // 2) > 1:
                x = self._blocked_late(x, b, late_blocking(x.shape[2] // 2))
            else:
                if b == 1:
                    x = packed_conv(x, block[0].weight, "entry")
                elif b == 2:
                    x = packed_conv(x, block[0].weight, "down")
                else:
                    x = block[0](x)
                x = in_relu_route(x, b == 1, self.in_relu)
                for unit in block[3:]:
                    x = unit.forward_packed(x, self.in_relu) if b == 1 else unit(x, self.in_relu)
            up = getattr(self, f"deconv{b}")[0]
            strided = self.upsample_strides[b - 1] > 1
            if fuse_in_stats:
                # IN + ReLU from Gram statistics, the branch cut per parity
                ups.append((fused_deconv_split if strided else fused_pointwise_split)(x, up.weight))
                continue
            u = pack_columns(up(x)) if strided else packed_pointwise(x, up.weight)
            u = in_relu_route(u, True, self.in_relu)
            bw = self.num_upsample_filters[b - 1]
            ups.append((u[:, :bw], u[:, bw:]))
        per_parity = [[u[p] for u in ups] for p in (0, 1)]
        if split_out:
            # one 320-channel map per column parity; the head takes the pair
            return tuple(torch.cat(parts, dim=1) for parts in per_parity)
        # parity-outer concat: out[:, :, h, 2·w2 + p] must be the 320
        # channels of dense column 2·w2 + p, so the branches' parity-p halves
        # are concatenated p-major and unpacked (the concat moves the data;
        # the unpack is a view of channels_last memory)
        cat = torch.cat(per_parity[0] + per_parity[1], dim=1)
        return unpack_columns(cat.contiguous(memory_format=torch.channels_last))

    def _blocked_block0(self, x5: torch.Tensor) -> torch.Tensor:
        """All of block0 on the blocked-halo canvas (B, nblk, R, ny/2, 4C),
        R = rows per block + 4 + 3 (the JAX package's `_blocked_block0`):
        VALID-row convs take one margin row a side per conv (the entry the
        top one only), the blocked IN counts each valid row once, the
        residual identities crop to match; the margins retire at the last
        conv and the unblock is a reshape."""
        block = self.block1
        if self.layer_nums[0] != 2:
            raise ValueError("the blocked block0 needs depth 2")
        bsz, nblk, r0, w2, c4 = x5.shape
        x = x5.view(bsz * nblk, r0, w2, c4).permute(0, 3, 1, 2)
        x = packed_conv(x, block[0].weight, "entry_valid")  # margins (3, 3)
        rb = r0 - 7
        x = torch.relu(instance_norm_blocked(x, nblk, 3, 3, rb, True))
        x = block[3].forward_blocked(x, nblk, rb, 3, True)  # margins (1, 1)
        x = block[4].forward_blocked(x, nblk, rb, 1, True)  # margins (0, 0)
        return unblock_rows(x, bsz)

    def _blocked_late(self, x: torch.Tensor, b: int, nblk: int) -> torch.Tensor:
        """Block b (2 or 3) batch-over-row-blocks (the JAX package's
        `_blocked_late`): re-block the input with fresh 5-row output halos,
        then the stride-2 entry ('down_valid' on block2's packed input) and
        the residual units (convs [2, 2, 1]) VALID in rows at batch B·nblk,
        the margins retiring one row per conv; the unblock is a reshape."""
        block = getattr(self, f"block{b}")
        rows_out = x.shape[2] // 2
        rb = rows_out // nblk
        m = 5
        bsz = x.shape[0]
        xb = reblock_rows(x, nblk, rb, m)
        if b == 2:
            x = packed_conv(xb, block[0].weight, "down_valid")
        else:
            x = conv2d_padded(xb, block[0].weight.to(xb.dtype), (2, 2), ((0, 0), (1, 0)))
        x = torch.relu(instance_norm_blocked(x, nblk, m, m, rb, False))
        for unit, top in zip(block[3:], (m, m - 2, 1)):
            x = unit.forward_blocked(x, nblk, rb, top, False)
        return unblock_rows(x, bsz)


def head_preds(x: torch.Tensor, convs, a: int, code: int) -> dict[str, torch.Tensor]:
    """The cls, box and dir 1x1 convolutions `convs` (a, a·code and a·2
    output channels in the reference's [anchor][k] order) as one conv over
    their concatenated weights → the spatial channel-major preds contract:
    cls (N, 1, a, H, W), box (N, code, a, H, W), dir (N, 2, a, H, W)."""
    w = torch.cat([c.weight for c in convs]).to(x.dtype)
    bias = torch.cat([c.bias for c in convs]).to(x.dtype)
    y = F.conv2d(x, w, bias)                                      # (N, a·(1+code+2), H, W)
    n, _, h, wd = y.shape

    def split(part: torch.Tensor, k: int) -> torch.Tensor:
        # (N, a·k, H, W) [anchor][k] → (N, k, a, H, W)
        return part.reshape(n, a, k, h, wd).transpose(1, 2)

    cls, box, dire = torch.split(y, [a, a * code, a * 2], dim=1)
    return {"cls_preds": split(cls, 1), "box_preds": split(box, code), "dir_preds": split(dire, 2)}


class SharedHead(nn.Module):
    """1x1 convs conv_cls / conv_box / conv_dir over the RPN features
    (reference :299-343), run as one conv over their concatenated weights.
    Output channels are in the reference's [anchor][k] order; the result is
    returned in the spatial channel-major preds contract. Given the split
    neck's pair of column-parity maps, each pred is a pair of the same with
    fy/2 columns (the JAX `SharedHead`'s parity path, :1131-1143)."""

    def __init__(self, in_channels: int, num_anchor_per_loc: int, box_code_size: int):
        super().__init__()
        a = num_anchor_per_loc
        self.num_anchor_per_loc = a
        self.box_code_size = box_code_size
        self.conv_cls = nn.Conv2d(in_channels, a, 1)
        self.conv_box = nn.Conv2d(in_channels, a * box_code_size, 1)
        self.conv_dir = nn.Conv2d(in_channels, a * 2, 1)

    def forward(self, x) -> dict:
        convs = (self.conv_cls, self.conv_box, self.conv_dir)
        if isinstance(x, tuple):
            pair = [head_preds(xp, convs, self.num_anchor_per_loc, self.box_code_size) for xp in x]
            return {k: (pair[0][k], pair[1][k]) for k in pair[0]}
        return head_preds(x, convs, self.num_anchor_per_loc, self.box_code_size)


class MultiHead(nn.Module):
    """One head per class over the shared RPN features (the JAX package's
    `MultiHead`, models/pointpillars.py:1166-1215; reference head variants,
    networks/pointpillars8_shared.py:184-296): for class c with a anchors
    per location, `head{c}_reduce` (1x1, 320 → 64, bias) + ReLU, then the
    class's cls, box and dir 1x1 convolutions (`head{c}_cls`, `_box`,
    `_dir`, [anchor][k] columns). The classes' preds concatenate along the
    anchor-channel axis, the [class][size][rot] order of the anchors, into
    the shared head's contract, so losses and decode take either head."""

    REDUCE = 64

    def __init__(self, in_channels: int, anchors_per_class, box_code_size: int):
        super().__init__()
        self.anchors_per_class = tuple(anchors_per_class)
        self.box_code_size = box_code_size
        for c, a in enumerate(self.anchors_per_class):
            self.add_module(f"head{c}_reduce", nn.Conv2d(in_channels, self.REDUCE, 1))
            self.add_module(f"head{c}_cls", nn.Conv2d(self.REDUCE, a, 1))
            self.add_module(f"head{c}_box", nn.Conv2d(self.REDUCE, a * box_code_size, 1))
            self.add_module(f"head{c}_dir", nn.Conv2d(self.REDUCE, a * 2, 1))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        per_class = []
        for c, a in enumerate(self.anchors_per_class):
            reduce = getattr(self, f"head{c}_reduce")
            feat = torch.relu(F.conv2d(x, reduce.weight.to(x.dtype), reduce.bias.to(x.dtype)))
            convs = [getattr(self, f"head{c}_{k}") for k in ("cls", "box", "dir")]
            per_class.append(head_preds(feat, convs, a, self.box_code_size))
        return {k: torch.cat([p[k] for p in per_class], dim=2) for k in per_class[0]}


# the layout levers the spatial path refuses (`PointPillars.check_spatial`)
SPATIAL_REFUSED = ("pack_w", "block0_blocked", "block0_blocked_train", "late_blocked_train")


class Layout(NamedTuple):
    """The layout path of one forward (`PointPillars.layout`)."""

    pack_w: bool
    block0_blocked: bool
    late_blocked: bool


class Neck(NamedTuple):
    """The packed inference options of one forward (`PointPillars.neck`)."""

    fuse_in_stats: bool
    split_out: bool


class PointPillars(nn.Module):
    """PFN → scatter → RPN → SharedHead, or MultiHead with `head: "multi"`
    (reference :346-382).

    The scatters make the RPN's input: `scatter` the dense canvas,
    `scatter_s2d` the s2d canvas and `scatter_s2d_blocked` the blocked one,
    the `kernels.scatter_cuda` functions by default (the CUDA kernels on
    the card); a caller may set the plain versions in their place to
    compare the two end to end."""

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.head not in ("shared", "multi"):
            raise ValueError(f"head {cfg.head!r}: 'shared' or 'multi'")
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.grid_xy = (cfg.grid_size[0], cfg.grid_size[1])
        self.pillar_point_net = PFN(cfg.voxel_size, cfg.detection_offset, self.dtype)
        self.rpn = RPN()
        if cfg.head == "multi":
            self.heads = MultiHead(self.rpn.out_channels, [s.num_anchors_per_loc for s in cfg.class_specs],
                                   cfg.box_code_size)
        else:
            self.heads = SharedHead(self.rpn.out_channels, cfg.num_anchors_per_loc, cfg.box_code_size)
        self.scatter = scatter_to_bev
        self.scatter_s2d = scatter_to_bev_s2d
        self.scatter_s2d_blocked = scatter_to_bev_s2d_blocked

    def layout(self, batch: int, train: bool) -> Layout:
        """The JAX model's selection (models/pointpillars.py:1246-1338):
        packing needs an even nx and ny % 4 == 0; block0 blocking needs
        packing and more than one block at this grid; the train-time flags
        act only at batch <= 2. Late blocking also needs packing here (the
        JAX model runs it on the dense network too; see config.py)."""
        nx, ny = self.grid_xy
        cfg = self.cfg
        pack = cfg.pack_w and nx % 2 == 0 and ny % 4 == 0
        blocked = (cfg.block0_blocked_train and batch <= 2) if train else cfg.block0_blocked
        late = train and batch <= 2 and cfg.late_blocked_train
        return Layout(pack, pack and blocked and block0_blocking(self.grid_xy)[0] > 1, pack and late)

    def neck(self, train: bool) -> Neck:
        """The JAX model's inference options (models/pointpillars.py:1310-1328):
        both act only on the packed network and never in training;
        `split_out` also needs the shared head."""
        infer_packed = self.layout(1, train).pack_w and not train
        return Neck(infer_packed and self.cfg.fuse_in_stats,
                    infer_packed and self.cfg.head == "shared" and self.cfg.split_head)

    def canvas(self, pillar_features: torch.Tensor, coors: torch.Tensor, layout: Layout) -> torch.Tensor:
        """The RPN's input for `layout`: the dense or s2d canvas as an NCHW
        view of channels_last memory, or the blocked canvas as it is."""
        feats, coors = pillar_features.contiguous(), coors.contiguous()
        if layout.block0_blocked:
            return self.scatter_s2d_blocked(feats, coors, self.grid_xy, *block0_blocking(self.grid_xy))
        scatter = self.scatter_s2d if layout.pack_w else self.scatter
        return scatter(feats, coors, self.grid_xy).permute(0, 3, 1, 2)

    def check_spatial(self) -> None:
        """The spatial path runs the dense network only: `pack_w`, and with
        it every blocked lever that would act, raise with a spatial group
        (the JAX model drops the blocked ones under a canvas sharding and
        keeps packing, which is layout only; the port's default is dense).
        Without `pack_w` the blocked levers are inert (`layout`), as in the
        shipped configs, and pass."""
        on = [k for k in SPATIAL_REFUSED if getattr(self.cfg, k)] if self.cfg.pack_w else []
        if on:
            raise ValueError(f"{', '.join(on)} with a spatial group: the spatial path runs the dense network "
                             f"only (set {' and '.join(f'{k}=False' for k in on)})")

    def slab_canvas(self, pillar_features: torch.Tensor, coors: torch.Tensor, spatial) -> torch.Tensor:
        """This rank's slab of the dense canvas, rows [lo, hi) of nx, as an
        NCHW view of channels_last memory: the dense scatter of the pillars
        with x shifted by lo into a grid of hi - lo rows, which drops every
        pillar outside the slab (and its backward gathers zero for them)."""
        lo, hi = spatial.rows(0)
        shifted = torch.cat([coors[..., :1] - lo, coors[..., 1:]], dim=-1).contiguous()
        return self.scatter(pillar_features.contiguous(), shifted, (hi - lo, self.grid_xy[1])).permute(0, 3, 1, 2)

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor, coors: torch.Tensor,
                train: bool = False, mesh=None, spatial=None) -> dict:
        # voxels (B, V, P, 4), num_points (B, V) int32, coors (B, V, 3) int32;
        # train: masked batch statistics in the PFN (and their running update);
        # mesh: those statistics synced over a data-parallel group (JAX's axis_name);
        # spatial: a parallel.spatial.SpatialPlan — the RPN and the head on
        # this rank's slab, the preds gathered whole on every rank of the group
        pillar_features = self.pillar_point_net(voxels, num_points, coors, train, mesh)
        if spatial is not None:
            self.check_spatial()
            x = self.rpn(self.slab_canvas(pillar_features, coors, spatial), spatial=spatial)
            timing.mark("neck")
            return gather_rows(self.heads(x), spatial.mesh, spatial.bounds[1])
        layout = self.layout(voxels.shape[0], train)
        x = self.rpn(self.canvas(pillar_features, coors, layout), *layout, *self.neck(train))
        timing.mark("neck")
        return self.heads(x)


@torch.no_grad()
def init_weights(model: PointPillars, seed: int) -> PointPillars:
    """Random weights from a seeded `torch.Generator`, made on the CPU so a
    seed gives the same weights on every device: LeCun-normal kernels
    (std 1/sqrt(fan_in), the JAX package's initializer; the shared and the
    multi head's 1x1 convolutions alike), zero biases, and identity
    batch-norm statistics."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
            w = module.weight
            # kernels are (out, in, ...), transposed-conv kernels (in, out, ...)
            if isinstance(module, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w[0, 0].numel()
            else:
                fan_in = w[0].numel()
            std = fan_in**-0.5
            w.copy_(torch.randn(w.shape, generator=gen) * std)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.BatchNorm1d):
            module.reset_parameters()  # unit scale, zero bias, identity running stats
    return model
