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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.kernels.scatter_cuda import scatter_to_bev

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
                train: bool = False) -> torch.Tensor:
        # voxels (B, V, P, 4) f32, num_points (B, V) int32, coors (B, V, 3)
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
            mean, var = masked_batch_stats(x, mask, bn)
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


def masked_batch_stats(x: torch.Tensor, mask: torch.Tensor, bn: nn.BatchNorm1d):
    """Training statistics of the PFN batch norm (the JAX package's
    MaskedBatchNorm, models/pointpillars.py:51-104): float32 mean and biased
    variance over the valid point slots only, per channel of x (..., C);
    `mask` (...) marks the valid slots. Updates `bn`'s running statistics
    with the unbiased variance sum_sq / max(count - 1, 1), as torch's
    BatchNorm1d stores it. `nn.BatchNorm1d`'s own train forward would
    average the padding slots too, so it holds the parameters only."""
    m = mask.to(torch.float32)[..., None]
    xf = x.to(torch.float32)
    red = tuple(range(x.dim() - 1))
    count = m.sum()
    denom = torch.clamp(count, min=1.0)
    mean = (xf * m).sum(dim=red) / denom
    sum_sq = (m * (xf - mean) ** 2).sum(dim=red)
    with torch.no_grad():
        # torch's convention: momentum is the share of the new batch statistic
        var_unbiased = sum_sq / torch.clamp(count - 1.0, min=1.0)
        bn.running_mean.copy_((1 - bn.momentum) * bn.running_mean + bn.momentum * mean)
        bn.running_var.copy_((1 - bn.momentum) * bn.running_var + bn.momentum * var_unbiased)
    return mean, sum_sq / denom


def _in_moments(x: torch.Tensor):
    """Per-(sample, channel) float32 mean and rsqrt(var + 1e-3) of an NCHW
    map, from single-pass sums; and the element count per channel."""
    xf = x.float()
    n = x.shape[2] * x.shape[3]
    mean = xf.sum(dim=(2, 3)) / n
    var = torch.clamp((xf * xf).sum(dim=(2, 3)) / n - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + 1e-3), n


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d without affine, eps 1e-3, over (H, W) of an NCHW map
    (reference :128): float32 single-pass moments, the biased variance, and
    the normalisation applied in the input dtype, as the JAX package does."""
    mean, inv, _ = _in_moments(x)
    return (x - mean[:, :, None, None].to(x.dtype)) * inv[:, :, None, None].to(x.dtype)


class InstanceNormFn(torch.autograd.Function):
    """`instance_norm` with the analytic backward of the JAX package's
    `_in_bwd` (models/pointpillars.py:321-332):
        dx = r·(g − mean(g) − x̂·mean(g·x̂)),  x̂ = (x − μ)·r,
    two float32 reductions and one elementwise pass over the cotangent, in
    place of autograd through the single-pass moments (another rounding of
    the same function, at a higher cost)."""

    @staticmethod
    def forward(ctx, x):
        mean, inv, n = _in_moments(x)
        ctx.save_for_backward(x, mean, inv)
        ctx.n = n
        return (x - mean[:, :, None, None].to(x.dtype)) * inv[:, :, None, None].to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv = ctx.saved_tensors
        inv_c = inv[:, :, None, None].to(x.dtype)
        xhat = (x - mean[:, :, None, None].to(x.dtype)) * inv_c
        m_g = g.float().sum(dim=(2, 3)) / ctx.n
        m_gx = (g * xhat).float().sum(dim=(2, 3)) / ctx.n
        dx = inv_c * (g - m_g[:, :, None, None].to(g.dtype) - xhat * m_gx[:, :, None, None].to(g.dtype))
        return dx.to(x.dtype)


class InstanceNorm(nn.Module):
    """Instance norm as a module, so Sequential indices match the
    reference's (it holds no parameters or buffers): `instance_norm` under
    no_grad, `InstanceNormFn` when a gradient is wanted."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            return InstanceNormFn.apply(x)
        return instance_norm(x)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class RPN(nn.Module):
    """Three strided blocks (depths 2/4/4, widths 64/128/256) and three
    upsample branches (64/128/128 at strides 1/2/4) concatenated to 320
    channels at half the canvas resolution (reference :114-181).

    Block b is [3x3 stride-2 conv, IN, ReLU, Resnet2(2) x depth/2,
    Resnet2(1)]. torch's padding=1 on an even input equals the JAX
    package's (1, 0) padding: the last row and column of padding are never
    read."""

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
        self.out_channels = sum(num_upsample_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        for b in range(1, self.num_blocks + 1):
            x = getattr(self, f"block{b}")(x)
            ups.append(getattr(self, f"deconv{b}")(x))
        return torch.cat(ups, dim=1)


class SharedHead(nn.Module):
    """1x1 convs conv_cls / conv_box / conv_dir over the RPN features
    (reference :299-343), run as one conv over their concatenated weights.
    Output channels are in the reference's [anchor][k] order; the result is
    returned in the spatial channel-major preds contract."""

    def __init__(self, in_channels: int, num_anchor_per_loc: int, box_code_size: int):
        super().__init__()
        a = num_anchor_per_loc
        self.num_anchor_per_loc = a
        self.box_code_size = box_code_size
        self.conv_cls = nn.Conv2d(in_channels, a, 1)
        self.conv_box = nn.Conv2d(in_channels, a * box_code_size, 1)
        self.conv_dir = nn.Conv2d(in_channels, a * 2, 1)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        a, code = self.num_anchor_per_loc, self.box_code_size
        convs = (self.conv_cls, self.conv_box, self.conv_dir)
        w = torch.cat([c.weight for c in convs]).to(x.dtype)
        bias = torch.cat([c.bias for c in convs]).to(x.dtype)
        y = F.conv2d(x, w, bias)                                  # (N, a·10, H, W)
        n, _, h, wd = y.shape

        def split(part: torch.Tensor, k: int) -> torch.Tensor:
            # (N, a·k, H, W) [anchor][k] → (N, k, a, H, W)
            return part.reshape(n, a, k, h, wd).transpose(1, 2)

        cls, box, dire = torch.split(y, [a, a * code, a * 2], dim=1)
        return {"cls_preds": split(cls, 1), "box_preds": split(box, code), "dir_preds": split(dire, 2)}


class PointPillars(nn.Module):
    """PFN → scatter → RPN → SharedHead (reference :346-382).

    `scatter` makes the canvas: `kernels.scatter_cuda.scatter_to_bev`
    by default (the CUDA kernel on the card); a caller may set the plain
    version in its place to compare the two end to end."""

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.head != "shared":
            raise NotImplementedError(f"head {cfg.head!r}: only the shared head is ported")
        self.dtype = compute_dtype(cfg)
        self.grid_xy = (cfg.grid_size[0], cfg.grid_size[1])
        self.pillar_point_net = PFN(cfg.voxel_size, cfg.detection_offset, self.dtype)
        self.rpn = RPN()
        self.heads = SharedHead(self.rpn.out_channels, cfg.num_anchors_per_loc, cfg.box_code_size)
        self.scatter = scatter_to_bev

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor, coors: torch.Tensor,
                train: bool = False) -> dict:
        # voxels (B, V, P, 4), num_points (B, V) int32, coors (B, V, 3) int32;
        # train: masked batch statistics in the PFN (and their running update)
        pillar_features = self.pillar_point_net(voxels, num_points, coors, train)
        canvas = self.scatter(pillar_features.contiguous(), coors.contiguous(), self.grid_xy)
        x = canvas.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        return self.heads(self.rpn(x))


@torch.no_grad()
def init_weights(model: PointPillars, seed: int) -> PointPillars:
    """Random weights from a seeded `torch.Generator`, made on the CPU so a
    seed gives the same weights on every device: LeCun-normal kernels
    (std 1/sqrt(fan_in), the JAX package's initializer), zero biases, and
    identity batch-norm statistics."""
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
