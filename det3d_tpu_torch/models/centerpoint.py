"""CenterPoint-PP in PyTorch, for inference.

The anchor-free detector of tianweiy/CenterPoint
(`configs/nusc/pp/nusc_centerpoint_pp_02voxel_two_pfn_10sweep.py`; Yin,
Zhou, Krähenbühl, CVPR 2021): an N-layer pillar feature net → the BEV
scatter → CenterPoint's BatchNorm RPN → a CenterHead of task groups. Module
names and nesting are the upstream ones (`reader`, `neck`, `bbox_head`,
det3d's `Sequential` indices), so its `state_dict` keys are an upstream
checkpoint's and load with `strict=True`.

Layouts at the public boundary: the canvas is (B, ny, nx, C) (the upstream
scatter's row-major y, x order; the port's dense scatter kernel writes it
from coordinates given as (y, x, z)), viewed as an NCHW map (B, C, H=ny,
W=nx) in channels_last memory. The predictions are one dict a task:
`reg` (B, 2, H, W), `height` (B, 1, …), `dim` (B, 3, …), `rot` (B, 2, …),
`vel` (B, 2, …) and `hm` (B, ncls, …), in the compute dtype.

Parameters stay float32; convolutions and matmuls run in the config's
compute dtype (weights cast per call; the first pillar layer, whose inputs
are raw coordinates, in float32), each BatchNorm in eval form with its
running statistics (`F.batch_norm`, computed in float32 inside the op and
written in the compute dtype), then ReLU in place. Training is not ported:
`Trainer` refuses the center head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.kernels.scatter_cuda import scatter_to_bev
from det3d_tpu_torch.utils import timing

PFN_EPS = 1e-3     # upstream PFNLayer: BatchNorm1d(eps=1e-3, momentum=0.01)
RPN_EPS = 1e-3     # upstream RPN: build_norm_layer(dict(type="BN", eps=1e-3, momentum=0.01))
HEAD_EPS = 1e-5    # upstream CenterHead / SepHead: nn.BatchNorm2d defaults
DECORATIONS = 5    # f_cluster (3) + f_center (2) appended to each point's features


def _bn(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Eval-form batch norm over dim 1, in x's dtype."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)


class PFNLayer(nn.Module):
    """Linear (no bias) → BN → ReLU → max over the pillar's slots; a layer
    that is not the last concatenates the max back onto each point, so it
    emits twice its units (upstream `PFNLayer`)."""

    def __init__(self, in_channels: int, out_channels: int, last: bool):
        super().__init__()
        self.last = last
        units = out_channels if last else out_channels // 2
        self.linear = nn.Linear(in_channels, units, bias=False)
        self.norm = nn.BatchNorm1d(units, eps=PFN_EPS, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x (B, V, P, Cin) → (B, V, P, 2·units), or (B, V, units) for the last layer
        y = F.linear(x, self.linear.weight.to(x.dtype))
        shape = y.shape
        y = torch.relu_(_bn(y.reshape(-1, shape[-1]), self.norm).reshape(shape))
        top = y.amax(dim=-2, keepdim=True)
        if self.last:
            return top[..., 0, :]
        return torch.cat([y, top.expand_as(y)], dim=-1)


class PillarFeatureNet(nn.Module):
    """Decorate each point with its offset from the pillar's point mean and
    from the pillar's centre, zero the padding slots, then the PFN layers
    (upstream `PillarFeatureNet`; `pfn_filters` [64, 64]: 10 → 32 (+32) → 64)."""

    def __init__(self, cfg: Config, dtype: torch.dtype):
        super().__init__()
        self.voxel_size = tuple(float(v) for v in cfg.voxel_size)
        self.offset = tuple(float(v) for v in cfg.detection_offset)
        self.dtype = dtype
        filters = [cfg.num_point_features + DECORATIONS, *cfg.pfn_filters]
        self.pfn_layers = nn.ModuleList(
            [PFNLayer(filters[i], filters[i + 1], last=i == len(filters) - 2) for i in range(len(filters) - 1)])

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor, coors: torch.Tensor) -> torch.Tensor:
        # voxels (B, V, P, C) f32, num_points (B, V) int32, coors (B, V, 3) as (x, y, z) cells
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        counts = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None, None]
        points_mean = voxels[..., :3].sum(dim=-2, keepdim=True) / counts
        f_cluster = voxels[..., :3] - points_mean
        cx = coors[..., 0:1].to(voxels.dtype) * vx + (vx / 2 + self.offset[0])
        cy = coors[..., 1:2].to(voxels.dtype) * vy + (vy / 2 + self.offset[1])
        f_center = torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy], dim=-1)
        features = torch.cat([voxels, f_cluster, f_center], dim=-1)
        slot = torch.arange(voxels.shape[-2], device=voxels.device)
        mask = slot[None, None, :] < num_points[..., None]
        # the first layer in float32: its inputs are raw coordinates and
        # intensities, which bfloat16 would round to an eighth of a metre
        x = features * mask[..., None].to(features.dtype)
        for layer in self.pfn_layers:
            x = layer(x).to(self.dtype)
        # empty pillar slots are zeroed (their coords drop out of the scatter)
        return torch.where((num_points > 0)[..., None], x, 0.0).to(self.dtype)


def _run(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """An upstream `Sequential` of ZeroPad2d / Conv2d / ConvTranspose2d /
    BN / ReLU in the compute dtype (a ZeroPad2d(1) folds into the next
    convolution's padding)."""
    pad = 0
    for m in seq:
        if isinstance(m, nn.ZeroPad2d):
            pad = 1
        elif isinstance(m, nn.ConvTranspose2d):
            x = F.conv_transpose2d(x, m.weight.to(x.dtype), None, m.stride)
        elif isinstance(m, nn.Conv2d):
            bias = None if m.bias is None else m.bias.to(x.dtype)
            x = F.conv2d(x, m.weight.to(x.dtype), bias, m.stride, m.padding[0] + pad)
            pad = 0
        elif isinstance(m, nn.BatchNorm2d):
            x = _bn(x, m)
        elif isinstance(m, nn.ReLU):
            x = torch.relu_(x)
        else:
            raise TypeError(f"unexpected module {type(m).__name__}")
    return x


class RPN(nn.Module):
    """CenterPoint's BatchNorm RPN neck (upstream `necks/rpn.py`): a block a
    level, a strided 3x3 convolution (after ZeroPad2d(1)) and `layer_nums`
    3x3 convolutions, each BN + ReLU; each level upsampled to the common
    stride (stride < 1: a strided convolution of kernel 1/stride, else a
    transposed convolution of kernel = stride), BN + ReLU, and the levels
    concatenated."""

    def __init__(self, cfg: Config, in_channels: int):
        super().__init__()
        ins = [in_channels, *cfg.rpn_filters[:-1]]
        blocks, deblocks = [], []
        for cin, planes, n, stride, up, up_out in zip(ins, cfg.rpn_filters, cfg.rpn_layer_nums, cfg.rpn_strides,
                                                       cfg.rpn_up_strides, cfg.rpn_up_filters):
            layers = [nn.ZeroPad2d(1), nn.Conv2d(cin, planes, 3, stride=stride, bias=False),
                      nn.BatchNorm2d(planes, eps=RPN_EPS, momentum=0.01), nn.ReLU()]
            for _ in range(n):
                layers += [nn.Conv2d(planes, planes, 3, padding=1, bias=False),
                           nn.BatchNorm2d(planes, eps=RPN_EPS, momentum=0.01), nn.ReLU()]
            blocks.append(nn.Sequential(*layers))
            if up >= 1:
                k = int(round(up))
                first = nn.ConvTranspose2d(planes, up_out, k, stride=k, bias=False)
            else:
                k = int(round(1 / up))
                first = nn.Conv2d(planes, up_out, k, stride=k, bias=False)
            deblocks.append(nn.Sequential(first, nn.BatchNorm2d(up_out, eps=RPN_EPS, momentum=0.01), nn.ReLU()))
        self.blocks = nn.ModuleList(blocks)
        self.deblocks = nn.ModuleList(deblocks)
        self.out_channels = sum(cfg.rpn_up_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = _run(block, x)
            ups.append(_run(deblock, x))
        return torch.cat(ups, dim=1)


class SepHead(nn.Module):
    """One task's branches (upstream `SepHead`, `final_kernel` 3, `bn`):
    each a 3x3 conv (bias) + BN + ReLU, then a 3x3 conv (bias) to the
    branch's outputs; `hm` last, with one output a class."""

    def __init__(self, in_channels: int, heads: dict[str, int], head_conv: int):
        super().__init__()
        self.names = tuple(heads)
        for name, out in heads.items():
            self.add_module(name, nn.Sequential(
                nn.Conv2d(in_channels, head_conv, 3, padding=1, bias=True), nn.BatchNorm2d(head_conv, eps=HEAD_EPS),
                nn.ReLU(), nn.Conv2d(head_conv, out, 3, padding=1, bias=True)))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        return {name: _run(getattr(self, name), x) for name in self.names}


class CenterHead(nn.Module):
    """A shared 3x3 conv (bias) + BN + ReLU, then one `SepHead` a task
    (upstream `CenterHead`, `share_conv_channel` = `head_conv`)."""

    def __init__(self, cfg: Config, in_channels: int):
        super().__init__()
        self.shared_conv = nn.Sequential(nn.Conv2d(in_channels, cfg.head_conv, 3, padding=1, bias=True),
                                         nn.BatchNorm2d(cfg.head_conv, eps=HEAD_EPS), nn.ReLU())
        common = dict(cfg.common_heads)
        self.tasks = nn.ModuleList(
            [SepHead(cfg.head_conv, {**common, "hm": len(t)}, cfg.head_conv) for t in cfg.tasks])

    def forward(self, x: torch.Tensor) -> list[dict[str, torch.Tensor]]:
        x = _run(self.shared_conv, x)
        return [task(x) for task in self.tasks]


class CenterPointPP(nn.Module):
    """PFN → BEV scatter → RPN → CenterHead; the stage mark `neck` between
    the RPN and the head (`utils.timing`). `scatter` is the dense scatter
    (`kernels.scatter_cuda.scatter_to_bev`, the CUDA kernel on the card); a
    caller may set the plain version in its place."""

    def __init__(self, cfg: Config):
        super().__init__()
        from det3d_tpu_torch.models.pointpillars import compute_dtype

        if not cfg.center:
            raise ValueError(f"head {cfg.head!r}: CenterPointPP is the center model")
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.grid_yx = (cfg.grid_size[1], cfg.grid_size[0])
        self.reader = PillarFeatureNet(cfg, self.dtype)
        self.neck = RPN(cfg, cfg.pfn_filters[-1])
        self.bbox_head = CenterHead(cfg, self.neck.out_channels)
        self.scatter = scatter_to_bev

    def canvas(self, pillar_features: torch.Tensor, coors: torch.Tensor) -> torch.Tensor:
        """(B, C, ny, nx) NCHW view of channels_last memory."""
        yxz = torch.stack([coors[..., 1], coors[..., 0], coors[..., 2]], dim=-1)
        return self.scatter(pillar_features.contiguous(), yxz, self.grid_yx).permute(0, 3, 1, 2)

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor, coors: torch.Tensor,
                spatial: None = None) -> list[dict]:
        # voxels (B, V, P, C), num_points (B, V) int32, coors (B, V, 3) int32 (x, y, z); no spatial path
        if spatial is not None:
            raise ValueError("the center model has no spatial path")
        x = self.neck(self.canvas(self.reader(voxels, num_points, coors), coors))
        timing.mark("neck")
        return self.bbox_head(x)


@torch.no_grad()
def init_weights(model: CenterPointPP, seed: int) -> CenterPointPP:
    """Random weights from a seeded `torch.Generator` on the CPU: LeCun-normal
    kernels (std 1/sqrt(fan in)), zero biases, identity batch norms, and the
    heatmap biases at the focal-loss prior 0.01 (so the score gate binds)."""
    gen = torch.Generator().manual_seed(seed)
    for name, module in model.named_modules():
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = module.weight
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(module, nn.ConvTranspose2d) else w[0].numel()
            w.copy_(torch.randn(w.shape, generator=gen) * fan_in ** -0.5)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            module.reset_parameters()
    for task in model.bbox_head.tasks:
        task.hm[-1].bias.fill_(-4.59511985013459)   # log(0.01 / 0.99)
    return model
