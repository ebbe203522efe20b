"""Weights made from the seed on the device, handed alike to the program
and to the reference.

One normal draw on the device fills every kernel (LeCun normal, std
1/sqrt(fan in)); biases are zero, and norms start as the identity. The
names and shapes are a family's reference's state_dict keys, which the
program loads strictly; the family sets what it starts elsewhere
(`benchmark/families/<family>.py`: `make_weights`).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


def draw(seed: int, state: dict[str, torch.Tensor], device,
         fan_in: Callable[[str, torch.Size], int]) -> dict[str, torch.Tensor]:
    """Every entry of `state` made anew from the seed, in its order: the
    kernels (weights of three dimensions or more) from one draw, each
    scaled by its `fan_in(name, shape) ** -0.5`; then norm scales and
    running variances at one, batch counters and the rest at zero."""
    shapes = {k: v.shape for k, v in state.items()}
    kernels = [k for k, s in shapes.items() if k.endswith("weight") and len(s) >= 3]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    total = sum(math.prod(shapes[k]) for k in kernels)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k in kernels:
        s = shapes[k]
        n = math.prod(s)
        out[k] = flat[at:at + n].view(s) * fan_in(k, s) ** -0.5
        at += n
    for k, s in shapes.items():
        if k in out:
            continue
        if k.endswith("running_var") or (k.endswith("weight") and len(s) == 1):
            out[k] = torch.ones(s, device=device)
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(s, dtype=torch.int64, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def load(net: nn.Module, weights: dict[str, torch.Tensor], device) -> nn.Module:
    """`net` on the device holding a copy of the weights, strictly, in eval mode."""
    net = net.to(device)
    net.load_state_dict({k: v.clone() for k, v in weights.items()}, strict=True)
    return net.eval()
