"""Weights made from the seed on the device, handed alike to the program
and to the reference.

One normal draw on the device fills every kernel (LeCun normal, std
1/sqrt(fan in)); biases are zero but the classification bias, which sits at
the focal-loss prior of 0.01 as detection heads are initialised; the pillar
batch norm starts as the identity. The names and shapes are the
reference's state_dict keys (`benchmark/reference/pointpillars.Network`),
which the program loads strictly.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import pointpillars as ref

CLS_PRIOR = 0.01


def make(seed: int, geo: ref.Geometry, device) -> dict[str, torch.Tensor]:
    shapes = {k: v.shape for k, v in ref.Network(geo.num_channels).state_dict().items()}
    kernels = [k for k, s in shapes.items() if k.endswith("weight") and len(s) >= 3]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    total = sum(math.prod(shapes[k]) for k in kernels)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k in kernels:
        s = shapes[k]
        n = math.prod(s)
        # kernels are (out, in, ...), transposed ones (in, out, ...)
        fan_in = (s[0] if ".deconv" in k else s[1]) * math.prod(s[2:])
        out[k] = flat[at:at + n].view(s) * fan_in ** -0.5
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
    out["heads.conv_cls.bias"] = torch.full_like(out["heads.conv_cls.bias"], -math.log((1 - CLS_PRIOR) / CLS_PRIOR))
    return out


def reference_network(weights: dict[str, torch.Tensor], geo: ref.Geometry, device) -> ref.Network:
    net = ref.Network(geo.num_channels).to(device)
    net.load_state_dict({k: v.clone() for k, v in weights.items()}, strict=True)
    return net.eval()
