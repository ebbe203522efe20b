"""Weight bridge: JAX-package variables → the port's `state_dict`.

The JAX package stores `{"params", "batch_stats"}` trees with Flax shapes
(HWIO conv kernels, (in, out) dense kernels, flipped transposed-conv
kernels). `variables_to_state_dict` maps such a tree, as numpy arrays, to
the reference network's `state_dict` keys and torch layouts — the port's
own copy of the JAX package's deploy/torch_interop.variables_to_state_dict
(numpy only) — so `PointPillars.load_state_dict(..., strict=True)` takes
it directly.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.float32)


def variables_to_state_dict(variables: dict, layer_nums: tuple[int, ...] = (2, 4, 4)) -> dict:
    """`{"params", "batch_stats"}` numpy tree → reference `state_dict` keys
    as numpy arrays, including BatchNorm's `num_batches_tracked` (zero) so
    the result loads with `strict=True`.

    Reference block layout (networks/pointpillars8_shared.py:114-181):
    [conv, IN, relu, Resnet2(2 convs) x depth/2, Resnet2(1 conv)], with a
    Resnet2's convs at `conv_block` indices 2 and 5."""
    p, bs = variables["params"], variables["batch_stats"]
    sd = {
        # nn.Dense (I, O) → Conv1d (O, I, 1)
        "pillar_point_net.pfn_layers.0.weight": _f32(p["pfn"]["pfn_dense"]["kernel"]).T[..., None],
        "pillar_point_net.pfn_layers.1.weight": _f32(p["pfn"]["pfn_bn"]["scale"]),
        "pillar_point_net.pfn_layers.1.bias": _f32(p["pfn"]["pfn_bn"]["bias"]),
        "pillar_point_net.pfn_layers.1.running_mean": _f32(bs["pfn"]["pfn_bn"]["mean"]),
        "pillar_point_net.pfn_layers.1.running_var": _f32(bs["pfn"]["pfn_bn"]["var"]),
        "pillar_point_net.pfn_layers.1.num_batches_tracked": np.zeros((), np.int64),
    }
    rpn = p["rpn"]
    for b, depth in enumerate(layer_nums, start=1):
        # HWIO → OIHW
        sd[f"rpn.block{b}.0.weight"] = _f32(rpn[f"block{b - 1}_down"]["kernel"]).transpose(3, 2, 0, 1)
        n_full = depth // 2
        units = [(3 + u, 2) for u in range(n_full)] + [(3 + n_full, 1)]
        for u, (seq_idx, n_convs) in enumerate(units):
            for i in range(n_convs):
                sd[f"rpn.block{b}.{seq_idx}.conv_block.{2 + 3 * i}.weight"] = _f32(
                    rpn[f"block{b - 1}_res{u}"][f"conv{i}"]["kernel"]
                ).transpose(3, 2, 0, 1)
    # deconv0 is a 1x1 conv (1, 1, I, O) ≡ ConvTranspose2d k=1 (I, O, 1, 1);
    # the strided ones un-flip the JAX kernel (S, S, I, O) → (I, O, S, S)
    sd["rpn.deconv1.0.weight"] = _f32(rpn["deconv0"]["kernel"]).transpose(2, 3, 0, 1)
    sd["rpn.deconv2.0.weight"] = np.flip(_f32(rpn["deconv1"]["kernel"]), (0, 1)).transpose(2, 3, 0, 1)
    sd["rpn.deconv3.0.weight"] = np.flip(_f32(rpn["deconv2"]["kernel"]), (0, 1)).transpose(2, 3, 0, 1)
    head = p["head"]
    # the shared head's conv_{cls,box,dir}, or the multi head's
    # head{c}_{reduce,cls,box,dir} (`MultiHead`); no reference `.pth`
    # layout exists for the latter, so these are the port's own keys
    for name in ("conv_cls", "conv_box", "conv_dir") if "conv_cls" in head else head:
        # nn.Dense (I, O) → Conv2d 1x1 (O, I, 1, 1), [anchor][k] channel order
        sd[f"heads.{name}.weight"] = _f32(head[name]["kernel"]).T[..., None, None]
        sd[f"heads.{name}.bias"] = _f32(head[name]["bias"])
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def to_tensors(state_dict: dict) -> dict[str, torch.Tensor]:
    """numpy `state_dict` → CPU tensors (copies), ready for `load_state_dict`."""
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in state_dict.items()}
