"""The port's choice of device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """"cuda" unless the caller names another device. A CUDA device
    without a card is an error, never a silent CPU run."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device
