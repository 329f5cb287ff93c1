"""Where the port's entry points run: the CUDA card unless the caller asks
for the CPU. Without a card, an entry point raises instead of quietly running
on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the current CUDA device; "cpu" must be asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
