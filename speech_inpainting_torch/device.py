"""Where the port's entry points run: the CUDA card unless the caller asks
for the CPU. Without a card, an entry point raises instead of quietly running
on the CPU. `full_f32` is the numerics the entry points pin for the call."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the current CUDA device; "cpu" must be asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def full_f32():
    """Run float32 convolutions and matrix products in full float32, as the
    JAX package does at `Precision.HIGHEST`: turns off TF32 in cuDNN and
    cuBLAS (torch lets cuDNN's f32 convolutions run in TF32 by default) and
    restores the caller's flags on exit, also after an exception."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
