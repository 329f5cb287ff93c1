"""Nearest-centroid assignment, the counterpart of
speech_inpainting_tpu/quantize/kmeans.py's `pairwise_sqdist` and `assign`
(fitting is not ported yet).

The distance keeps the reference's expansion ‖x‖² − 2x·c + ‖c‖²
(I_ea/dataset/km_label.py:26-34), one matrix product. `torch.cdist` would
sum in another order, and `argmin` could then pick another centroid at a
near tie.
"""
from __future__ import annotations

import torch


def pairwise_sqdist(x: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """‖x−c‖² for x (N, D), C (K, D) → (N, K)."""
    x_sq = (x * x).sum(dim=-1)
    c_sq = (C * C).sum(dim=-1)
    return x_sq[:, None] - 2.0 * (x @ C.t()) + c_sq[None, :]


def assign(x: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid labels for x (..., D) against C (K, D) → (...,)
    int64 (the first of equal distances, as jnp.argmin)."""
    flat = x.reshape(-1, x.shape[-1])
    return pairwise_sqdist(flat, C).argmin(dim=-1).reshape(x.shape[:-1])
