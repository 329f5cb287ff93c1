"""Linear time-axis resize with F.interpolate(align_corners=False) semantics.

The reference regrids the hop-441 mel onto the vocoder's hop-256 grid with a
bilinear interpolate whose mel axis has scale 1, so it is a 1-D linear
interpolation along frames, written here as a gather and a lerp.
"""
from __future__ import annotations

import math

import torch


def interp_linear(x: torch.Tensor, out_len: int, *,
                  scale: float | None = None) -> torch.Tensor:
    """Resample the last axis to `out_len` points.

    The source of output i is (i + 0.5)/scale − 0.5, clipped to [0, in−1],
    with scale = out_len/in_len unless an explicit `scale` is given (torch
    uses a given scale_factor as it is).
    """
    in_len = x.shape[-1]
    s = (out_len / in_len) if scale is None else scale
    pos = (torch.arange(out_len, dtype=torch.float32, device=x.device)
           + 0.5) / s - 0.5
    pos = pos.clamp(0.0, in_len - 1)
    lo = pos.floor().to(torch.int64)
    hi = (lo + 1).clamp(max=in_len - 1)
    w = (pos - lo.to(torch.float32)).to(x.dtype)
    return x[..., lo] * (1 - w) + x[..., hi] * w


def extend_mel(mel: torch.Tensor, *, src_hop: int = 441,
               dst_hop: int = 256) -> torch.Tensor:
    """Regrid a hop-`src_hop` mel (..., n_mels, frames) onto the hop-`dst_hop`
    grid: floor(frames · src/dst) output frames, at the explicit scale
    src/dst (the reference passes a scale_factor, not a size)."""
    scale = src_hop / dst_hop
    out_len = math.floor(mel.shape[-1] * scale)
    return interp_linear(mel, out_len, scale=scale)


def regrid_mel_to(mel: torch.Tensor, out_frames: int) -> torch.Tensor:
    """Regrid (..., n_mels, frames) to an explicit frame count, at the
    scale out_frames/frames (meldataset_modified's size= path)."""
    return interp_linear(mel, out_frames)
