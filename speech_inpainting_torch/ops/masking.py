"""Waveform and frame masks (the reference's index conventions).

Positions and lengths are ints or tensors of shape x.shape[:-1], so one call
masks a batch with a span per row:
  - I_ea 16 kHz masking zeroes samples [pos·320 + 80, (pos+len)·320 − 1);
  - the 22.05 kHz branch zeroes [pos·441, (pos+len)·441).
"""
from __future__ import annotations

import torch

HUBERT_HOP = 320
HUBERT_EDGE = 80  # half the (400-80) receptive-field margin of the reference


def _span(n: int, start, length, device) -> torch.Tensor:
    idx = torch.arange(n, device=device)
    start = torch.as_tensor(start, device=device).unsqueeze(-1)
    length = torch.as_tensor(length, device=device).unsqueeze(-1)
    return (idx >= start) & (idx < start + length)


def mask_span(x: torch.Tensor, start, length) -> torch.Tensor:
    """Zero x[..., start:start+length]."""
    return x.masked_fill(_span(x.shape[-1], start, length, x.device), 0.0)


def mask_wave_frames(wave: torch.Tensor, mask_pos, mask_len_frames):
    """Zero samples [pos·320 + 80, (pos + len)·320 − 1) of a 16 kHz wave."""
    mask_pos = torch.as_tensor(mask_pos, device=wave.device)
    mask_len_frames = torch.as_tensor(mask_len_frames, device=wave.device)
    start = mask_pos * HUBERT_HOP + HUBERT_EDGE
    end = (mask_pos + mask_len_frames) * HUBERT_HOP - 1
    return mask_span(wave, start, end - start)


def frame_mask(num_frames: int, mask_pos, mask_len,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Boolean (..., num_frames) mask, True inside [pos, pos+len)."""
    return _span(num_frames, mask_pos, mask_len, device)


def mask_wave_samples(wave: torch.Tensor, start_sample, num_samples):
    """Zero an arbitrary sample span [start, start + num) (the 22.05 kHz
    predict path, the I_da path)."""
    return mask_span(wave, start_sample, num_samples)


def splice_frames(base: torch.Tensor, replacement: torch.Tensor, mask_pos,
                  mask_len) -> torch.Tensor:
    """base (..., frames) with its frames [pos, pos + len) taken from the
    same positions of `replacement`, which has base's shape: the
    reference's centroid splice into the masked mel region
    (I_ea/predict.py:184-189)."""
    m = frame_mask(base.shape[-1], mask_pos, mask_len, base.device)
    return torch.where(m, replacement, base)
