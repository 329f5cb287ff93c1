"""STFT magnitude as one GEMM: reflect pad, frame, and multiply by a
Hann-windowed DFT basis (torch.stft(center=False, onesided=True) numerics,
with the reference's +1e-9 inside the square root)."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def _dft_kernel_np(n_fft: int, win_size: int) -> np.ndarray:
    """(2·n_freq, 1, n_fft) basis: rows = [win·cos_k ; −win·sin_k]."""
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(n_freq)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    window = np.hanning(win_size + 1)[:-1]  # == torch.hann_window(periodic)
    if win_size < n_fft:  # torch center-pads the window
        pad = (n_fft - win_size) // 2
        window = np.pad(window, (pad, n_fft - win_size - pad))
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0) * window[None, :]
    return basis[:, None, :].astype(np.float32)


@functools.lru_cache(maxsize=16)
def _dft_basis(n_fft: int, win_size: int, device: torch.device) -> torch.Tensor:
    """(n_fft, 2·n_freq) float32 basis on `device`, made once per device."""
    basis = torch.from_numpy(_dft_kernel_np(n_fft, win_size)[:, 0, :])
    return basis.t().contiguous().to(device)


def frame_count(num_samples: int, n_fft: int, hop: int, pad: int) -> int:
    """STFT frames of a signal of `num_samples` after a symmetric pad."""
    return 1 + (num_samples + 2 * pad - n_fft) // hop


def stft_magnitude(y: torch.Tensor, *, n_fft: int, hop: int, win_size: int,
                   pad: int, eps: float = 1e-9) -> torch.Tensor:
    """|STFT(y)|, y (B, T) or (T,) → (B, n_freq, frames) or (n_freq, frames).

    `pad` is the symmetric reflect pad applied before framing: (n_fft−hop)//2
    in the reference, except the hop-441 frontend, which pads 312.
    """
    squeeze = y.ndim == 1
    if squeeze:
        y = y[None]
    if pad > 0:
        y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop)                      # (B, F, n_fft)
    spec = frames @ _dft_basis(n_fft, win_size, y.device).to(y.dtype)
    n_freq = n_fft // 2 + 1
    re, im = spec[..., :n_freq], spec[..., n_freq:]
    mag = torch.sqrt(re * re + im * im + eps).transpose(1, 2)
    return mag[0] if squeeze else mag
