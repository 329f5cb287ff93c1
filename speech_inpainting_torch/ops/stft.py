"""STFT as one GEMM, and its inverse as one GEMM and an overlap-add.

Forward: reflect pad, frame, and multiply by a Hann-windowed DFT basis
(torch.stft(center=False, onesided=True) numerics, with the reference's
+1e-9 inside the magnitude's square root). Inverse (`istft_overlap_add`):
an inverse-rDFT basis product, the Hann window, an overlap-add normalised by
the window-square envelope, and torch.istft(center=True)'s trim, as
speech_inpainting_tpu/ops/stft.py computes it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import cast, tensor_cache


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


@tensor_cache(maxsize=16)
@torch.inference_mode(False)
def _dft_basis(n_fft: int, win_size: int, device: torch.device) -> torch.Tensor:
    """(n_fft, 2·n_freq) float32 basis on `device`, made once per device,
    outside inference mode even when first asked for inside it: the
    trainers' in-graph mel saves it for backward, which an inference
    tensor refuses."""
    basis = torch.from_numpy(_dft_kernel_np(n_fft, win_size)[:, 0, :])
    return basis.t().contiguous().to(device)


def frame_count(num_samples: int, n_fft: int, hop: int, pad: int) -> int:
    """STFT frames of a signal of `num_samples` after a symmetric pad."""
    return 1 + (num_samples + 2 * pad - n_fft) // hop


def _frames_spec(y: torch.Tensor, n_fft: int, hop: int, win_size: int,
                 pad: int) -> torch.Tensor:
    """(B, F, 2·n_freq) [re | im] of y (B, T) after the reflect pad."""
    if pad > 0:
        y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop)                      # (B, F, n_fft)
    return frames @ cast(_dft_basis(n_fft, win_size, y.device), y.dtype)


def stft_magnitude(y: torch.Tensor, *, n_fft: int, hop: int, win_size: int,
                   pad: int, eps: float = 1e-9) -> torch.Tensor:
    """|STFT(y)|, y (B, T) or (T,) → (B, n_freq, frames) or (n_freq, frames).

    `pad` is the symmetric reflect pad applied before framing: (n_fft−hop)//2
    in the reference, except the hop-441 frontend, which pads 312.
    """
    squeeze = y.ndim == 1
    spec = _frames_spec(y[None] if squeeze else y, n_fft, hop, win_size, pad)
    n_freq = n_fft // 2 + 1
    re, im = spec[..., :n_freq], spec[..., n_freq:]
    mag = torch.sqrt(re * re + im * im + eps).transpose(1, 2)
    return mag[0] if squeeze else mag


def stft_complex(y: torch.Tensor, *, n_fft: int, hop: int, win_size: int,
                 pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(re, im) STFT parts, each (B, n_freq, frames) (or (n_freq, frames)
    for y (T,)), with `stft_magnitude`'s conventions."""
    squeeze = y.ndim == 1
    spec = _frames_spec(y[None] if squeeze else y, n_fft, hop, win_size, pad)
    n_freq = n_fft // 2 + 1
    re = spec[..., :n_freq].transpose(1, 2)
    im = spec[..., n_freq:].transpose(1, 2)
    return (re[0], im[0]) if squeeze else (re, im)


@functools.lru_cache(maxsize=16)
def _idft_kernel_np(n_fft: int) -> np.ndarray:
    """(2·n_freq, n_fft) inverse-rDFT basis: time frame = [Re; Im] @ basis.

    x[n] = (1/N)·Σ_k c_k·(Re S_k·cos(2πkn/N) − Im S_k·sin(2πkn/N)),
    c_k = 1 for k ∈ {0, N/2}, else 2 (the conjugate-symmetric half).
    """
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(n_freq)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    c = np.full((n_freq, 1), 2.0)
    c[0] = c[-1] = 1.0
    basis = np.concatenate([c * np.cos(ang), -c * np.sin(ang)]) / n_fft
    return basis.astype(np.float32)


@tensor_cache(maxsize=64)
@torch.inference_mode(False)
def _istft_consts(n_fft: int, hop: int, frames: int, device: torch.device,
                  dtype: torch.dtype):
    """The inverse-DFT basis and the Hann window in `dtype`, and the trimmed
    window-square overlap-add envelope of `frames` frames floored at 1e-11
    (float32), on `device`: made once, so that no call copies a host array
    to the card (a pageable copy would wait for the card's stream)."""
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    w2 = np.tile(win ** 2, (frames, 1))
    wsq = np.zeros((frames - 1) * hop + n_fft, np.float32)
    for j in range(n_fft // hop):  # in the order the samples are added
        wsq[j * hop:j * hop + frames * hop] += w2[:, j * hop:(j + 1) * hop
                                                  ].reshape(-1)
    half = n_fft // 2
    env = np.maximum(wsq[half:len(wsq) - half], 1e-11)
    return (torch.from_numpy(_idft_kernel_np(n_fft)).to(device, dtype),
            torch.from_numpy(win).to(device, dtype),
            torch.from_numpy(env).to(device))


def istft_overlap_add(spec_real: torch.Tensor, spec_imag: torch.Tensor, *,
                      n_fft: int, hop: int) -> torch.Tensor:
    """Inverse STFT with Hann windowing and overlap-add, torch.istft
    (center=True) semantics: spec_real, spec_imag (B, n_fft//2+1, F) →
    (B, (F−1)·hop) samples, n_fft//2 trimmed from both ends and the sum
    divided by the window-square envelope. One matrix product for the
    inverse DFT, then n_fft/hop strided adds, which autograd carries (the
    trainable iSTFT head backpropagates through them; the constants come
    from `_istft_consts`, made outside inference mode). Requires hop |
    n_fft (the iSTFT head's n_fft 16 / hop 4)."""
    assert n_fft % hop == 0, "hop must divide n_fft for the strided OLA"
    b, _, f = spec_real.shape
    dev, dtype = spec_real.device, spec_real.dtype
    basis, win, env = _istft_consts(n_fft, hop, f, dev, dtype)
    ri = torch.cat([spec_real, spec_imag], dim=1)            # (B, 2n_freq, F)
    frames = (ri.transpose(1, 2) @ basis) * win              # (B, F, n_fft)
    out = torch.zeros(b, (f - 1) * hop + n_fft, dtype=dtype, device=dev)
    for j in range(n_fft // hop):  # sample f·hop + j·hop + s ← frame f, tap j·hop + s
        seg = frames[:, :, j * hop:(j + 1) * hop].reshape(b, f * hop)
        out[:, j * hop:j * hop + f * hop] += seg
    half = n_fft // 2
    return out[:, half:out.shape[1] - half] / env
