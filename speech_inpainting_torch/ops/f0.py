"""Fundamental-frequency (f0) tracking by normalised cross-correlation.

Counterpart of speech_inpainting_tpu/ops/f0.py, the functional replacement
for the reference's YAAPT usage (frame 20 ms, hop 5 ms, NCCF threshold 0.25,
±10 ms zero pad, unvoiced frames = 0). The NCCF numerator over every
candidate lag is one depthwise convolution, each frame a channel filtered by
its own first `win` samples (F.conv1d with groups = frames, as the JAX
package's grouped lax conv), and the sliding energies the same with a ones
kernel. Also the reference's post-processing: voiced-only z-normalisation
(`normalize_nonzero`) and per-speaker statistics (`f0_statistics`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class F0Config:
    sr: int = 16000
    frame_ms: float = 20.0       # YAAPT frame_length
    hop_ms: float = 5.0          # YAAPT frame_space
    corr_ms: float = 25.0        # correlation window (tda_frame_length)
    fmin: float = 60.0
    fmax: float = 400.0
    nccf_threshold: float = 0.25  # YAAPT nccf_thresh1
    energy_floor: float = 1e-4   # RMS gate relative to utterance peak RMS
    median_width: int = 3        # post smoothing of the lag track

    @property
    def hop(self) -> int:
        return int(self.sr * self.hop_ms / 1000)

    @property
    def win(self) -> int:
        return int(self.sr * self.corr_ms / 1000)

    @property
    def pad(self) -> int:
        return int(self.frame_ms / 1000 * self.sr) // 2

    @property
    def min_lag(self) -> int:
        return max(2, int(self.sr / self.fmax))

    @property
    def max_lag(self) -> int:
        return int(np.ceil(self.sr / self.fmin))

    def num_frames(self, samples: int) -> int:
        total = samples + 2 * self.pad
        flen = self.win + self.max_lag
        return max(0, 1 + (total - flen) // self.hop)


def _frames(x: torch.Tensor, flen: int, hop: int) -> torch.Tensor:
    return x.unfold(-1, flen, hop)               # (..., n, flen)


def _median(x: torch.Tensor, width: int) -> torch.Tensor:
    """Running median over the last axis, edges repeated; for an even width
    the mean of the two middle values, as jnp.median."""
    if width <= 1:
        return x
    h = width // 2
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], h), x,
                    x[..., -1:].expand(*x.shape[:-1], h)], dim=-1)
    s = xp.unfold(-1, width, 1)[..., :x.shape[-1], :].sort(dim=-1).values
    return 0.5 * (s[..., (width - 1) // 2] + s[..., width // 2])


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(-1, idx[..., None])[..., 0]


def _track(audio: torch.Tensor, cfg: F0Config) -> torch.Tensor:
    """audio (B, T) → f0 (B, frames)."""
    x = F.pad(audio.float(), (cfg.pad, cfg.pad))
    frames = _frames(x, cfg.win + cfg.max_lag, cfg.hop)  # (B, F, flen)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    B, n, flen = frames.shape
    flat = frames.reshape(1, B * n, flen)

    # NCCF numerator for every lag in one depthwise conv: input channels are
    # frames, each filtered by its own first `win` samples
    num = F.conv1d(flat, flat[0, :, None, :cfg.win], groups=B * n)
    # sliding energies by the same depthwise conv with a ones kernel
    ones = torch.ones(B * n, 1, cfg.win, device=x.device)
    energy = F.conv1d(flat * flat, ones, groups=B * n)
    num = num.reshape(B, n, -1)                          # (B, F, max_lag+1)
    energy = energy.reshape(B, n, -1)

    e0 = energy[..., :1]
    nccf = num / torch.sqrt(torch.clamp(e0 * energy, min=1e-12))

    band = nccf[..., cfg.min_lag:cfg.max_lag + 1]        # (B, F, L)
    # periodic signals peak at every period multiple; take the SMALLEST lag
    # whose local maximum is within 90% of the global max (octave guard)
    L = band.shape[-1]
    gmax = band.amax(dim=-1, keepdim=True)
    bp = F.pad(band, (1, 1), value=-float("inf"))
    local_max = (band >= bp[..., :-2]) & (band >= bp[..., 2:])
    cand = local_max & (band >= 0.9 * gmax)
    rank = L - torch.arange(L, device=x.device)
    best = (cand.long() * rank).argmax(dim=-1)           # first maximum
    peak = _take(band, best)

    # parabolic interpolation around the peak lag
    li = best.clamp(1, L - 2)
    ym, y0, yp = _take(band, li - 1), _take(band, li), _take(band, li + 1)
    denom = ym - 2 * y0 + yp
    delta = torch.where(denom.abs() > 1e-9,
                        0.5 * (ym - yp) / torch.where(denom == 0, 1.0, denom),
                        0.0).clamp(-0.5, 0.5)
    lag = (best + cfg.min_lag).float() + torch.where(best == li, delta, 0.0)
    lag = _median(lag, cfg.median_width)

    rms = torch.sqrt(e0[..., 0] / cfg.win)
    voiced = (peak > cfg.nccf_threshold) & (
        rms > cfg.energy_floor * rms.amax(dim=-1, keepdim=True))
    return torch.where(voiced, cfg.sr / lag.clamp(min=1.0), 0.0)


def extract_f0(audio: torch.Tensor, cfg: F0Config = F0Config()):
    """audio (T,) or (B, T) → f0 (frames,) / (B, frames); 0 = unvoiced."""
    if audio.ndim == 1:
        return _track(audio[None], cfg)[0]
    return _track(audio, cfg)


def normalize_nonzero(f0: torch.Tensor, mean, std, eps: float = 1e-8):
    """(f0 − mean)/std on voiced frames, 0 stays 0 (reference
    normalize_nonzero semantics)."""
    std = torch.clamp(torch.as_tensor(std, dtype=f0.dtype, device=f0.device),
                      min=eps)
    return torch.where(f0 == 0.0, 0.0, (f0 - mean) / std)


def f0_statistics(f0_list) -> dict:
    """Voiced-only mean/std across utterances → {'f0_mean', 'f0_std'}
    (the scripts/f0_stats.py per-speaker statistics), in numpy."""
    voiced = np.concatenate([np.asarray(f)[np.asarray(f) > 0]
                             for f in f0_list]) if f0_list else np.zeros(0)
    if voiced.size == 0:
        return {"f0_mean": 0.0, "f0_std": 1.0}
    return {"f0_mean": float(voiced.mean()), "f0_std": float(voiced.std())}
