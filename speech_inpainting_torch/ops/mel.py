"""Log-mel frontend: librosa's slaney filterbank (computed here, librosa is
not a dependency) over the GEMM STFT, then log(clamp(·, 1e-5)).

Presets:
  - VOCODER_MEL_22K: 22.05 kHz, n_fft 1024, hop 256, win 1024, pad 384;
  - VOCODER_MEL_22K_FULLBAND: the same up to Nyquist (fmax None), the
    HiFi-GAN trainers' loss mel (fmax_for_loss);
  - HUBERT_ALIGNED_MEL_22K: the same at hop 441 (20 ms), pad 312, the frame
    grid of HuBERT's 20 ms frames;
  - MODIFIED_MEL_22K: hop 441 at the hifi_gan mel's own pad (n_fft −
    hop)//2 = 291, not 312: the modified trainer's hop-441 mel;
  - VOCODER_MEL_16K: VOCODER_MEL_22K's geometry at 16 kHz (I_da).
The mel carries a gradient to its waveform (the trainers' mel-L1 loss).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .stft import stft_magnitude


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    return np.where(log_region,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz)
                    / logstep, mels)


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    return np.where(log_region,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float | None) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular filterbank (librosa's
    filters.mel defaults), (n_mels, 1 + n_fft//2) float32."""
    if fmax is None:
        fmax = sr / 2.0
    n_freq = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_pts = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin),
                                            _hz_to_mel_slaney(fmax),
                                            n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)   # a normal tensor: training's mel saves it
def _mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float,
               fmax: float | None, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(device)


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x, clip_val) · C), the reference's spectral_normalize."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sampling_rate: int = 22050
    n_fft: int = 1024
    num_mels: int = 80
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float | None = 8000.0
    pad: int | None = None  # None -> (n_fft - hop)//2

    @property
    def padding(self) -> int:
        return (self.n_fft - self.hop_size) // 2 if self.pad is None else self.pad

    def num_frames(self, num_samples: int) -> int:
        return 1 + (num_samples + 2 * self.padding - self.n_fft) // self.hop_size


VOCODER_MEL_22K = MelConfig()
VOCODER_MEL_22K_FULLBAND = MelConfig(fmax=None)
HUBERT_ALIGNED_MEL_22K = MelConfig(hop_size=441, pad=312)
MODIFIED_MEL_22K = MelConfig(hop_size=441)
VOCODER_MEL_16K = MelConfig(sampling_rate=16000)


def mel_spectrogram(y: torch.Tensor,
                    cfg: MelConfig = VOCODER_MEL_22K) -> torch.Tensor:
    """Log mel spectrogram, y (B, T) or (T,) → (B, n_mels, frames) or
    (n_mels, frames): one GEMM for the DFT, one for the mel projection."""
    mag = stft_magnitude(y, n_fft=cfg.n_fft, hop=cfg.hop_size,
                         win_size=cfg.win_size, pad=cfg.padding)
    basis = _mel_basis(cfg.sampling_rate, cfg.n_fft, cfg.num_mels, cfg.fmin,
                       cfg.fmax, mag.device).to(mag.dtype)
    return dynamic_range_compression(basis @ mag)
