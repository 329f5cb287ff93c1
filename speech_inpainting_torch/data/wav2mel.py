"""wav2mel: the speaker-embedder (d-vector) mel frontend.

Counterpart of speech_inpainting_tpu/data/wav2mel.py, behaviour matched to
I_da/src/modules/wav2mel.py:7-162 with self-contained equivalents of its
torchaudio sox chain:
  - mono downmix and resampling to 16 kHz (sox `channels`/`rate`);
  - peak normalisation to −3 dB (sox `norm -3`);
  - removal of silent runs of ≥ 0.1 s below 1% of full scale throughout
    the file (sox `silence 1 0.1 1% -1 0.1 1%`);
  - log mel: 25 ms window / 10 ms hop, the HTK mel scale (torchaudio's
    defaults), f_min 50 Hz, 80 mels, the power spectrum, log(clamp 1e-9);
    returned as (time, n_mels), as the reference returns it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import full_f32, resolve_device
from ..ops.mel import mel_filterbank
from ..ops.stft import stft_magnitude
from .audio import resample


@dataclasses.dataclass(frozen=True)
class Wav2MelConfig:
    sample_rate: int = 16000
    norm_db: float = -3.0
    sil_threshold: float = 1.0     # percent of full scale
    sil_duration: float = 0.1      # seconds
    fft_window_ms: float = 25.0
    fft_hop_ms: float = 10.0
    f_min: float = 50.0
    n_mels: int = 80

    @property
    def n_fft(self) -> int:
        return int(self.sample_rate * self.fft_window_ms / 1000)

    @property
    def hop(self) -> int:
        return int(self.sample_rate * self.fft_hop_ms / 1000)


def norm_db(wav: np.ndarray, level_db: float) -> np.ndarray:
    peak = np.abs(wav).max()
    if peak <= 0:
        return wav
    return wav * (10.0 ** (level_db / 20.0) / peak)


def remove_silence(wav: np.ndarray, sr: int, *, threshold_pct: float = 1.0,
                   min_duration: float = 0.1) -> np.ndarray:
    """Drop runs of ≥ min_duration seconds whose amplitude stays below
    threshold_pct% of full scale (sox `silence ... -1 ...` semantics)."""
    hop = max(1, int(sr * 0.01))
    n = len(wav) // hop
    if n == 0:
        return wav
    frames = wav[:n * hop].reshape(n, hop)
    quiet = np.abs(frames).max(axis=1) < threshold_pct / 100.0
    min_frames = max(1, int(min_duration / 0.01))
    keep = np.ones(n, bool)
    i = 0
    while i < n:
        if quiet[i]:
            j = i
            while j < n and quiet[j]:
                j += 1
            if j - i >= min_frames:
                keep[i:j] = False
            i = j
        else:
            i += 1
    out = frames[keep].reshape(-1)
    tail = wav[n * hop:]
    if len(tail) and np.abs(tail).max() >= threshold_pct / 100.0:
        out = np.concatenate([out, tail])
    return out


class Wav2Mel:
    """(wav, sr) → (time, n_mels) float32 log-mel, reference conventions;
    the STFT runs on `device` (the CUDA card unless "cpu" is asked for)."""

    def __init__(self, cfg: Wav2MelConfig = Wav2MelConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                     cfg.f_min, None, htk=True)

    def __call__(self, wav: np.ndarray, sr: int) -> np.ndarray:
        cfg = self.cfg
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 2:                      # (channels, T) → mono
            wav = wav.mean(axis=0)
        if sr != cfg.sample_rate:
            wav = resample(wav, sr, cfg.sample_rate)
        wav = norm_db(wav, cfg.norm_db)
        wav = remove_silence(wav, cfg.sample_rate,
                             threshold_pct=cfg.sil_threshold,
                             min_duration=cfg.sil_duration)
        # torchaudio MelSpectrogram: center=True (reflect), power=2
        x = torch.as_tensor(wav, device=self.device)
        with torch.inference_mode(), full_f32():
            mag = stft_magnitude(x[None], n_fft=cfg.n_fft, hop=cfg.hop,
                                 win_size=cfg.n_fft, pad=cfg.n_fft // 2)[0]
        power = mag.cpu().numpy() ** 2
        mel = self._basis @ power
        return np.log(np.clip(mel.T, 1e-9, None)).astype(np.float32)
