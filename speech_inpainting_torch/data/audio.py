"""Host-side wav I/O and resampling with numpy and scipy: the port's own
copy of speech_inpainting_tpu/data/audio.py's `load_wav`, `save_wav`,
`wav_info`, `resample` and `peak_normalize` (that module needs no JAX, but
the port imports nothing of the JAX package).
  - load_wav → float32 mono in [-1, 1] (int16 / 32768, the reference's
    convention), resampled on request;
  - save_wav writes int16 at ±(32768 − 1), clipping to [-1, 1];
  - resample is polyphase (scipy's resample_poly), e.g. 22050 → 16000.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

MAX_WAV_VALUE = 32768.0


def load_wav(path, target_sr: Optional[int] = None
             ) -> Tuple[np.ndarray, int]:
    """Read a wav → (float32 mono in [-1, 1], sr); resample if target_sr."""
    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / MAX_WAV_VALUE
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if target_sr is not None and target_sr != sr:
        wav = resample(wav, sr, target_sr)
        sr = target_sr
    return wav, sr


def save_wav(path, wav, sr: int) -> None:
    """Write a float waveform as int16 (the reference's MAX_WAV_VALUE
    convention); an int16 array is written as it is."""
    wav = np.asarray(wav)
    if wav.dtype != np.int16:
        wav = (np.clip(wav, -1.0, 1.0) * (MAX_WAV_VALUE - 1)).astype(np.int16)
    wavfile.write(str(path), sr, wav)


def wav_info(path) -> Tuple[int, int]:
    """(sample_rate, frames) without decoding the payload."""
    sr, data = wavfile.read(str(path), mmap=True)
    return sr, data.shape[0]


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (kaiser-windowed)."""
    if sr == target_sr:
        return wav
    frac = Fraction(target_sr, sr)
    return resample_poly(wav, frac.numerator, frac.denominator).astype(
        np.float32)


def peak_normalize(wav: np.ndarray, level: float = 0.95) -> np.ndarray:
    """Scale to a peak of `level`; silence is returned as it is."""
    peak = np.abs(wav).max()
    return wav * (level / peak) if peak > 0 else wav
