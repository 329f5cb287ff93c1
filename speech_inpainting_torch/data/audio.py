"""Host-side wav I/O, resampling, trimming and padding with numpy and
scipy: the port's own copy of speech_inpainting_tpu/data/audio.py (that
module needs no JAX, but the port imports nothing of the JAX package).
  - load_wav → float32 mono in [-1, 1] (int16 / 32768, the reference's
    convention), resampled on request;
  - save_wav writes int16 at ±(32768 − 1), clipping to [-1, 1];
  - resample is polyphase (scipy's resample_poly), e.g. 22050 → 16000;
  - trim_silence: librosa.effects.trim semantics (top_db against the
    largest frame RMS, frame 2048 / hop 512; I_da/scripts/preprocess.py:44);
  - pad_to_multiple: zero-pad the tail to a multiple of 1280 samples
    (preprocess.py:30-50);
  - load_flac → the repository's native FLAC decoder (native/speechio.cc,
    through data/native.py) for VCTK's flac corpus (preprocessing.py:
    379-390); there is no libsndfile.
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


def load_flac(path, target_sr: Optional[int] = None
              ) -> Tuple[np.ndarray, int]:
    """Decode FLAC with the native decoder → (float32 mono, sr), built on
    first use; resampled (by the native polyphase resampler) if target_sr
    is given."""
    from . import native
    if not native.available():
        raise RuntimeError(
            "FLAC decoding needs the native library; `make -C native` "
            "failed or gcc is unavailable")
    return native.load_wav(path, target_sr)


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


def _frame_rms(wav: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(wav) - frame)) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    idx = np.minimum(idx, len(wav) - 1)
    return np.sqrt(np.mean(np.square(wav[idx]), axis=1))


def trim_silence(wav: np.ndarray, top_db: float = 20.0, frame: int = 2048,
                 hop: int = 512) -> np.ndarray:
    """librosa.effects.trim semantics: strip leading/trailing frames more
    than top_db below the maximum RMS."""
    if len(wav) == 0:
        return wav
    rms = _frame_rms(wav, frame, hop)
    ref = rms.max()
    if ref <= 0:
        return wav
    db = 20.0 * np.log10(np.maximum(rms / ref, 1e-10))
    keep = np.nonzero(db > -top_db)[0]
    if len(keep) == 0:
        return wav[:0]
    start = int(keep[0]) * hop
    end = min(len(wav), int(keep[-1]) * hop + frame)
    return wav[start:end]


def pad_to_multiple(wav: np.ndarray, multiple: int = 1280) -> np.ndarray:
    """Zero-pad the tail so len(wav) % multiple == 0."""
    pad = (-len(wav)) % multiple
    return np.pad(wav, (0, pad)) if pad else wav


def peak_normalize(wav: np.ndarray, level: float = 0.95) -> np.ndarray:
    """Scale to a peak of `level`; silence is returned as it is."""
    peak = np.abs(wav).max()
    return wav * (level / peak) if peak > 0 else wav
