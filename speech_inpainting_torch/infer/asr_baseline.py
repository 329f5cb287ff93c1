"""ASR→zero-shot-TTS inpainting baseline (I_ea/predict_asr.py:64-265), the
counterpart of speech_inpainting_tpu/infer/asr_baseline.py.

Pipeline: transcribe the masked utterance (ASR), synthesize the transcript
with a zero-shot TTS conditioned on the speaker, then splice the synthetic
span covering the mask back into the original:

  1. energy-VAD pre/post-silence crop of BOTH signals, with the mask
     position shifted by the crop (predict_asr.py:134-165)
  2. MFCC (librosa htk) + DTW alignment original↔synthetic
     (predict_asr.py:173-189, hop 160 @16 kHz)
  3. map the mask span through the warping path → the matching synthetic
     span (predict_asr.py:193-198)
  4. WSOLA time-stretch that span to the mask duration, with the 1.2×
     safety margin then trim (predict_asr.py:202-206)
  5. 10 ms linear-crossfade paste into the mask (predict_asr.py:211-231)

External models are pluggable (nothing is downloaded): `asr` is any
callable wav→text (e.g. metrics.asr.WhisperScorer.transcribe when a local
HF cache exists); `tts` is any callable (text, speaker_wav)→wav, e.g. a
recorded utterance for testing, or `UnitResynthTTS` over the port's
`IdaInpainter`, whose vocoder calls run on its device (K2 on the card). The
DSP chain itself (ops/dsp.py) is host numpy, from scratch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from ..ops.dsp import (crossfade_paste, dtw, energy_vad, map_time, mfcc,
                       speech_bounds, wsola)


@dataclasses.dataclass(frozen=True)
class ASRBaselineConfig:
    sr: int = 16000                 # audio_sr (predict_asr.py:39)
    hop: int = 160                  # DTW frontend hop (predict_asr.py:41)
    crossfade_s: float = 0.01       # predict_asr.py:57
    safety: float = 1.2             # WSOLA safe margin (predict_asr.py:202)
    crop_silence: bool = True       # step_crop_audio (predict_asr.py:62)


def asr_tts_inpaint(y_masked: np.ndarray, y_synth: np.ndarray,
                    mask_pos_s: tuple, cfg: ASRBaselineConfig = ASRBaselineConfig()
                    ) -> Dict[str, np.ndarray]:
    """Splice `y_synth` (the TTS rendering of the utterance's transcript)
    into `y_masked` over the mask [mask_pos_s[0], mask_pos_s[1]) seconds.

    Returns the baseline's artifact set: inpainted (cropped grid),
    inpainted_with_silence (original grid), the stretched patch, and the
    DTW-mapped synthetic span (seconds).
    """
    sr = cfg.sr
    y_orig = np.asarray(y_masked, np.float32)
    y_synth = np.asarray(y_synth, np.float32)
    mask = np.asarray(mask_pos_s, np.float64)

    first = last = None
    if cfg.crop_silence:
        va = energy_vad(y_orig, sr)
        first, last = speech_bounds(va, sr)
        if last > first:
            y_orig_full = y_orig.copy()
            y_orig = y_orig[first:last]
            # clamp: a VAD crop deeper than the mask edge would otherwise
            # produce a negative start / past-the-end stop downstream
            mask = np.clip(mask - first / sr, 0.0, len(y_orig) / sr)
        else:
            y_orig_full, first, last = y_orig.copy(), 0, len(y_orig)
        va_s = energy_vad(y_synth, sr)
        fs, ls = speech_bounds(va_s, sr)
        if ls > fs:
            y_synth = y_synth[fs:ls]
    else:
        y_orig_full, first, last = y_orig.copy(), 0, len(y_orig)

    if mask[1] <= mask[0]:
        # mask lies entirely outside the VAD-cropped speech region (e.g. in
        # the trailing silence): nothing to inpaint on the cropped grid
        return dict(inpainted=y_orig, inpainted_with_silence=y_orig_full,
                    patch=np.zeros(0, np.float32),
                    target_span_s=np.zeros(2))

    S_orig = mfcc(y_orig, sr, hop=cfg.hop)
    S_synth = mfcc(y_synth, sr, hop=cfg.hop)
    _, path = dtw(S_orig, S_synth)

    target = (map_time(path, mask[0], cfg.hop, sr),
              map_time(path, mask[1], cfg.hop, sr))
    span = y_synth[int(target[0] * sr):int(target[1] * sr)]
    mask_samples = int((mask[1] - mask[0]) * sr)
    if len(span) < 2:                      # degenerate mapping
        span = np.zeros(max(2, mask_samples), np.float32)
    # alpha derives from the GUARDED span (a near-zero DTW span previously
    # produced alpha up to ~1e6 and a multi-GB wsola allocation); the
    # [:mask_samples] trim makes any alpha beyond safety*need wasted work
    alpha = min(mask_samples / max(len(span), 2), 1e4) * cfg.safety
    stretched = wsola(span, alpha)[:mask_samples]

    start, end = (mask * sr).astype(int)
    inpainted = crossfade_paste(y_orig, stretched, start, end, sr,
                                cfg.crossfade_s)

    with_silence = y_orig_full.copy()
    with_silence[first:first + len(inpainted)] = inpainted[:len(with_silence)
                                                           - first]
    return dict(inpainted=inpainted, inpainted_with_silence=with_silence,
                patch=stretched.astype(np.float32),
                target_span_s=np.asarray(target))


def asr_tts_baseline(y_masked: np.ndarray, mask_pos_s: tuple, *,
                     asr: Optional[Callable] = None,
                     tts: Optional[Callable] = None,
                     transcript: Optional[str] = None,
                     y_synth: Optional[np.ndarray] = None,
                     speaker_wav: Optional[np.ndarray] = None,
                     cfg: ASRBaselineConfig = ASRBaselineConfig()) -> Dict:
    """Full baseline with pluggable ASR/TTS (predict_asr.py step_asr /
    step_tts switches): text comes from `asr(y_masked)` unless `transcript`
    is given; audio from `tts(text, speaker_wav)` unless `y_synth` is given.
    """
    if y_synth is None:
        if transcript is None:
            if asr is None:
                raise ValueError("need y_synth, transcript, or an asr fn")
            transcript = asr(y_masked)
        if tts is None:
            raise ValueError("need y_synth or a tts fn")
        y_synth = tts(transcript, speaker_wav
                      if speaker_wav is not None else y_masked)
    out = asr_tts_inpaint(y_masked, y_synth, mask_pos_s, cfg)
    out["transcript"] = transcript
    return out


class UnitResynthTTS:
    """In-house TTS leg for the baseline: render the target text from a
    DONOR recording of that text through the I_da unit stack (HuBERT units
    + f0 → CodeGenerator waveform).

    The reference's TTS leg is an external zero-shot model (YourTTS,
    predict_asr.py:44-52) that speaks the ASR transcript in the target
    voice; no such model is downloaded here, so "text" enters as
    a donor recording of the same words — the informed-protocol analogue
    (I_da/scripts/inpainting.py:209-214 conditions on clean-wav codes the
    same way) — and the speaker-conditioned unit-to-wave is our own
    CodeGenerator. The rendering is acoustically independent of the donor
    waveform (vocoder-synthesized from discrete units), so the downstream
    VAD→DTW→WSOLA→paste chain is exercised for real.

    Matches the `tts(text, speaker_wav) -> wav` slot of asr_tts_baseline:
    pass the donor recording as `transcript`/text. Speaker precedence:
    a fixed constructor `emb` wins; otherwise `speaker_wav` is embedded
    per call when an `embedder` was supplied; otherwise the CodeGenerator
    runs with its default/`spkr` conditioning.
    """

    def __init__(self, ida_inpainter, *, emb=None, spkr=None, embedder=None):
        """emb/spkr: fixed speaker conditioning forwarded to the
        CodeGenerator. embedder: optional `embed(wav, sr) -> d-vector`
        (data.code_dataset.torchscript_embedder or mel_stats_embedder) used
        to derive `emb` from the per-call speaker_wav when no fixed emb is
        given — the reference conditions its TTS on speaker wavs the same
        way (predict_asr.py:44-52)."""
        self._inp = ida_inpainter
        self._emb = emb
        self._spkr = spkr
        self._embedder = embedder

    def __call__(self, donor_wav, speaker_wav=None) -> np.ndarray:
        """The rendering as a float32 host array (16 kHz)."""
        emb = self._emb
        if emb is None and speaker_wav is not None and \
                self._embedder is not None:
            emb = self._embedder(np.asarray(speaker_wav, np.float32), 16000)
        out = self._inp(np.asarray(donor_wav, np.float32), mask_size=0,
                        emb=emb, spkr=self._spkr)
        return out["audio_gen"].cpu().numpy()
