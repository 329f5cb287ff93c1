"""Unit error rate — the offline intelligibility proxy: the port's own copy
of speech_inpainting_tpu/metrics/units.py (numpy; `UnitScorer` resamples
through the port's data/audio.py).

The reference's intelligibility metric is Whisper-small WER/CER
(I_ea/metrics.py:80-119). Where no ASR model is cached locally
that scorer gates off, so this module provides the textless-NLP stand-in:
**UER**, the Levenshtein edit distance between the run-length-collapsed
discrete-unit transcriptions of the reference and degraded waveforms,
normalized by the reference transcription length. Units are the same
HuBERT-feature k-means ids the I_da pipeline trains on
(I_da/scripts/quantize_with_kmeans.py:70-120), so the metric measures
exactly what the unit-resynthesis stack treats as content: a deletion,
insertion, or substitution of phonetic content in the degraded audio shows
up as unit edits the way word edits show up in WER.

Pure numpy; the encoder is injected as a callable so any unit system
(fine-tuned mel centroids or frozen-feature k-means) can score.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def collapse_runs(units: Sequence[int]) -> np.ndarray:
    """Run-length dedupe: [5,5,5,9,9,5] -> [5,9,5] (GSLM unit convention —
    repeated units encode duration, not content)."""
    u = np.asarray(units)
    if u.size == 0:
        return u
    keep = np.ones(u.shape[0], bool)
    keep[1:] = u[1:] != u[:-1]
    return u[keep]


def levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    """Edit distance (unit insert/delete/substitute all cost 1), O(|a|·|b|)
    with a two-row numpy DP (vectorized over the inner axis)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.size == 0:
        return int(b.size)
    if b.size == 0:
        return int(a.size)
    prev = np.arange(b.size + 1)
    for i in range(1, a.size + 1):
        cur = np.empty(b.size + 1, prev.dtype)
        cur[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        dele = prev[1:] + 1
        # insertion needs the running minimum along the row: fold it in with
        # a cumulative min over (candidate - index), the standard trick to
        # keep the row update vectorized
        best = np.minimum(sub, dele)
        run = np.minimum.accumulate(best - np.arange(1, b.size + 1))
        cur[1:] = np.minimum(best, run + np.arange(2, b.size + 2) - 1)
        prev = cur
    return int(prev[-1])


def unit_error_rate(ref_units: Sequence[int], hyp_units: Sequence[int],
                    *, collapse: bool = True) -> float:
    """Levenshtein(ref, hyp) / len(ref) over (optionally collapsed) units."""
    r = collapse_runs(ref_units) if collapse else np.asarray(ref_units)
    h = collapse_runs(hyp_units) if collapse else np.asarray(hyp_units)
    if r.size == 0:
        return 0.0 if h.size == 0 else float(h.size)
    return levenshtein(r, h) / float(r.size)


def masked_unit_edits(ref_units: Sequence[int], hyp_units: Sequence[int],
                      span: tuple, *, margin: int = 2,
                      collapse: bool = True) -> tuple:
    """Raw (edit count, collapsed ref length) over the ``span`` window
    (start, end) — frame indices, end exclusive — plus ``margin`` context
    frames on each side. The un-normalized form of masked UER: at short
    spans the collapsed reference can be 1-3 units, so the RATE is
    tiny-denominator noise (40 ms spans have scored 1.44) while the
    edit COUNT stays well-behaved."""
    s, e = span
    lo = max(int(s) - margin, 0)
    hi = int(e) + margin
    r = np.asarray(ref_units)[lo:hi]
    h = np.asarray(hyp_units)[lo:hi]
    if collapse:
        r, h = collapse_runs(r), collapse_runs(h)
    return int(levenshtein(r, h)), int(r.size)


def masked_unit_error_rate(ref_units: Sequence[int],
                           hyp_units: Sequence[int],
                           span: tuple, *, margin: int = 2,
                           collapse: bool = True,
                           den_floor: int = 0) -> float:
    """UER restricted to the unit frames inside ``span`` (start, end)
    — frame indices, end exclusive — plus ``margin`` context frames.

    The discriminative form of UER for whole-waveform resynthesis systems
    (the I_da stack): full-sequence UER saturates there because re-encoding
    a resynthesized waveform changes units almost everywhere, masked or not
    (0.84-0.93 on every I_da row of a sweep), so it cannot catch an
    inpainting regression. Restricting the comparison to the masked span —
    mirroring the eval harness's mel_l1_mask decomposition — scores only
    the content the inpainter actually generated. Both unit sequences must
    share the frame grid (both waveforms are time-aligned renders of the
    same utterance; HuBERT and the hop-441 mel system are both 50 fps).

    ``den_floor`` floors the denominator (the collapsed reference length):
    at 40-80 ms spans the window collapses to 1-3 units, which turned the
    rate into tiny-denominator noise (>1.0, non-monotone in the mask
    length). Units last ~2 frames on speech, so UnitScorer passes
    (window frames)/2 as the floor, bounding short-span rates without
    touching long spans (where collapsed length already exceeds the floor).
    """
    edits, ref_len = masked_unit_edits(ref_units, hyp_units, span,
                                       margin=margin, collapse=collapse)
    if ref_len == 0 and edits == 0 and den_floor == 0:
        return 0.0
    return edits / float(max(ref_len, den_floor, 1))


class UnitScorer:
    """UER scorer around an injected `encode(wav: np.ndarray) -> unit ids`.

    `uer(ref, est, sr)` resamples both waveforms to the encoder's sample
    rate, encodes, and returns the unit error rate — the role
    WhisperScorer.wer_cer plays when an ASR cache exists
    (I_ea/metrics.py:80-119). `rate` is the rate `encode` expects: 16 kHz
    for HuBERT-unit systems, 22.05 kHz for the I_ea mel-centroid system.
    """

    def __init__(self, encode: Callable[[np.ndarray], np.ndarray],
                 rate: int = 16000):
        self._encode = encode
        self.rate = rate

    def units(self, wav: np.ndarray, sr: int) -> np.ndarray:
        from ..data.audio import resample
        w = np.asarray(wav, np.float32)
        if sr != self.rate:
            w = resample(w, sr, self.rate)
        return np.asarray(self._encode(w))

    def uer(self, ref: np.ndarray, est: np.ndarray, sr: int,
            *, est_sr: int | None = None) -> float:
        return unit_error_rate(self.units(ref, sr),
                               self.units(est, est_sr or sr))

    def masked_uer(self, ref: np.ndarray, est: np.ndarray, sr: int,
                   span_sec: tuple, *, frame_rate: float = 50.0,
                   margin: int = 2, est_sr: int | None = None) -> float:
        """masked_unit_error_rate over the span given in SECONDS
        (``frame_rate`` converts to unit frames; 50 fps for both the
        HuBERT-unit and hop-441 mel-centroid systems). The denominator is
        floored at half the window length in frames (~one unit per 2
        frames on speech) so 40-80 ms spans don't report tiny-denominator
        noise; pair with masked_uer_edits for the raw
        counts."""
        s, e = span_sec
        fspan = (round(s * frame_rate), round(e * frame_rate))
        floor = max((fspan[1] - fspan[0] + 2 * margin) // 2, 1)
        return masked_unit_error_rate(
            self.units(ref, sr), self.units(est, est_sr or sr),
            fspan, margin=margin, den_floor=floor)

    def masked_uer_edits(self, ref: np.ndarray, est: np.ndarray, sr: int,
                         span_sec: tuple, *, frame_rate: float = 50.0,
                         margin: int = 2,
                         est_sr: int | None = None) -> tuple:
        """Raw (edits, collapsed ref units) over the seconds span — the
        variance-free companion column to masked_uer."""
        s, e = span_sec
        return masked_unit_edits(
            self.units(ref, sr), self.units(est, est_sr or sr),
            (round(s * frame_rate), round(e * frame_rate)), margin=margin)
