"""Objective evaluation metrics (host-side numpy): the port's own copy of
speech_inpainting_tpu/metrics/objective.py, which needs no JAX (the port
imports nothing of the JAX package).

Formulas matched to the reference Metrics class (I_ea/metrics.py:13-142 —
code new):
  - si_sdr: projection-based scale-invariant SDR (:127-142)
  - log_spectral_rmse / log_spectral_d2: mean-centered log-mel distances with
    the 20/ln(10) scaling (:44-62)
  - avg_cosine_sim: centroid-centered cosine similarity (:38-42)
  - wer / cer: word/char error rates via Levenshtein distance with the
    reference's text normalization (lowercase, strip punctuation, :28-35);
    the reference uses torchmetrics — same definition.
"""
from __future__ import annotations

import re
from typing import Sequence

import numpy as np


def si_sdr(estimate: np.ndarray, reference: np.ndarray) -> float:
    """Scale-invariant SDR in dB (reference sisdr formula)."""
    est = np.asarray(estimate, np.float64).reshape(-1)
    ref = np.asarray(reference, np.float64).reshape(-1)
    eps = np.finfo(np.float64).eps
    rss = ref @ ref
    a = (eps + ref @ est) / (rss + eps)
    e_true = a * ref
    e_res = est - e_true
    return float(10 * np.log10((eps + (e_true ** 2).sum())
                               / (eps + (e_res ** 2).sum())))


_LOG_SCALE = 20.0 / np.log(10.0)


def _center_time(x):
    return x - x.mean(axis=0, keepdims=True)


def log_spectral_d2(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """Per-frame log-spectral distance, averaged (avg_d2_dist). Inputs are
    (time, bins) log-mel matrices (the reference passes mel.T slices)."""
    a = _center_time(np.asarray(mel_a, np.float64))
    b = _center_time(np.asarray(mel_b, np.float64))
    dists = _LOG_SCALE * np.sqrt(np.mean((a - b) ** 2, axis=0))
    return float(dists.mean())


def log_spectral_rmse(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    a = _center_time(np.asarray(mel_a, np.float64))
    b = _center_time(np.asarray(mel_b, np.float64))
    return float(_LOG_SCALE * np.sqrt(np.mean((a - b) ** 2)))


def avg_cosine_sim(a: np.ndarray, b: np.ndarray, center: np.ndarray) -> float:
    """Mean cosine similarity of centered vectors along the last axis."""
    a = np.asarray(a, np.float64) - center
    b = np.asarray(b, np.float64) - center
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return float((num / np.maximum(den, 1e-12)).mean())


def normalize_text(text: str) -> str:
    """Reference preprocess_text: lowercase, strip punctuation/whitespace."""
    text = text.lower()
    text = re.sub(r"[^\w\s]", "", text)
    return text.strip()


def _edit_distance(ref: Sequence, hyp: Sequence) -> int:
    m, n = len(ref), len(hyp)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def wer(reference: str, hypothesis: str, *, normalize: bool = True) -> float:
    if normalize:
        reference, hypothesis = (normalize_text(reference),
                                 normalize_text(hypothesis))
    ref, hyp = reference.split(), hypothesis.split()
    return _edit_distance(ref, hyp) / max(len(ref), 1)


def cer(reference: str, hypothesis: str, *, normalize: bool = True) -> float:
    if normalize:
        reference, hypothesis = (normalize_text(reference),
                                 normalize_text(hypothesis))
    return _edit_distance(list(reference), list(hypothesis)) / \
        max(len(reference), 1)
