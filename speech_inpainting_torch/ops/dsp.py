"""Host-side DSP for the ASR→TTS inpainting baseline, from scratch: the
port's own copy of speech_inpainting_tpu/ops/dsp.py (numpy and scipy; the
mel filterbank is the port's ops/mel.py one, HTK scale with the slaney
norm forced).

The reference baseline (I_ea/predict_asr.py:64-265) leans on librosa
(stft/mfcc/dtw), pytsmod (WSOLA), and the `vad` package (EnergyVAD) — none of
which this package depends on. This module implements the needed behavior:

  - `energy_vad`: per-frame energy voice-activity detection
    (EnergyVAD defaults: 25 ms frames / 20 ms shift; predict_asr.py:66,136)
  - `stft_mag` / `melspectrogram` / `mfcc`: librosa-compatible MFCCs
    (librosa.feature.mfcc htk=True path used at predict_asr.py:175,180:
    n_fft 2048, hop 160, power mel n_mels=128 htk, power_to_db top_db 80,
    DCT-II ortho, n_mfcc 20)
  - `dtw`: dynamic time warping with librosa.sequence.dtw semantics for the
    baseline's step set {(1,1),(2,1),(1,2)} + backtracked path
    (predict_asr.py:185-189)
  - `wsola`: waveform similarity overlap-add time stretching (pytsmod.wsola
    defaults: hann, win 1024, synthesis hop win/2, ±hop/2 tolerance;
    predict_asr.py:204-206)
  - `crossfade_paste`: linear-fade paste of a patch into a span
    (predict_asr.py:215-231, 10 ms crossfade)

Eval-only host path (SURVEY.md §7 "host-only deps ... keep off the
accelerator path"); everything is plain numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


# --------------------------------------------------------------------- VAD
def energy_vad(y: np.ndarray, sr: int = 16000, *,
               frame_ms: float = 25.0, shift_ms: float = 20.0,
               energy_threshold: float = 0.05,
               pre_emphasis: float = 0.95) -> np.ndarray:
    """Binary voice activity per `shift_ms` frame (EnergyVAD semantics:
    pre-emphasized frame energy vs a fixed threshold)."""
    flen = int(sr * frame_ms / 1000)
    hop = int(sr * shift_ms / 1000)
    if len(y) < flen:
        return np.zeros(0, np.int32)
    emph = np.concatenate([y[:1], y[1:] - pre_emphasis * y[:-1]])
    n = 1 + (len(emph) - flen) // hop
    idx = np.arange(flen)[None, :] + hop * np.arange(n)[:, None]
    energy = np.sum(emph[idx] ** 2, axis=1)
    return (energy > energy_threshold).astype(np.int32)


def speech_bounds(activity: np.ndarray, sr: int = 16000,
                  shift_ms: float = 20.0) -> Tuple[int, int]:
    """(first_sample, last_sample) of speech, exactly as the baseline derives
    them (predict_asr.py:136-146): first = argmax(activity); last = final
    1→0 transition (or the end if none)."""
    if len(activity) == 0 or not activity.any():
        return 0, 0
    first_frame = int(np.argmax(activity))
    trans = np.where((activity[:-1] == 1) & (activity[1:] == 0))[0]
    last_frame = int(trans[-1]) if len(trans) else len(activity)
    hop = shift_ms / 1000.0
    return int(first_frame * hop * sr), int(last_frame * hop * sr)


# -------------------------------------------------------------------- MFCC
def stft_mag(y: np.ndarray, n_fft: int = 2048, hop: int = 512,
             win_length: int | None = None, *, power: float = 1.0
             ) -> np.ndarray:
    """Centered Hann STFT magnitude^power, librosa conventions
    (reflect pad n_fft//2, window zero-padded to n_fft)."""
    win_length = n_fft if win_length is None else win_length
    w = np.hanning(win_length + 1)[:-1]
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = np.pad(w, (pad, n_fft - win_length - pad))
    y = np.pad(y, (n_fft // 2, n_fft // 2), mode="reflect")
    n = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    spec = np.fft.rfft(y[idx] * w, axis=1)
    return (np.abs(spec) ** power).T                   # (1+n_fft/2, frames)


def melspectrogram(y: np.ndarray, sr: int, n_fft: int = 2048,
                   hop: int = 512, n_mels: int = 128, *, htk: bool = True,
                   fmin: float = 0.0, fmax: float | None = None
                   ) -> np.ndarray:
    from .mel import mel_filterbank
    fb = np.asarray(mel_filterbank(sr, n_fft, n_mels, fmin,
                                   fmax if fmax is not None else sr / 2,
                                   htk=htk, norm="slaney"))
    return fb @ stft_mag(y, n_fft, hop, power=2.0)


def power_to_db(S: np.ndarray, amin: float = 1e-10, top_db: float = 80.0
                ) -> np.ndarray:
    db = 10.0 * np.log10(np.maximum(amin, S))
    return np.maximum(db, db.max() - top_db)


def mfcc(y: np.ndarray, sr: int, *, n_mfcc: int = 20, n_fft: int = 2048,
         hop: int = 512, n_mels: int = 128, htk: bool = True) -> np.ndarray:
    """librosa.feature.mfcc(htk=True): DCT-II (ortho) of the dB power mel.
    Returns (n_mfcc, frames)."""
    from scipy.fft import dct
    db = power_to_db(melspectrogram(y, sr, n_fft, hop, n_mels, htk=htk))
    return dct(db, type=2, axis=0, norm="ortho")[:n_mfcc]


# --------------------------------------------------------------------- DTW
def dtw(X: np.ndarray, Y: np.ndarray,
        step_sizes: Tuple[Tuple[int, int], ...] = ((1, 1), (2, 1), (1, 2)),
        weights: Tuple[float, ...] | None = None
        ) -> Tuple[np.ndarray, np.ndarray]:
    """DTW of feature matrices X (d, N) vs Y (d, M), euclidean local cost,
    full alignment (subseq=False). Returns (D, path) with the path as an
    (L, 2) array of (n, m) pairs from (N-1, M-1) down to (0, 0) — the
    librosa.sequence.dtw contract the baseline consumes (predict_asr.py:189).
    """
    C = np.sqrt(np.maximum(
        (X * X).sum(0)[:, None] - 2.0 * (X.T @ Y) + (Y * Y).sum(0)[None, :],
        0.0))
    N, M = C.shape
    if weights is None:
        weights = (1.0,) * len(step_sizes)
    D = np.full((N, M), np.inf)
    steps = np.full((N, M), -1, np.int32)
    D[0, 0] = C[0, 0]
    if all(di >= 1 for di, _ in step_sizes):
        # every step advances i, so row i depends only on earlier rows —
        # vectorize over j (the per-cell Python loop was ~100x slower at
        # the baseline's N=M~1000)
        K = len(step_sizes)
        cand = np.empty((K, M))
        for i in range(1, N):
            cand.fill(np.inf)
            for k, ((di, dj), w) in enumerate(zip(step_sizes, weights)):
                if i - di >= 0 and dj < M:
                    cand[k, dj:] = D[i - di, :M - dj] + w * C[i, dj:]
            steps[i] = np.argmin(cand, axis=0)
            D[i] = cand[steps[i], np.arange(M)]
        steps[D == np.inf] = -1
    else:
        for i in range(N):
            for j in range(M):
                if i == 0 and j == 0:
                    continue
                best, arg = np.inf, -1
                for k, ((di, dj), w) in enumerate(zip(step_sizes, weights)):
                    pi, pj = i - di, j - dj
                    if (pi >= 0 and pj >= 0
                            and D[pi, pj] + w * C[i, j] < best):
                        best, arg = D[pi, pj] + w * C[i, j], k
                D[i, j] = best
                steps[i, j] = arg
    if not np.isfinite(D[N - 1, M - 1]):
        # with steps {(1,1),(2,1),(1,2)} the corner is unreachable iff the
        # lengths are more than 2x apart (librosa's dtw has the same
        # constraint); sequences at the exact 2x boundary also fail
        raise ValueError(
            f"(N-1, M-1)=({N - 1}, {M - 1}) unreachable with steps "
            f"{step_sizes}")
    # backtrack
    path = [(N - 1, M - 1)]
    i, j = N - 1, M - 1
    while (i, j) != (0, 0):
        di, dj = step_sizes[steps[i, j]]
        i, j = i - di, j - dj
        path.append((i, j))
    return D, np.asarray(path, np.int64)


def map_time(path: np.ndarray, t_src: float, hop: int, sr: int) -> float:
    """Map a source-side time to the aligned target-side time through a DTW
    path (the baseline's nearest-frame lookup, predict_asr.py:193)."""
    times = path * hop / sr                           # (L, 2) seconds
    k = int(np.abs(times[:, 0] - t_src).argmin())
    return float(times[k, 1])


# ------------------------------------------------------------------- WSOLA
def wsola(x: np.ndarray, alpha: float, *, win_size: int = 1024,
          tolerance: int | None = None) -> np.ndarray:
    """Time-stretch x by factor alpha (>1 = longer), WSOLA.

    pytsmod-style parameterization: hann window, synthesis hop win/2,
    analysis hop syn_hop/alpha, candidate search within ±tolerance
    (default syn_hop/2) maximizing cross-correlation with the natural
    continuation of the previous synthesis frame.
    """
    if not alpha > 0:
        raise ValueError(f"wsola stretch factor must be positive: {alpha}")
    syn_hop = win_size // 2
    if tolerance is None:
        tolerance = syn_hop // 2
    w = np.hanning(win_size + 1)[:-1]
    out_len = int(round(len(x) * alpha))
    n_frames = max(1, out_len // syn_hop)
    # analysis positions for each synthesis frame
    ana_pos = np.round(np.arange(n_frames) * syn_hop / alpha).astype(int)
    # right pad must cover the deepest read: base(≤len+tol) + shift(≤tol)
    # + syn_hop + win_size (the natural-continuation tail) — under-padding
    # crashed large stretch factors (alpha ≳ 2) with truncated slices
    xp = np.pad(x, (tolerance, win_size + 2 * tolerance + syn_hop))
    out = np.zeros(out_len + win_size)
    norm = np.zeros_like(out)

    prev_tail = None                      # natural continuation reference
    for f in range(n_frames):
        base = ana_pos[f] + tolerance     # index into xp
        if prev_tail is None or tolerance == 0:
            shift = 0
        else:
            # pick the candidate frame best matching the previous frame's
            # natural continuation (maximum cross-correlation)
            best, shift = -np.inf, 0
            seg = xp[base - tolerance: base + tolerance + win_size]
            for s in range(-tolerance, tolerance + 1):
                cand = seg[s + tolerance: s + tolerance + win_size]
                score = float(cand @ prev_tail)
                if score > best:
                    best, shift = score, s
        frame = xp[base + shift: base + shift + win_size]
        pos = f * syn_hop
        out[pos:pos + win_size] += frame * w
        norm[pos:pos + win_size] += w
        # the natural continuation: the samples syn_hop ahead of the chosen
        # analysis frame (what would follow if playback continued unwarped)
        prev_tail = xp[base + shift + syn_hop:
                       base + shift + syn_hop + win_size]
    out = out[:out_len] / np.maximum(norm[:out_len], 1e-8)
    return out


# --------------------------------------------------------------- crossfade
def crossfade_paste(y: np.ndarray, patch: np.ndarray, start: int, end: int,
                    sr: int, crossfade_s: float = 0.01) -> np.ndarray:
    """Paste `patch` into y[start:...] with linear crossfades of
    `crossfade_s` centered on both mask edges (predict_asr.py:215-231)."""
    y = y.copy().astype(np.float64)
    blank = np.zeros_like(y)
    start = int(np.clip(start, 0, len(y)))   # defensive: a negative start
    end = int(np.clip(end, 0, len(y)))       # indexes from the END in numpy
    blank[start:start + len(patch)] = patch[:max(0, len(y) - start)]
    c = int(crossfade_s * sr)
    # fades are clipped to the signal, not skipped: a mask edge within
    # crossfade/2 of either boundary previously broadcast-crashed
    for lo, hi, y0, y1 in ((start - c // 2, start + c // 2, 1.0, 0.0),
                           (end - c // 2, end + c // 2, 0.0, 1.0)):
        n = hi - lo
        if c <= 0 or n <= 0:
            continue
        ramp = np.linspace(y0, y1, n)
        lo2, hi2 = max(lo, 0), min(hi, len(y))
        if hi2 <= lo2:
            continue
        y[lo2:hi2] *= ramp[lo2 - lo:hi2 - lo]
        blank[lo2:hi2] *= 1.0 - ramp[lo2 - lo:hi2 - lo]
    return (y + blank).astype(np.float32)
