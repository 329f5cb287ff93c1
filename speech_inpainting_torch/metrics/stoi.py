"""Short-Time Objective Intelligibility (STOI / extended STOI), from scratch:
the port's own copy of speech_inpainting_tpu/metrics/stoi.py (numpy).

The reference evaluates with pystoi's `stoi(..., extended=True)`
(I_ea/metrics.py:121-122). pystoi isn't available in this environment, so
this is a self-contained numpy implementation of the published algorithms:
  - STOI  (Taal et al., 2011): clipped band-envelope correlations
  - ESTOI (Jensen & Taal, 2016): row+column-normalized segment correlations
with the standard constants: 10 kHz analysis rate, 256-sample Hann frames
(hop 128, 512-pt FFT), 15 third-octave bands from 150 Hz, 40 dB silent-frame
removal, 384 ms (N=30 frame) segments, clipping at −15 dB SDR.
"""
from __future__ import annotations

import numpy as np

FS = 10000
N_FRAME = 256
HOP = 128
N_FFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30          # frames per segment (384 ms)
DYN_RANGE = 40.0    # silent-frame removal range (dB)
BETA_DB = -15.0     # clipping SDR bound
EPS = np.finfo(np.float64).eps


def _resample(x: np.ndarray, sr: int) -> np.ndarray:
    if sr == FS:
        return np.asarray(x, np.float64)
    from scipy.signal import resample_poly
    from fractions import Fraction
    fr = Fraction(FS, sr).limit_denominator(10000)
    return resample_poly(np.asarray(x, np.float64), fr.numerator,
                         fr.denominator)


def _frames(x: np.ndarray) -> np.ndarray:
    n = 1 + max(0, (len(x) - N_FRAME)) // HOP
    idx = np.arange(N_FRAME)[None, :] + HOP * np.arange(n)[:, None]
    return x[idx]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    w = np.hanning(N_FRAME + 2)[1:-1]
    xf = _frames(x) * w
    yf = _frames(y) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + EPS)
    mask = energies > energies.max() - DYN_RANGE
    xf, yf = xf[mask], yf[mask]
    # overlap-add reconstruction
    n_out = (len(xf) - 1) * HOP + N_FRAME if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):
        xs[i * HOP:i * HOP + N_FRAME] += xf[i]
        ys[i * HOP:i * HOP + N_FRAME] += yf[i]
    return xs, ys


def _third_octave_matrix() -> np.ndarray:
    f = np.linspace(0, FS / 2, N_FFT // 2 + 1)
    k = np.arange(NUM_BANDS, dtype=np.float64)
    cf = MIN_FREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for b in range(NUM_BANDS):
        # snap band edges to the nearest FFT bins (pystoi/original MATLAB)
        lo_i = int(np.argmin((f - lo[b]) ** 2))
        hi_i = int(np.argmin((f - hi[b]) ** 2))
        obm[b, lo_i:hi_i] = 1.0
    return obm


def _band_envelopes(x: np.ndarray) -> np.ndarray:
    w = np.hanning(N_FRAME + 2)[1:-1]
    frames = _frames(x) * w
    spec = np.fft.rfft(frames, N_FFT, axis=1)
    power = np.abs(spec) ** 2
    return np.sqrt(_third_octave_matrix() @ power.T)   # (bands, frames)


def stoi(reference: np.ndarray, estimate: np.ndarray, sr: int,
         *, extended: bool = False) -> float:
    """STOI/ESTOI intelligibility of `estimate` given clean `reference`."""
    x = _resample(reference, sr)
    y = _resample(estimate, sr)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    if n < N_FRAME:
        raise ValueError("signal too short for STOI")
    x, y = _remove_silent_frames(x, y)
    if len(x) < N_FRAME:
        raise ValueError("signal too short (or fully silent) for STOI")
    X = _band_envelopes(x)
    Y = _band_envelopes(y)
    m = X.shape[1]
    if m < N_SEG:
        raise ValueError("fewer than 30 analysis frames after trimming")

    # sliding segments (n_seg_windows, bands, N_SEG)
    segs_x = np.stack([X[:, i:i + N_SEG] for i in range(m - N_SEG + 1)])
    segs_y = np.stack([Y[:, i:i + N_SEG] for i in range(m - N_SEG + 1)])

    if extended:
        def row_col_normalize(s):
            s = s - s.mean(axis=2, keepdims=True)
            s = s / (np.linalg.norm(s, axis=2, keepdims=True) + EPS)
            s = s - s.mean(axis=1, keepdims=True)
            s = s / (np.linalg.norm(s, axis=1, keepdims=True) + EPS)
            return s
        xn = row_col_normalize(segs_x)
        yn = row_col_normalize(segs_y)
        return float(np.sum(xn * yn) / (N_SEG * len(segs_x)))

    # classic STOI: scale + clip y segments to x, band-wise correlations
    norm_x = np.linalg.norm(segs_x, axis=2, keepdims=True)
    norm_y = np.linalg.norm(segs_y, axis=2, keepdims=True)
    y_scaled = segs_y * norm_x / (norm_y + EPS)
    clip = 10 ** (-BETA_DB / 20.0)
    y_clipped = np.minimum(y_scaled, segs_x * (1 + clip))
    xc = segs_x - segs_x.mean(axis=2, keepdims=True)
    yc = y_clipped - y_clipped.mean(axis=2, keepdims=True)
    num = np.sum(xc * yc, axis=2)
    den = np.linalg.norm(xc, axis=2) * np.linalg.norm(yc, axis=2) + EPS
    return float(np.mean(num / den))
