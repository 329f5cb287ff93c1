"""PESQ-style perceptual speech quality (ITU-T P.862 family), from scratch:
the port's own copy of speech_inpainting_tpu/metrics/pesq.py (numpy).

The reference evaluates with the `pesq` package (I_ea/metrics.py:124-125),
which is unavailable in this environment. This module implements the P.862
processing structure in numpy — level alignment, coarse time alignment,
Bark-band power warping, Zwicker loudness, per-frame symmetric and
asymmetric disturbances with masking dead-zones, L6/L2 time aggregation, and
the P.862.2 wideband MOS-LQO sigmoid mapping.

Caveat (stated in README): this is a faithful-structure implementation, NOT
a certified bit-exact P.862; use it for relative comparisons, and the
certified `pesq` binary for standardized reporting when available.

Validity envelope (measured on LJ001-0001 @16 kHz, pinned by
tests/test_metrics.py::test_pesq_degradation_families; all families within
±0.35 MOS of the published P.862 operating points after the r3 soft-knee
calibration of the aggregated disturbance — see D_KNEE below):
  - identity / pure gain: 4.64 (WB ceiling)
  - constant delay ±50 ms: ≥ 4.56 — the coarse envelope-correlation
    alignment (below) compensates constant delays like certified PESQ's
    time-alignment stage; time-VARYING delay within an utterance is NOT
    handled (certified PESQ splits utterances and re-aligns; this
    implementation estimates one global delay)
  - amplitude clipping at {0.5, 0.25, 0.1, 0.05}×peak:
    {4.34, 3.56, 2.43, 2.10} — monotone, in the published P.862 ballpark
  - butterworth lowpass at {7k, 4k, 2k, 1k, 0.5k} Hz:
    {4.44, 3.50, 2.78, 2.32, 2.19} — monotone (published P.862 rates a
    2 kHz bandlimit ≈ 2.5–3.0)
  - additive white noise {30, 20, 10, 0} dB SNR:
    {4.09, 2.92, 1.84, 1.50} — monotone, matching published P.862
    (≈ {3.9, 2.9, 1.8–2.2, 1.2–1.5}); the pre-r3 version bottomed out at
    1.39/1.12 for the last two — the compressive knee restores the
    certified curve's saturation behavior in the low-MOS regime
  - monotonicity agrees with STOI and SI-SDR on all of the above families
    (except delay, where STOI intentionally penalizes misalignment)
"""
from __future__ import annotations

import numpy as np

EPS = 1e-12
FRAME_MS = 32.0
OVERLAP = 0.5
N_BARK = 49
# disturbance gains calibrated on additive-white-noise anchors: speech +
# white noise scores ≈ {40 dB: 4.5, 30 dB: 4.1, 20 dB: 2.9, 10 dB: 1.4,
# 0 dB: 1.1} with these values — close to published P.862 behavior, slightly
# steeper at low SNR
D_SCALE = 1.0
DA_SCALE = 0.3
# aggregated-disturbance soft knee (see the mapping in pesq()): calibrated
# so severe degradations land on the published P.862 anchors instead of
# saturating the MOS floor early
D_KNEE = 20.0
D_KNEE_SLOPE = 0.5


def _resample(x, sr, target):
    if sr == target:
        return np.asarray(x, np.float64)
    from fractions import Fraction
    from scipy.signal import resample_poly
    fr = Fraction(target, sr).limit_denominator(10000)
    return resample_poly(np.asarray(x, np.float64), fr.numerator,
                         fr.denominator)


def _bandpass_power(x, sr, lo=350.0, hi=3250.0):
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / sr)
    m = (f >= lo) & (f <= hi)
    return np.sum(np.abs(spec[m]) ** 2) / (len(x) ** 2) * 2.0


def _level_align(x, sr, target_power=1e7 / 32768.0 ** 2):
    p = _bandpass_power(x, sr)
    return x * np.sqrt(target_power / max(p, EPS))


def _coarse_align(ref, deg, sr):
    """Constant-delay estimate from 4 ms energy-envelope correlation."""
    hop = max(1, int(sr * 0.004))
    n = min(len(ref), len(deg)) // hop
    if n < 8:
        return 0
    e_r = np.square(ref[:n * hop].reshape(n, hop)).sum(1)
    e_d = np.square(deg[:n * hop].reshape(n, hop)).sum(1)
    e_r = np.log(e_r + EPS)
    e_d = np.log(e_d + EPS)
    c = np.correlate(e_d - e_d.mean(), e_r - e_r.mean(), "full")
    return (int(np.argmax(c)) - (n - 1)) * hop


def _hz_to_bark(f):
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _bark_matrix(sr, n_fft):
    f = np.linspace(0, sr / 2, n_fft // 2 + 1)
    z = _hz_to_bark(f)
    edges = np.linspace(0, _hz_to_bark(sr / 2), N_BARK + 1)
    M = np.zeros((N_BARK, len(f)))
    for b in range(N_BARK):
        m = (z >= edges[b]) & (z < edges[b + 1])
        if m.any():
            M[b, m] = 1.0
    centers_hz = []
    for b in range(N_BARK):
        m = M[b] > 0
        centers_hz.append(f[m].mean() if m.any() else 0.0)
    return M, np.asarray(centers_hz)


def _hearing_threshold(freq_hz):
    """Absolute threshold of hearing (Terhardt approximation), in power."""
    f = np.maximum(np.asarray(freq_hz, np.float64), 20.0) / 1000.0
    db = (3.64 * f ** -0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
          + 1e-3 * f ** 4)
    return 10.0 ** (db / 10.0)


def _frames_power(x, sr, n_fft):
    hop = n_fft // 2
    n = 1 + max(0, len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    w = np.hanning(n_fft)
    spec = np.fft.rfft(x[idx] * w, axis=1)
    return (np.abs(spec) ** 2) / n_fft


def pesq(reference, degraded, sr, *, mode: str = "wb") -> float:
    """P.862-style MOS-LQO of `degraded` against clean `reference`.

    mode 'wb' (P.862.2, 16 kHz analysis) or 'nb' (8 kHz analysis with the
    narrowband output range)."""
    analysis_sr = 16000 if mode == "wb" else 8000
    ref = _resample(reference, sr, analysis_sr)
    deg = _resample(degraded, sr, analysis_sr)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if n < analysis_sr // 4:
        raise ValueError("signals too short for PESQ")

    ref = _level_align(ref, analysis_sr)
    deg = _level_align(deg, analysis_sr)
    delay = _coarse_align(ref, deg, analysis_sr)
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        ref = ref[-delay:]
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]

    n_fft = int(analysis_sr * FRAME_MS / 1000)
    P_ref = _frames_power(ref, analysis_sr, n_fft)
    P_deg = _frames_power(deg, analysis_sr, n_fft)
    M, centers = _bark_matrix(analysis_sr, n_fft)
    B_ref = P_ref @ M.T + EPS                    # (frames, bands)
    B_deg = P_deg @ M.T + EPS

    # speech-active frames of the reference
    frame_pow = B_ref.sum(1)
    active = frame_pow > frame_pow.max() * 1e-4
    if active.sum() < 4:
        active = np.ones(len(B_ref), bool)

    # hearing threshold calibrated to the aligned speech level: the shape
    # comes from the Terhardt curve, the scale anchors 40 dB below the
    # median active band power (P.862 fixes this via its SPL calibration;
    # level alignment above makes the relative anchor equivalent)
    shape = _hearing_threshold(centers)
    shape = shape / np.median(shape)
    anchor = np.median(B_ref[active]) * 1e-4
    thr = shape * anchor

    # partial frequency compensation: per-band mean ratio over active frames,
    # bounded (P.862 clips to [0.01, 100]) — applied to the reference
    ratio = (B_deg[active].mean(0) / B_ref[active].mean(0))
    # partial compensation only (±10 dB): spectral shaping beyond that is a
    # real audible degradation and must stay penalized
    ratio = np.clip(ratio, 0.1, 10.0)
    B_ref_c = B_ref * ratio[None, :]

    # short-term gain compensation on the degraded signal (clip [3e-4, 5])
    g = (B_ref_c.sum(1) + 5e3) / (B_deg.sum(1) + 5e3)
    g = np.clip(g, 3e-4, 5.0)
    B_deg_c = B_deg * g[:, None]

    # Zwicker loudness in the sensation-level domain (B/thr), which makes
    # the result invariant to the (already-aligned) absolute level
    def loud(B):
        return (0.5 + 0.5 * B / thr) ** 0.23 - 1.0

    L_ref = loud(B_ref_c)
    L_deg = loud(B_deg_c)

    # disturbance with masking dead-zone
    d = L_deg - L_ref
    m = 0.25 * np.minimum(np.abs(L_deg), np.abs(L_ref))
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # asymmetry factor: added distortions hurt more than removed ones
    h = ((B_deg_c + 50.0) / (B_ref_c + 50.0)) ** 1.2
    h = np.where(h < 3.0, 0.0, np.minimum(h, 12.0))

    # bark-width weights (uniform bark split → equal widths summing to the
    # full ~25-bark range, the P.862 Wb role)
    w = np.full(N_BARK, _hz_to_bark(analysis_sr / 2) / N_BARK)
    D_frame = D_SCALE * np.sqrt(np.sum((d ** 2) * w[None, :], axis=1))
    DA_frame = DA_SCALE * np.sum(np.abs(d) * h * w[None, :], axis=1)
    D_frame = np.minimum(D_frame, 45.0)
    DA_frame = np.minimum(DA_frame, 45.0)

    def aggregate(x):
        # L6 over ~0.32 s chunks, then L2 over chunks
        chunk = 20
        pads = (-len(x)) % chunk
        xx = np.pad(x, (0, pads)).reshape(-1, chunk)
        l6 = (np.mean(xx ** 6, axis=1)) ** (1 / 6)
        return float(np.sqrt(np.mean(l6 ** 2)))

    D = aggregate(D_frame)
    DA = aggregate(DA_frame)
    # soft-knee compression of severe disturbances, fitted to the published
    # P.862 white-noise operating points (10 dB SNR ≈ 1.8-2.2, 0 dB ≈
    # 1.2-1.5): below the knee the mapping is the standard linear one; past
    # it the slope halves, matching the saturation certified P.862 shows in
    # the < 2.5-MOS regime. Monotone by construction.
    D = D if D <= D_KNEE else D_KNEE + D_KNEE_SLOPE * (D - D_KNEE)
    DA = DA if DA <= D_KNEE else D_KNEE + D_KNEE_SLOPE * (DA - D_KNEE)
    raw = 4.5 - 0.1 * D - 0.0309 * DA
    if mode == "nb":
        return float(np.clip(raw, 1.0, 4.5))
    # P.862.2 wideband mapping
    mos = 0.999 + (4.999 - 0.999) / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    return float(np.clip(mos, 1.0, 4.64))
