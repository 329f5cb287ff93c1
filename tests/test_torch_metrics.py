"""The port's metrics (speech_inpainting_torch/metrics: objective, stoi,
pesq, units, asr) against the JAX package's, on the CPU.

Both sides are host numpy and scipy with the same arithmetic, so every
value must agree within 1e-10 (it is equal in practice). The signals are 2 s
of a modulated multi-tone at 16 and 22.05 kHz under six degradation
families (white noise at 30, 10 and 0 dB SNR, clipping at 0.25 × peak, a
4th-order 2 kHz Butterworth lowpass, a 20 ms delay); PESQ in both modes.
"""
import sys

import numpy as np
import pytest
from scipy.signal import butter, sosfilt

from speech_inpainting_tpu.metrics import objective as jobj
from speech_inpainting_tpu.metrics import pesq as jpesq
from speech_inpainting_tpu.metrics import stoi as jstoi
from speech_inpainting_tpu.metrics import units as junits
from speech_inpainting_torch.metrics import objective, pesq, stoi, units
from speech_inpainting_torch.ops.dsp import stft_mag

EXACT = 1e-10
RATES = (16000, 22050)
FAMILIES = ("noise30", "noise10", "noise0", "clip0.25", "lowpass2k",
            "delay20ms")


def speechy(sr, seconds=2.0, seed=0):
    """A gliding harmonic series under a syllable-rate envelope."""
    t = np.arange(int(sr * seconds)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 2.1 * t)
    w = sum(0.25 / k * np.sin(2 * np.pi * k * np.cumsum(f0) / sr)
            for k in range(1, 6))
    env = 0.5 + 0.5 * np.square(np.sin(2 * np.pi * 1.7 * t))
    w = w * env + 1e-3 * np.random.default_rng(seed).standard_normal(t.size)
    return w.astype(np.float32)


def degrade(x, family, sr, rng):
    if family.startswith("noise"):
        snr = float(family[5:])
        noise = rng.standard_normal(x.size)
        noise *= np.sqrt(np.mean(x ** 2) / np.mean(noise ** 2)
                         / 10 ** (snr / 10))
        return (x + noise).astype(np.float32)
    if family.startswith("clip"):
        peak = float(family[4:]) * np.abs(x).max()
        return np.clip(x, -peak, peak)
    if family == "lowpass2k":
        return sosfilt(butter(4, 2000, fs=sr, output="sos"),
                       x).astype(np.float32)
    d = int(0.02 * sr)
    return np.concatenate([np.zeros(d, np.float32), x])[:x.size]


def _log_power(x):
    """(frames, bins) log power, the layout the LSDs take."""
    return np.log(stft_mag(x, 1024, 441, power=2.0) + 1e-5).T


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("family", FAMILIES)
def test_degradation_families_match_jax(family, sr):
    rng = np.random.default_rng(FAMILIES.index(family) * 2 + RATES.index(sr))
    ref = speechy(sr)
    deg = degrade(ref, family, sr, rng)
    pairs = [
        ("pesq_wb", pesq.pesq(ref, deg, sr, mode="wb"),
         jpesq.pesq(ref, deg, sr, mode="wb")),
        ("pesq_nb", pesq.pesq(ref, deg, sr, mode="nb"),
         jpesq.pesq(ref, deg, sr, mode="nb")),
        ("stoi", stoi.stoi(ref, deg, sr), jstoi.stoi(ref, deg, sr)),
        ("estoi", stoi.stoi(ref, deg, sr, extended=True),
         jstoi.stoi(ref, deg, sr, extended=True)),
        ("si_sdr", objective.si_sdr(deg, ref), jobj.si_sdr(deg, ref))]
    a, b = _log_power(ref), _log_power(deg)
    pairs += [("lsd_d2", objective.log_spectral_d2(a, b),
               jobj.log_spectral_d2(a, b)),
              ("lsd_rmse", objective.log_spectral_rmse(a, b),
               jobj.log_spectral_rmse(a, b))]
    for name, got, want in pairs:
        assert np.isfinite(got), name
        assert abs(got - want) <= EXACT, (name, got, want)
    # the family degrades the pair: PESQ and STOI fall below the
    # identity's, but for the delay, which PESQ's alignment compensates
    # (metrics/pesq.py's validity envelope) and SI-SDR sees
    if family == "delay20ms":
        assert objective.si_sdr(deg, ref) < objective.si_sdr(ref, ref) - 20
    else:
        assert pesq.pesq(ref, deg, sr) < pesq.pesq(ref, ref, sr)
        assert stoi.stoi(ref, deg, sr) < stoi.stoi(ref, ref, sr)


@pytest.mark.parametrize("fn", ["stoi", "pesq"])
def test_too_short_signals_raise_alike(fn):
    x = speechy(16000, seconds=0.05)
    for mod in ((stoi, jstoi) if fn == "stoi" else (pesq, jpesq)):
        with pytest.raises(ValueError):
            getattr(mod, fn)(x, x, 16000)


def test_cosine_and_text_metrics_match_jax(rng):
    center = rng.standard_normal(8)
    a, b = rng.standard_normal((2, 5, 8))
    assert abs(objective.avg_cosine_sim(a, b, center)
               - jobj.avg_cosine_sim(a, b, center)) <= EXACT
    pairs = [("The cat, sat!", "the cat sat"),
             ("a b c d", "a b"), ("abc", "abd"), ("", "hello there"),
             ("Hello, World!", "hello word"), ("one two three", "")]
    for ref, hyp in pairs:
        assert objective.normalize_text(ref) == jobj.normalize_text(ref)
        for norm in (True, False):
            assert objective.wer(ref, hyp, normalize=norm) == jobj.wer(
                ref, hyp, normalize=norm)
            assert objective.cer(ref, hyp, normalize=norm) == jobj.cer(
                ref, hyp, normalize=norm)


def test_unit_functions_match_jax(rng):
    seqs = [rng.integers(0, 6, n) for n in (0, 1, 7, 40, 40, 63)]
    seqs += [np.repeat(rng.integers(0, 9, 12), rng.integers(1, 4, 12))]
    for s in seqs:
        np.testing.assert_array_equal(units.collapse_runs(s),
                                      junits.collapse_runs(s))
    for a in seqs:
        for b in seqs:
            assert units.levenshtein(a, b) == junits.levenshtein(a, b)
            for collapse in (True, False):
                assert units.unit_error_rate(
                    a, b, collapse=collapse) == junits.unit_error_rate(
                    a, b, collapse=collapse)
            for span, margin, floor in (((3, 9), 2, 0), ((0, 4), 0, 3),
                                        ((30, 60), 2, 5)):
                assert units.masked_unit_edits(
                    a, b, span, margin=margin) == junits.masked_unit_edits(
                    a, b, span, margin=margin)
                assert units.masked_unit_error_rate(
                    a, b, span, margin=margin,
                    den_floor=floor) == junits.masked_unit_error_rate(
                    a, b, span, margin=margin, den_floor=floor)


def _enc(w):
    n = (len(w) // 160) * 160
    return (w[:n].reshape(-1, 160).mean(1) > 0).astype(np.int32)


@pytest.mark.parametrize("sr", RATES)
def test_unit_scorer_matches_jax(sr):
    ref = speechy(sr)
    est = degrade(ref, "noise0", sr, np.random.default_rng(3))
    for rate in RATES:
        got, want = units.UnitScorer(_enc, rate), junits.UnitScorer(_enc, rate)
        np.testing.assert_array_equal(got.units(est, sr), want.units(est, sr))
        assert got.uer(ref, est, sr) == want.uer(ref, est, sr)
        for span in ((0.3, 0.34), (0.5, 1.2)):
            assert got.masked_uer(ref, est, sr, span) == want.masked_uer(
                ref, est, sr, span)
            assert got.masked_uer_edits(
                ref, est, sr, span) == want.masked_uer_edits(ref, est, sr,
                                                             span)


def test_whisper_unavailable_without_transformers(monkeypatch):
    from speech_inpainting_torch.metrics import asr
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert asr.WhisperScorer.available() is False
    if not asr.torch.cuda.is_available():
        # an entry point: the card unless the CPU is asked for
        with pytest.raises(RuntimeError, match="no CUDA device"):
            asr.WhisperScorer()
    with pytest.raises(ImportError):
        asr.WhisperScorer(device="cpu")
