"""The port's ASR-baseline DSP chain (speech_inpainting_torch/ops/dsp.py)
and splice pipeline (infer/asr_baseline.py) against the JAX package's, on
the CPU, on a harmonic tone with a 300 ms mask.

Both sides are host numpy with the same arithmetic: VAD decisions, speech
bounds and DTW paths must be equal exactly, and every waveform within 1e-6
(equal in practice). The spectra go through the port's own mel filterbank
(HTK scale with the slaney norm forced), held to JAX's at rel 1e-6.
"""
import numpy as np
import pytest

from speech_inpainting_tpu.infer import asr_baseline as jbase
from speech_inpainting_tpu.ops import dsp as jdsp
from speech_inpainting_tpu.ops.mel import mel_filterbank as jax_filterbank
from speech_inpainting_torch.infer import asr_baseline as base
from speech_inpainting_torch.ops import dsp
from speech_inpainting_torch.ops.mel import mel_filterbank

SR = 16000
WAVE = 1e-6
MASK = (1.0, 1.3)      # 300 ms


def tone(seconds, f0=130.0, seed=0, sr=SR):
    """A harmonic tone under a slow envelope."""
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    y = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) / k
            for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t + 1.0)
    return (0.3 * y * env).astype(np.float32)


def utterance():
    """0.25 s of silence, 2 s of tone, 0.25 s of silence; the tone masked
    over MASK."""
    sil = np.zeros(SR // 4, np.float32)
    clean = np.concatenate([sil, tone(2.0), sil])
    masked = clean.copy()
    masked[int(MASK[0] * SR):int(MASK[1] * SR)] = 0.0
    return clean, masked


def _close(got, want, tol=WAVE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_vad_and_bounds_equal_jax():
    clean, masked = utterance()
    for y in (clean, masked, np.zeros(SR, np.float32), clean[:300]):
        va = dsp.energy_vad(y, SR)
        np.testing.assert_array_equal(va, jdsp.energy_vad(y, SR))
        assert dsp.speech_bounds(va, SR) == jdsp.speech_bounds(va, SR)
    assert dsp.speech_bounds(dsp.energy_vad(clean, SR), SR)[0] > 0


def test_htk_slaney_filterbank_equals_jax():
    for sr, n_fft, n_mels in ((16000, 2048, 128), (22050, 1024, 80)):
        got = mel_filterbank(sr, n_fft, n_mels, 0.0, sr / 2, htk=True,
                             norm="slaney")
        want = jax_filterbank(sr, n_fft, n_mels, 0.0, sr / 2, htk=True,
                              norm="slaney")
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        # the norm override is on: not the HTK default's unnormalised bank
        assert not np.allclose(got, mel_filterbank(sr, n_fft, n_mels, 0.0,
                                                   sr / 2, htk=True))


def test_spectra_and_mfcc_equal_jax():
    _, y = utterance()
    for n_fft, hop, win in ((2048, 160, None), (512, 128, 400)):
        _close(dsp.stft_mag(y, n_fft, hop, win),
               jdsp.stft_mag(y, n_fft, hop, win))
    S = dsp.melspectrogram(y, SR, hop=160)
    np.testing.assert_allclose(S, jdsp.melspectrogram(y, SR, hop=160),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(dsp.power_to_db(S), jdsp.power_to_db(S),
                               rtol=0, atol=1e-9)
    M = dsp.mfcc(y, SR, hop=160)
    assert M.shape == (20, 1 + len(y) // 160)
    np.testing.assert_allclose(M, jdsp.mfcc(y, SR, hop=160), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("steps", [((1, 1), (2, 1), (1, 2)),
                                   ((1, 1), (0, 1), (1, 0))],
                         ids=["row_recursion", "per_cell"])
def test_dtw_paths_equal_jax(steps, rng):
    for n, m in ((30, 41), (17, 17), (25, 45)):
        X = rng.standard_normal((6, n))
        Y = rng.standard_normal((6, m))
        D, path = dsp.dtw(X, Y, step_sizes=steps)
        jD, jpath = jdsp.dtw(X, Y, step_sizes=steps)
        np.testing.assert_array_equal(path, jpath)
        np.testing.assert_array_equal(D, jD)
        for t in (0.0, 0.05, 0.13):
            assert dsp.map_time(path, t, 160, SR) == jdsp.map_time(
                jpath, t, 160, SR)


def test_dtw_unreachable_corner_raises_alike(rng):
    X = rng.standard_normal((4, 10))
    Y = np.repeat(X, 2, axis=1)
    for mod in (dsp, jdsp):
        with pytest.raises(ValueError, match="unreachable"):
            mod.dtw(X, Y)


def test_mfcc_dtw_on_the_tone_equals_jax():
    clean, masked = utterance()
    synth = jdsp.wsola(clean, 1.3).astype(np.float32)
    _, path = dsp.dtw(dsp.mfcc(masked, SR, hop=160),
                      dsp.mfcc(synth, SR, hop=160))
    _, jpath = jdsp.dtw(jdsp.mfcc(masked, SR, hop=160),
                        jdsp.mfcc(synth, SR, hop=160))
    np.testing.assert_array_equal(path, jpath)


@pytest.mark.parametrize("alpha", [0.7, 1.0, 1.3, 2.5])
def test_wsola_equals_jax(alpha):
    y = tone(0.8)
    _close(dsp.wsola(y, alpha), jdsp.wsola(y, alpha))
    _close(dsp.wsola(y, alpha, tolerance=0), jdsp.wsola(y, alpha,
                                                        tolerance=0))
    with pytest.raises(ValueError, match="positive"):
        dsp.wsola(y, 0.0)


def test_crossfade_paste_equals_jax():
    y = tone(1.0)
    patch = tone(0.3, f0=190.0)
    for start, end in [(4000, 8800), (15990, 16090), (2, 100), (-50, 100),
                       (16000, 16200)]:
        _close(dsp.crossfade_paste(y, patch, start, end, SR),
               jdsp.crossfade_paste(y, patch, start, end, SR))


@pytest.mark.parametrize("crop", [True, False], ids=["vad_crop", "no_crop"])
def test_asr_tts_inpaint_equals_jax(crop):
    clean, masked = utterance()
    synth = jdsp.wsola(clean, 1.3).astype(np.float32)
    cfg, jcfg = (base.ASRBaselineConfig(crop_silence=crop),
                 jbase.ASRBaselineConfig(crop_silence=crop))
    got = base.asr_tts_inpaint(masked, synth, MASK, cfg)
    want = jbase.asr_tts_inpaint(masked, synth, MASK, jcfg)
    assert set(got) == set(want)
    for k in ("inpainted", "inpainted_with_silence", "patch"):
        _close(got[k], want[k])
    np.testing.assert_array_equal(got["target_span_s"],
                                  want["target_span_s"])
    # the patch lands in the mask
    assert len(got["patch"]) == int((MASK[1] - MASK[0]) * SR)
    mid = got["inpainted_with_silence"][int(MASK[0] * SR) + 200:
                                        int(MASK[1] * SR) - 200]
    assert np.sqrt(np.mean(mid ** 2)) > 0.02


def test_asr_tts_baseline_and_silent_mask_equal_jax():
    clean, masked = utterance()
    calls = []

    def asr(y):
        calls.append("asr")
        return "a test sentence"

    def tts(text, spk):
        calls.append(text)
        return clean

    kw = dict(asr=asr, tts=tts)
    got = base.asr_tts_baseline(masked, MASK, **kw)
    want = jbase.asr_tts_baseline(masked, MASK, **kw)
    assert calls == ["asr", "a test sentence"] * 2
    assert got["transcript"] == want["transcript"] == "a test sentence"
    _close(got["inpainted"], want["inpainted"])
    # a mask inside the trailing silence: the signal comes back unchanged
    tail = base.asr_tts_inpaint(masked, clean, (2.3, 2.45))
    jtail = jbase.asr_tts_inpaint(masked, clean, (2.3, 2.45))
    assert len(tail["patch"]) == len(jtail["patch"]) == 0
    np.testing.assert_array_equal(tail["inpainted_with_silence"], masked)
    for mod in (base, jbase):
        with pytest.raises(ValueError, match="asr"):
            mod.asr_tts_baseline(masked, MASK)
        with pytest.raises(ValueError, match="tts"):
            mod.asr_tts_baseline(masked, MASK, transcript="x")
