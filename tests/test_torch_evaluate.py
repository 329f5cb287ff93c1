"""The port's mask-sweep harness (speech_inpainting_torch/infer/evaluate.py)
against the JAX package's, on the CPU in float32, at tests/test_inpaint.py's
oracle-guard geometry (a one-layer 16-wide HuBERT with its head, a 16-wide
V1-shaped generator, 7 centroids, 2 s of audio), the same numpy trees on
both sides, the generator's weights carrying the mel
(`testing.generator_tree(carry=True)`).

Tolerances, each with its reason:
  - the sweep fixture, the metric keys and the discrete columns (unit_acc,
    uer, uer_mask, uer_mask_edits) must be equal: they count labels and
    units, which the inputs leave clear of ties;
  - stoi, estoi, lsd_d2, lsd_rmse and mel_l1_mask within 1e-3 absolute,
    pesq and si_sdr within 1e-2: the metrics are the same host numpy on
    both sides, fed waveforms and mels that differ by float32 rounding
    (the I_ea slice's waveform tolerance is 1e-4); SI-SDR in dB and PESQ's
    disturbance sums magnify that most. The largest gaps observed here are
    written in PERF.md.
"""
import numpy as np
import pytest

from speech_inpainting_tpu.infer import evaluate as jev
from speech_inpainting_tpu.infer import inpaint as jinp
from speech_inpainting_tpu.metrics.units import UnitScorer as JaxUnitScorer
from speech_inpainting_tpu.models.hifigan import HiFiGANConfig as JaxGen
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_torch import testing
from speech_inpainting_torch.infer import evaluate, inpaint
from speech_inpainting_torch.metrics.units import UnitScorer
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.models.hubert import HubertConfig

# tests/test_inpaint.py:248-256's geometry
HUB = dict(conv_dim=(8,) * 7, hidden_size=16, num_hidden_layers=1,
           num_attention_heads=2, intermediate_size=24,
           num_conv_pos_embeddings=15, num_conv_pos_embedding_groups=1)
GEN = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))
EXACT = ("unit_acc", "uer", "uer_mask", "uer_mask_edits")
FINE = ("stoi", "estoi", "lsd_d2", "lsd_rmse", "mel_l1_mask", "stoi_vs_exp",
        "estoi_vs_exp")
COARSE = ("pesq", "si_sdr", "pesq_vs_exp", "si_sdr_vs_exp")
TOLERANCE = {**{k: 1e-3 for k in FINE}, **{k: 1e-2 for k in COARSE}}


def _enc(w):
    """tests/test_inpaint.py:285-287's stub unit encoder."""
    n = (len(w) // 160) * 160
    return (w[:n].reshape(-1, 160).mean(1) > 0).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """(port, JAX) inpainters on the same trees, two utterances and their
    oracle labels (shorter than the 100-frame grid, as at :265)."""
    rng = np.random.default_rng(1234)
    hp = testing.hubert_tree(HubertConfig(**HUB), 80, rng)
    # weights that carry the mel to the waveform (flax's default init, as
    # the JAX test's, does too): under HiFi-GAN's N(0, 0.01) init the
    # waveform barely moves with the mel, the inpainted and expected
    # renderings then agree to float32 rounding, and SI-SDR between them
    # reads ~180 dB of rounding noise (a 1.2 dB gap between the two sides)
    gp = testing.generator_tree(HiFiGANConfig(**GEN), rng, carry=True)
    centroids = rng.standard_normal((7, 80)).astype(np.float32)
    port = inpaint.InformedInpainter(
        inpaint.InpainterConfig(HubertConfig(**HUB), HiFiGANConfig(**GEN)),
        hp, gp, centroids, device="cpu")
    ref = jinp.InformedInpainter(
        jinp.InpainterConfig(JaxHub(**HUB), JaxGen(**GEN)), hp, gp,
        centroids)
    w22, w16, _, _ = testing.synthetic_batch(rng, 2, 2.0)
    labels = rng.integers(0, 7, (2, 40)).astype(np.int32)
    return port, ref, w22, w16, labels


def _gaps(got, want):
    """Largest |got − want| per metric, after the equal keys and columns."""
    assert set(got) == set(want)
    for k in EXACT:
        if k in want:
            assert got[k] == want[k], (k, got[k], want[k])
    gaps = {k: abs(got[k] - want[k]) for k in TOLERANCE if k in want}
    for k, gap in gaps.items():
        assert gap <= TOLERANCE[k], (k, got[k], want[k])
    return gaps


def test_sweep_fixture_equals_jax(tmp_path):
    lengths = {"a": 32000, "b": 64000, "c": 1500}
    for kw in ({}, {"mask_lengths_ms": (100, 400), "n_positions": 3,
                    "seed": 7}):
        got = evaluate.build_mask_sweep(lengths, **kw)
        assert got == jev.build_mask_sweep(lengths, **kw)
    evaluate.save_mask_sweep(got, tmp_path / "sweep.json")
    assert evaluate.load_mask_sweep(tmp_path / "sweep.json") == got
    assert jev.load_mask_sweep(tmp_path / "sweep.json") == got
    assert evaluate.DEFAULT_MASK_LENGTHS_MS == jev.DEFAULT_MASK_LENGTHS_MS


@pytest.mark.parametrize("case", ["true_labels", "plain", "unit_scorer"])
def test_evaluate_inpainting_matches_jax(pair, case):
    port, ref, w22, w16, labels = pair
    kw, jkw = {}, {}
    if case == "true_labels":
        kw = jkw = {"true_labels": labels[0]}
    elif case == "unit_scorer":
        kw = {"unit_scorer": UnitScorer(_enc, rate=22050)}
        jkw = {"unit_scorer": JaxUnitScorer(_enc, rate=22050)}
    positions = [10 * 320, 22 * 320]
    got = evaluate.evaluate_inpainting(port, w22[0], w16[0], positions, 100,
                                       **kw)
    want = jev.evaluate_inpainting(ref, w22[0], w16[0], positions, 100,
                                   **jkw)
    gaps = _gaps(got, want)
    print(case, {k: f"{v:.2e}" for k, v in gaps.items()})
    if case == "true_labels":
        assert "unit_acc" in got and "pesq_vs_exp" in got
    if case == "unit_scorer":
        assert got["uer"] >= 0.0 and "uer_mask_edits" in got


def test_oracle_label_guard(pair):
    """tests/test_inpaint.py:266-280 on the port: a mask overlapping the
    frames past the oracle track is left out of the vs-expected columns,
    the clean-reference columns cover every position."""
    port, _, w22, w16, labels = pair
    lab = labels[0]                      # 40 frames, shorter than the grid
    m = evaluate.evaluate_inpainting(port, w22[0], w16[0],
                                     [10 * 320, 38 * 320], 100,
                                     true_labels=lab)
    assert "pesq" in m and "unit_acc" in m
    m_only = evaluate.evaluate_inpainting(port, w22[0], w16[0], [10 * 320],
                                          100, true_labels=lab)
    np.testing.assert_allclose(m["unit_acc"], m_only["unit_acc"])
    np.testing.assert_allclose(m["mel_l1_mask"], m_only["mel_l1_mask"])
    np.testing.assert_allclose(m["pesq_vs_exp"], m_only["pesq_vs_exp"])
    m_none = evaluate.evaluate_inpainting(port, w22[0], w16[0], [38 * 320],
                                          100, true_labels=lab)
    assert "unit_acc" not in m_none and "pesq" in m_none
    m_uer = evaluate.evaluate_inpainting(
        port, w22[0], w16[0], [10 * 320], 100,
        unit_scorer=UnitScorer(_enc, rate=22050))
    assert "uer" in m_uer and m_uer["uer"] >= 0.0


def test_evaluate_sweep_matches_jax(pair):
    port, ref, w22, w16, labels = pair
    names = ("u0", "u1")
    wavs22 = dict(zip(names, w22))
    wavs16 = dict(zip(names, w16))
    labs = dict(zip(names, labels))
    sweep = evaluate.build_mask_sweep({n: len(wavs16[n]) for n in names},
                                      (100, 200), n_positions=2, seed=3)
    got = evaluate.evaluate_sweep(port, wavs22, wavs16, sweep, labels=labs)
    want = jev.evaluate_sweep(ref, wavs22, wavs16, sweep, labels=labs)
    assert set(got) == set(want) == {"u0", "u1", "mean"}
    for key in ("u0", "u1", "mean"):
        assert set(got[key]) == {100, 200}
        for ms in (100, 200):
            _gaps(got[key][ms], want[key][ms])
    for ms in (100, 200):
        for k, v in got["mean"][ms].items():
            assert v == pytest.approx(np.mean([got[n][ms][k] for n in names
                                               if k in got[n][ms]]))
