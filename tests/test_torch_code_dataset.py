"""The I_da training data (data/multiseries.py, data/code_dataset.py:
`_extract_f0_bucketed`, F0DatasetTPU, CodeDataset, torchscript_embedder)
against the JAX package's, on the CPU, over a few synthetic utterances
written as 16 kHz wavs.

Tolerances:
  - multiseries, clip positions, integer streams (code, spkr) and audio:
    bit-equal (numpy on both sides, one Generator seeded alike);
  - f0 (the tracker of PR 5, and its tolerance, set on a 3.2 s
    utterance): voicing equal and at most 1% of an utterance's frames, or
    of an epoch's batches', beyond rel 2e-3 of the track in Hz, which is
    2e-3·|f0|/std in the z-normalised units the batches hold (where the
    NCCF ties at two lags, the median moves up to 3 frames by a few
    percent);
  - the loss mel and the embedding: float32 rounding (atol 2e-3 on the
    log-mel, whose quiet bins, 60 dB under their frame, take a 1024-term
    DFT sum's rounding of ~1e-6 of the frame's scale as ~1e-3 relative;
    atol 1e-6 on a unit-norm embedding).
"""
import numpy as np
import pytest
import torch

from speech_inpainting_tpu.data import code_dataset as jcd
from speech_inpainting_tpu.data import multiseries as jms
from speech_inpainting_tpu.ops.f0 import F0Config as JF0Config
from speech_inpainting_torch import testing
from speech_inpainting_torch.data import code_dataset as pcd
from speech_inpainting_torch.data import multiseries as pms
from speech_inpainting_torch.data.audio import save_wav
from speech_inpainting_torch.ops.f0 import F0Config

# utterance lengths in seconds, about PR 5's 3.2 s: all inside one 0.5 s
# f0 bucket but the last (one jitted JAX tracker per bucket)
SECONDS = (3.05, 3.12, 3.2, 3.31, 3.6)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five wavs of two speakers, p225_* and p226_*, with their units."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(5)
    files, codes = [], []
    for i, s in enumerate(SECONDS):
        path = root / f"p22{5 + i % 2}_{i:03d}.wav"
        save_wav(path, testing.synthetic_utterance(rng, s), 16000)
        files.append(path)
        codes.append(rng.integers(0, 100, int(s * 50)))
    return files, codes


def _f0_close(got, want, scale):
    """Voicing equal; at most 1% of frames beyond 2e-3 of `scale`."""
    np.testing.assert_array_equal(got != 0, want != 0)
    bad = np.abs(got - want) > 2e-3 * scale
    assert bad.mean() <= 0.01, np.flatnonzero(bad)


def test_multiseries_is_bit_equal():
    rng = np.random.default_rng(0)
    series = [(rng.standard_normal(16000 + 77), 1),
              (rng.integers(0, 100, 51), 320), (rng.standard_normal(201), 80),
              (rng.standard_normal((8, 63)), 256)]
    for min_length in (1, 8960, 40000):
        got = pms.match_length(series, min_length=min_length)
        want = jms.match_length(series, min_length=min_length)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = pms.match_length(series, min_length=8960)
    aligned = list(zip(got, (1, 320, 80, 256)))
    for g, w in zip(pms.clip_segment(aligned, 8960, 6400),
                    jms.clip_segment(aligned, 8960, 6400)):
        np.testing.assert_array_equal(g, w)
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for g, w in zip(pms.clip_segment_random(aligned, 8960, a),
                        jms.clip_segment_random(aligned, 8960, b)):
            np.testing.assert_array_equal(g, w)
        assert a.integers(1 << 30) == b.integers(1 << 30)
    with pytest.raises(RuntimeError):
        pms.match_length([(np.ones(10), 1)], min_length=2000)


def test_bucketed_f0_matches_jax(corpus):
    """The padded, tracked and trimmed track in Hz, for an utterance whose
    last frames see the bucket's zeros."""
    from speech_inpainting_torch.data.audio import load_wav
    wav, _ = load_wav(corpus[0][0])
    got = pcd._extract_f0_bucketed(wav, F0Config(), "cpu")
    want = jcd._extract_f0_bucketed(wav, JF0Config())
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[0] == F0Config().num_frames(len(wav))
    _f0_close(got, want, np.maximum(want, 1.0))


def test_f0_dataset_batches_match_jax(corpus, tmp_path):
    files, _ = corpus
    got_ds = pcd.F0DatasetTPU(files, segment_size=8960,
                              cache_dir=str(tmp_path / "p"), device="cpu")
    want_ds = jcd.F0DatasetTPU(files, segment_size=8960,
                               cache_dir=str(tmp_path / "j"))
    # the cache names are JAX's (sha256 of path and segment size)
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())
    for g, w in zip(got_ds.f0s, want_ds.f0s):
        assert g.shape == w.shape
        _f0_close(g, w, np.abs(w) + 8.0)      # |f0|/std ≤ |z| + mean/std
    for epoch in (0, 1):
        got = list(got_ds.batches(2, epoch=epoch, seed=7))
        want = list(want_ds.batches(2, epoch=epoch, seed=7))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["f0"].shape == w["f0"].shape == (2, 1, 112)
            assert g["f0"].dtype == np.float32
        # JAX's clip positions: the port's tracks clipped by JAX's batching
        rng = np.random.default_rng(np.random.SeedSequence([7, epoch]))
        order = rng.permutation(len(files))
        for s, g in zip(range(0, 4, 2), got):
            clips = [jms.clip_segment_random([(got_ds.f0s[i], 80)], 8960,
                                             rng)[0]
                     for i in order[s:s + 2]]
            np.testing.assert_array_equal(g["f0"][:, 0], np.stack(clips))
        g, w = (np.concatenate([b["f0"] for b in x]) for x in (got, want))
        _f0_close(g, w, np.abs(w) + 8.0)
    # a second dataset reads the cache; given statistics normalise
    again = pcd.F0DatasetTPU(files, segment_size=8960,
                             cache_dir=str(tmp_path / "p"), device="cpu")
    for g, w in zip(again.f0s, got_ds.f0s):
        np.testing.assert_array_equal(g, w)
    stats = {"f0_mean": 150.0, "f0_std": 30.0}
    got = pcd.F0DatasetTPU(files[:2], segment_size=8960, f0_stats=stats,
                           device="cpu")
    want = jcd.F0DatasetTPU(files[:2], segment_size=8960, f0_stats=stats)
    for g, w in zip(got.f0s, want.f0s):
        _f0_close(g, w, np.abs(w) + 150.0 / 30.0)


def test_code_dataset_batches_match_jax(corpus, tmp_path):
    files, codes = corpus
    cfg_p, cfg_j = pcd.CodeDatasetConfig(), jcd.CodeDatasetConfig()
    got_ds = pcd.CodeDataset(files, codes, cfg_p, device="cpu",
                             cache_dir=str(tmp_path))
    want_ds = jcd.CodeDataset(files, codes, cfg_j)
    assert got_ds.id_to_spkr == want_ds.id_to_spkr == ["p225", "p226"]
    for i in range(len(files)):
        assert got_ds._item_key(i) == want_ds._item_key(i)
        g, w = got_ds[i], want_ds[i]
        assert sorted(g) == sorted(w)
        for k in ("audio", "code", "spkr"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for epoch in (0, 3):
        got = list(got_ds.batches(2, epoch=epoch, seed=11))
        want = list(want_ds.batches(2, epoch=epoch, seed=11))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["audio", "code", "emb", "f0",
                                              "mel_loss", "spkr"]
            for k in g:
                assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
            for k in ("audio", "code", "spkr"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_allclose(g["mel_loss"], w["mel_loss"],
                                       atol=2e-3, rtol=0)
            np.testing.assert_allclose(g["emb"], w["emb"], atol=1e-6,
                                       rtol=0)
        g, w = (np.concatenate([b["f0"] for b in x]) for x in (got, want))
        _f0_close(g, w, np.abs(w) + 8.0)
    assert got[0]["audio"].shape == (2, 1, 8960)
    assert got[0]["code"].dtype == np.int32
    # the cache holds every item; a second dataset reads it back
    assert len(list(tmp_path.iterdir())) == len(files)
    again = pcd.CodeDataset(files, codes, cfg_p, device="cpu",
                            cache_dir=str(tmp_path),
                            embedder=lambda wav, sr: 1 / 0)
    for a, b in zip(again.items, got_ds.items):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_code_dataset_given_stats_single_speaker(corpus):
    files, codes = corpus
    stats = {0: {"f0_mean": 140.0, "f0_std": 25.0}}
    kw = dict(segment_size=6400, multispkr=None, embedding_dim=64)
    got = pcd.CodeDataset(files[:2], codes[:2],
                          pcd.CodeDatasetConfig(**kw), f0_stats=stats,
                          device="cpu")
    want = jcd.CodeDataset(files[:2], codes[:2],
                           jcd.CodeDatasetConfig(**kw), f0_stats=stats)
    assert got.id_to_spkr == want.id_to_spkr == ["A"]
    for g, w in zip(got.items, want.items):
        np.testing.assert_array_equal(g["spkr"], w["spkr"])
        assert g["emb"].shape == (64,)
        _f0_close(g["f0"], w["f0"], np.abs(w["f0"]) + 140.0 / 25.0)


class _Wav2Mel(torch.nn.Module):
    def forward(self, wav: torch.Tensor, sr: int) -> torch.Tensor:
        frames = wav[0, :wav.shape[1] // 160 * 160].reshape(-1, 160)
        return torch.log(frames.abs().mean(dim=1, keepdim=True)
                         .repeat(1, 40) * (sr / 16000.0) + 1e-5)


class _Embedder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(40, 16)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.proj(mel)

    @torch.jit.export
    def embed_utterance(self, mel: torch.Tensor) -> torch.Tensor:
        e = self.proj(mel).mean(dim=0)
        return e / e.norm()


def test_torchscript_embedder_matches_jax(tmp_path):
    torch.manual_seed(0)
    torch.jit.save(torch.jit.script(_Wav2Mel()), tmp_path / "wav2mel.pt")
    torch.jit.save(torch.jit.script(_Embedder()), tmp_path / "dvector.pt")
    paths = (str(tmp_path / "wav2mel.pt"), str(tmp_path / "dvector.pt"))
    wav = testing.synthetic_utterance(np.random.default_rng(2), 0.5)
    got = pcd.torchscript_embedder(*paths, device="cpu")(wav, 16000)
    want = jcd.torchscript_embedder(*paths)(wav, 16000)
    assert got.shape == (16,)
    np.testing.assert_array_equal(got, want)
