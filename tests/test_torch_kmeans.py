"""The port's k-means fitting (quantize/kmeans.py) and the kmeans CLI
against the JAX package's, on the CPU in float32.

The JAX package draws its seeds and restarts from `jax.random` streams,
which torch cannot reproduce, so the two are held where they are
deterministic and by the properties of the rest:
  - one Lloyd pass (`_chunked_stats`) and Lloyd from one shared start with
    no dead cluster (`_lloyd`): sums and counts, centroids at atol 1e-5
    (float32 means of a few hundred rows of magnitude ~3), labels equal;
  - a dead cluster restarts as a data row, on both sides;
  - kmeans++ (`_kmeanspp_init`) picks k distinct data rows;
  - the host-side seeding subsample is the same rows as JAX's;
  - `fit_kmeans` on well-separated blobs finds JAX's partition up to a
    permutation, its inertia within rel 1e-4;
  - `codebook_diagnostics` equal;
  - the CLI's dump (mels at atol 1e-4, log-mel values of magnitude ≤ 12),
    fit and label (labels and centroid mels equal to JAX's CLI's under
    one codebook).
"""
import numpy as np
import pytest
import torch

import jax

from speech_inpainting_tpu.cli import kmeans_cli as jcli
from speech_inpainting_tpu.quantize import kmeans as jk
from speech_inpainting_torch.cli import kmeans_cli
from speech_inpainting_torch.quantize import kmeans as pk


def _blobs(rng, n=3000, k=5, d=8, spread=3.0, noise=0.3):
    centers = rng.standard_normal((k, d)) * spread
    labels = rng.integers(0, k, n)
    x = centers[labels] + noise * rng.standard_normal((n, d))
    return x.astype(np.float32), centers.astype(np.float32), labels


def _rows_of(C, x) -> bool:
    """Every row of C is a row of x."""
    return all((np.abs(x - c).max(axis=1) == 0).any() for c in C)


def test_chunked_stats_and_lloyd_match_jax(rng):
    x, centers, _ = _blobs(rng, n=2048)
    C0 = centers + 0.5 * rng.standard_normal(centers.shape).astype(np.float32)
    sums, counts, inertia = jk._chunked_stats(x, C0, 256)
    got = pk._chunked_stats(torch.tensor(x), torch.tensor(C0), 256)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(counts))
    assert np.asarray(counts).min() > 0              # no dead cluster
    np.testing.assert_allclose(got[0].numpy(), np.asarray(sums), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(float(got[2]), float(inertia), rtol=1e-5)
    C, inertia = jk._lloyd(jax.random.PRNGKey(0), x, C0, 6, 256)
    gen = torch.Generator().manual_seed(0)
    got_C, got_inertia = pk._lloyd(gen, torch.tensor(x), torch.tensor(C0), 6,
                                   256)
    np.testing.assert_allclose(got_C.numpy(), np.asarray(C), atol=1e-5)
    np.testing.assert_allclose(float(got_inertia), float(inertia), rtol=1e-5)
    np.testing.assert_array_equal(
        pk.assign(torch.tensor(x), got_C).numpy(),
        np.asarray(jk.assign(x, np.asarray(C))))
    labels, mind = pk.assign_and_distance(torch.tensor(x), got_C)
    jl, jm = jk.assign_and_distance(x, np.asarray(C))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(mind.numpy(), np.asarray(jm), rtol=1e-4,
                               atol=1e-5)


def test_dead_cluster_restarts_from_a_data_row(rng):
    x, centers, _ = _blobs(rng, n=1024, k=4)
    C0 = np.concatenate([centers, np.full((1, 8), 1e3, np.float32)])
    gen = torch.Generator().manual_seed(1)
    C, _ = pk._lloyd(gen, torch.tensor(x), torch.tensor(C0), 1, 256)
    Cj, _ = jk._lloyd(jax.random.PRNGKey(1), x, C0, 1, 256)
    for got in (C.numpy(), np.asarray(Cj)):
        assert _rows_of(got[4:], x)
        assert not _rows_of(got[:4], x)       # the live ones are means


def test_kmeanspp_picks_distinct_data_rows(rng):
    x, centers, _ = _blobs(rng, n=500, k=6)
    gen = torch.Generator().manual_seed(2)
    C = pk._kmeanspp_init(gen, torch.tensor(x), 6).numpy()
    Cj = np.asarray(jk._kmeanspp_init(jax.random.PRNGKey(2), x, 6))
    for got in (C, Cj):
        assert got.shape == (6, 8) and _rows_of(got, x)
        assert len(np.unique(got, axis=0)) == 6
    # D² sampling: the six blobs lie far apart, and each got a seed
    assert len(set(pk.assign(torch.tensor(C),
                             torch.tensor(centers)).tolist())) == 6


def test_seeding_subsample_is_jax_s(monkeypatch, rng):
    """The rows kmeans++ seeds from: the same host-side choice as JAX's."""
    x, _, _ = _blobs(rng, n=600)
    seen = {}

    def spy(side):
        def init(key, sub, k):
            seen[side] = np.asarray(sub)
            raise StopIteration
        return init

    monkeypatch.setattr(jk, "_kmeanspp_init", spy("jax"))
    monkeypatch.setattr(pk, "_kmeanspp_init", spy("port"))
    for fit, side in ((jk.fit_kmeans, "jax"), (pk.fit_kmeans, "port")):
        kw = {"device": "cpu"} if side == "port" else {}
        with pytest.raises(StopIteration):
            fit(x, 5, init_sample=100, seed=7, **kw)
    assert seen["port"].shape == (100, 8)
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    assert pk._seeding_rows(600, 600, 7) is None


def test_fit_kmeans_finds_jax_s_partition(rng):
    x, _, _ = _blobs(rng, n=3000)           # 3000 rows: chunks repeat rows
    C, inertia = pk.fit_kmeans(x, 5, iters=10, chunk=512, n_init=2,
                               device="cpu")
    Cj, inertia_j = jk.fit_kmeans(x, 5, iters=10, chunk=512, n_init=2)
    assert C.shape == (5, 8) and C.dtype == torch.float32
    got = pk.assign(torch.tensor(x), C).numpy()
    want = np.asarray(jk.assign(x, Cj))
    pairs = set(zip(got.tolist(), want.tolist()))
    assert len(pairs) == 5 == len({a for a, _ in pairs}) == len(
        {b for _, b in pairs})                 # a bijection of labels
    np.testing.assert_allclose(inertia, inertia_j, rtol=1e-4)
    km = pk.KMeans.fit(x, 5, iters=10, chunk=512, n_init=2, device="cpu")
    np.testing.assert_array_equal(km.centroids, C.numpy())
    np.testing.assert_array_equal(km(torch.tensor(x)).numpy(), got)
    np.testing.assert_array_equal(km.quantize(torch.tensor(x)).numpy(),
                                  km.centroids[got])


def test_codebook_diagnostics_equal_jax_s(rng):
    C = rng.standard_normal((7, 5)).astype(np.float32)
    assert pk.codebook_diagnostics(C) == jk.codebook_diagnostics(C)
    assert pk.codebook_diagnostics(torch.tensor(C)) == \
        jk.codebook_diagnostics(C)


def test_kmeans_cli_matches_jax_s(rng, tmp_path):
    from scipy.io import wavfile
    from speech_inpainting_torch.testing import synthetic_utterance
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for name in ("a", "b"):
        w = synthetic_utterance(rng, 0.6, sr=22050)
        wavfile.write(wavs / f"{name}.wav", 22050,
                      (w * 32767).astype(np.int16))
    (tmp_path / "split.txt").write_text("a|x\nb|y\n")
    common = ["--wavs", str(wavs), "--split", str(tmp_path / "split.txt")]
    kmeans_cli.main(["dump", *common, "--out", str(tmp_path / "d"),
                     "--device", "cpu"])
    jcli.main(["dump", *common, "--out", str(tmp_path / "dj")])
    for f in ("a_mel.npy", "b_mel.npy", "train_valid.npy"):
        got, want = np.load(tmp_path / "d" / f), np.load(tmp_path / "dj" / f)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.load(tmp_path / "d" / "train_valid.npy").shape == (60, 80)
    kmeans_cli.main(["fit", "--features",
                     str(tmp_path / "d" / "train_valid.npy"), "--k", "4",
                     "--iters", "5", "--n-init", "2", "--out",
                     str(tmp_path / "km.npy"), "--device", "cpu"])
    C = np.load(tmp_path / "km.npy")
    assert C.shape == (4, 80) and np.isfinite(C).all()
    kmeans_cli.main(["label", *common, "--model", str(tmp_path / "km.npy"),
                     "--out", str(tmp_path / "l"), "--device", "cpu"])
    jcli.main(["label", *common, "--model", str(tmp_path / "km.npy"),
               "--out", str(tmp_path / "lj")])
    for name in ("a", "b"):
        got = np.load(tmp_path / "l" / f"{name}_labels.npy")
        want = np.load(tmp_path / "lj" / f"{name}_labels.npy")
        assert got.dtype == want.dtype and got.shape == (30,)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            np.load(tmp_path / "l" / f"{name}_mel_c.npy"),
            np.load(tmp_path / "lj" / f"{name}_mel_c.npy"))
