"""The port's copy of the I_ea dataset (data/ea_dataset.py) against the
JAX package's, on wav files of many lengths written to a temporary
directory: `plan_buckets`, the cache key and the cache files, and every
batch of two epochs, plain and length-bucketed (a bucket's remainder
spilling into the next), bit for bit."""
import numpy as np
import pytest

from speech_inpainting_tpu.data import ea_dataset as jds
from speech_inpainting_torch.data import ea_dataset as pds
from speech_inpainting_torch.data.audio import save_wav

MAX = 8003      # 0.5 s + 3 samples, as the CLIs' max_length


@pytest.fixture
def corpus(tmp_path, rng):
    lengths = rng.integers(3000, 11000, 13)
    paths, labels = [], []
    for i, n in enumerate(lengths):
        p = tmp_path / f"u{i}.wav"
        save_wav(p, (rng.standard_normal(n) * 0.2).astype(np.float32), 16000)
        paths.append(p)
        labels.append(rng.integers(0, 100, max(1, (n - 80) // 320 - 2)))
    return paths, labels, lengths


def test_plan_buckets_matches_jax(rng):
    lengths = rng.integers(1000, 200000, 57)
    for k in (1, 3, 5):
        for cap in (None, 90000):
            assert pds.plan_buckets(lengths, k, max_length=cap) == \
                jds.plan_buckets(lengths, k, max_length=cap)


def test_cache_matches_jax(corpus, tmp_path):
    paths, labels, _ = corpus
    made = []
    for mod, d in ((jds, tmp_path / "jax"), (pds, tmp_path / "port")):
        ds = mod.EADataset(paths, labels, max_length=MAX, mask_length=3,
                           cache_dir=str(d))
        made.append((ds._cache_key(), sorted(p.name for p in d.iterdir()),
                     np.asarray(ds.waves), np.asarray(ds.lengths)))
    (k1, f1, w1, l1), (k2, f2, w2, l2) = made
    assert k1 == k2 and f1 == f2
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(l1, l2)
    # a second build reads the cache back (memory-mapped)
    again = pds.EADataset(paths, labels, max_length=MAX, mask_length=3,
                          cache_dir=str(tmp_path / "port"))
    assert isinstance(again.waves, np.memmap)


@pytest.mark.parametrize("buckets", [None, [4000, 6000]])
def test_batches_match_jax(corpus, buckets):
    paths, labels, lengths = corpus
    want = jds.EADataset(paths, labels, max_length=MAX, mask_length=3)
    got = pds.EADataset(paths, labels, max_length=MAX, mask_length=3)
    if buckets is not None:   # some bucket's remainder spills onward
        assert any(np.sum(np.minimum(lengths, MAX) <= b) % 4
                   for b in buckets)
    shapes = set()
    for epoch in (0, 1):
        a = list(want.batches(4, epoch=epoch, seed=7, buckets=buckets))
        b = list(got.batches(4, epoch=epoch, seed=7, buckets=buckets))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            shapes.add(x["wav"].shape)
    assert (len(shapes) == 1) == (buckets is None)
    # validation batches: in order, not shuffled
    for x, y in zip(want.batches(2, shuffle=False),
                    got.batches(2, shuffle=False)):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
