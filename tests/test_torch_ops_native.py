"""The last frontend ops and the native library's resampler and batch
crops, against the JAX package's, exactly, on the CPU:

- `ops/masking.py:mask_wave_samples` and `splice_frames` (selections, equal
  to the bit), and `ops/mel.py:dynamic_range_decompression` (equal to the
  bit but where the two libraries' float32 exp differ, by one ulp: rtol
  2.4e-7, two ulps);
- `data/native.py:resample` and `batch_crops` (the same C++ functions of
  native/libspeechio.so) on wavs the test writes itself."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_inpainting_tpu.data import native as jnative
from speech_inpainting_tpu.ops import masking as jmasking
from speech_inpainting_tpu.ops import mel as jmel
from speech_inpainting_torch.data import native
from speech_inpainting_torch.data.audio import save_wav
from speech_inpainting_torch.ops import masking, mel


@pytest.mark.parametrize("start,num", [(100, 250), (-5, 20), (990, 50),
                                       (0, 0)])
def test_mask_wave_samples_matches_jax(start, num):
    wav = np.random.default_rng(0).standard_normal((2, 1000)).astype(
        np.float32)
    got = masking.mask_wave_samples(torch.tensor(wav), start, num)
    want = jmasking.mask_wave_samples(jnp.asarray(wav), start, num)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pos,ln", [(3, 4), (0, 20), (18, 5), (7, 0)])
def test_splice_frames_matches_jax(pos, ln):
    rng = np.random.default_rng(1)
    base, rep = (rng.standard_normal((80, 20)).astype(np.float32)
                 for _ in range(2))
    got = masking.splice_frames(torch.tensor(base), torch.tensor(rep), pos,
                                ln)
    want = jmasking.splice_frames(jnp.asarray(base), jnp.asarray(rep), pos,
                                  ln)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("C", [1.0, 2.5])
def test_dynamic_range_decompression_matches_jax(C):
    x = np.random.default_rng(2).uniform(-11.5, 3.0, (80, 50)).astype(
        np.float32)
    got = mel.dynamic_range_decompression(torch.tensor(x), C)
    want = jmel.dynamic_range_decompression(jnp.asarray(x), C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.4e-7,
                               atol=0)
    # its inverse above the compression's clip (1e-5 before the C)
    back = mel.dynamic_range_compression(got, C).numpy()
    above = got.numpy() > 1e-5
    np.testing.assert_allclose(back[above], x[above], atol=1e-5)


@pytest.fixture
def corpus(tmp_path):
    """tests/test_native.py's corpus: four 22.05 kHz wavs of N(0, 0.09)."""
    if not native.build():
        pytest.fail("native/libspeechio.so does not build (make -C native)")
    rng = np.random.default_rng(3)
    paths = []
    for i in range(4):
        p = tmp_path / f"u{i}.wav"
        save_wav(p, (rng.standard_normal(22050 + 321 * i) * 0.3).astype(
            np.float32), 22050)
        paths.append(p)
    return paths


@pytest.mark.parametrize("sr,target", [(22050, 16000), (16000, 22050),
                                       (22050, 22050)])
def test_resample_matches_jax(corpus, sr, target):
    wav, _ = native.load_wav(corpus[0])
    got = native.resample(wav, sr, target)
    want = jnative.resample(wav, sr, target)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("target_sr,level", [(0, 0.95), (16000, 0.0)])
def test_batch_crops_matches_jax(corpus, target_sr, level):
    starts = [0, 100, 5000, 22050 - 10]       # the last overruns: zeros
    got = native.batch_crops(corpus, starts, 2048, target_sr=target_sr,
                             normalize_level=level)
    want = jnative.batch_crops(corpus, starts, 2048, target_sr=target_sr,
                               normalize_level=level)
    assert got.shape == (4, 2048) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if target_sr == 0:   # u3 holds 22050 + 3·321 samples: 973 from 22040
        assert got[3, :973].any() and not got[3, 973:].any()
