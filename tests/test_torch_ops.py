"""The port's main-path ops (speech_inpainting_torch.ops) against the JAX
package's, on the CPU in float32: the same numpy inputs through both.
Tolerance: atol 1e-5; rel 1e-4 on the log-mel; and on the STFT magnitude,
whose 1024-term sums reach ~10, atol 1e-5 plus rel 1e-5 (float32 rounding of
such a sum). JAX runs at Precision.HIGHEST."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from speech_inpainting_tpu.ops import conv as jconv
from speech_inpainting_tpu.ops import masking as jmask
from speech_inpainting_tpu.ops import mel as jmel
from speech_inpainting_tpu.ops import resize as jresize
from speech_inpainting_tpu.ops import stft as jstft
from speech_inpainting_torch.ops import conv, masking, mel, resize, stft

HI = lax.Precision.HIGHEST


def _close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("stride,padding,dilation,groups",
                         [(1, 3, 1, 1), (2, 0, 3, 1), (1, 8, 1, 4)])
def test_conv1d(rng, stride, padding, dilation, groups):
    x = rng.standard_normal((2, 8, 37)).astype(np.float32)
    w = rng.standard_normal((12, 8 // groups, 5)).astype(np.float32) * 0.2
    b = rng.standard_normal(12).astype(np.float32)
    want = jconv.conv1d(x, w, b, stride=stride, padding=padding,
                        dilation=dilation, groups=groups, precision=HI)
    got = conv.conv1d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                      stride=stride, padding=padding, dilation=dilation,
                      groups=groups)
    _close(got, want)


@pytest.mark.parametrize("u,k", [(8, 16), (2, 4), (5, 11)])
def test_conv_transpose1d(rng, u, k):
    x = rng.standard_normal((2, 6, 13)).astype(np.float32)
    w = rng.standard_normal((6, 4, k)).astype(np.float32) * 0.2
    b = rng.standard_normal(4).astype(np.float32)
    pad = (k - u) // 2
    want = jconv.conv_transpose1d(x, w, b, stride=u, padding=pad,
                                  precision=HI)
    got = conv.conv_transpose1d(torch.tensor(x), torch.tensor(w),
                                torch.tensor(b), stride=u, padding=pad)
    _close(got, want)


def test_weight_norm_folds(rng):
    v = rng.standard_normal((6, 4, 5)).astype(np.float32)
    g = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    _close(conv.weight_norm_kernel(torch.tensor(v), torch.tensor(g)),
           jconv.weight_norm_kernel(v, g))
    # transposed-conv layout (C_in, C_out, K): norm over axes (1, 2)
    _close(conv.weight_norm_kernel_tr(torch.tensor(v), torch.tensor(g)),
           jconv.weight_norm_kernel_tr(v, g))
    for k in (3, 7, 11):
        for d in (1, 3, 5):
            assert conv.get_padding(k, d) == jconv.get_padding(k, d)


@pytest.mark.parametrize("n,start,length", [(1001, 100, 441), (500, -3, 10),
                                            (500, 490, 50), (64, 0, 64)])
def test_mask_span(rng, n, start, length):
    x = rng.standard_normal(n).astype(np.float32)
    _close(masking.mask_span(torch.tensor(x), start, length),
           jmask.mask_span(jnp.asarray(x), start, length), atol=0)


def test_mask_wave_frames_batched(rng):
    """One call masks a batch with a span per row, as the vmapped JAX op."""
    x = rng.standard_normal((3, 16000)).astype(np.float32)
    pos = np.array([0, 7, 40])
    ln = np.array([10, 3, 10])
    want = np.stack([np.asarray(jmask.mask_wave_frames(jnp.asarray(x[i]),
                                                       pos[i], ln[i]))
                     for i in range(3)])
    _close(masking.mask_wave_frames(torch.tensor(x), torch.tensor(pos),
                                    torch.tensor(ln)), want, atol=0)
    got_f = masking.frame_mask(50, torch.tensor(pos), torch.tensor(ln))
    want_f = np.stack([np.asarray(jmask.frame_mask(50, pos[i], ln[i]))
                       for i in range(3)])
    np.testing.assert_array_equal(got_f.numpy(), want_f)


@pytest.mark.parametrize("frames", [1, 201])
def test_extend_mel_and_interp(rng, frames):
    m = rng.standard_normal((2, 80, frames)).astype(np.float32)
    got = resize.extend_mel(torch.tensor(m))
    want = jresize.extend_mel(jnp.asarray(m))
    assert got.shape == want.shape   # floor(frames · 441/256) frames
    _close(got, want)
    _close(resize.interp_linear(torch.tensor(m), 33),
           jresize.interp_linear(jnp.asarray(m), 33))


@pytest.mark.parametrize("n", [4410, 5001])
def test_stft_magnitude_odd_lengths(rng, n):
    y = rng.standard_normal((2, n)).astype(np.float32) * 0.3
    for hop, pad in ((441, 312), (256, 384)):
        want = jstft.stft_magnitude(y, n_fft=1024, hop=hop, win_size=1024,
                                    pad=pad)
        got = stft.stft_magnitude(torch.tensor(y), n_fft=1024, hop=hop,
                                  win_size=1024, pad=pad)
        assert got.shape == want.shape
        assert got.shape[-1] == stft.frame_count(n, 1024, hop, pad)
        _close(got, want, atol=1e-5, rtol=1e-5)


def test_mel_filterbank_and_compression(rng):
    for args in ((22050, 1024, 80, 0.0, 8000.0), (16000, 1024, 80, 0.0, None)):
        _close(mel.mel_filterbank(*args), jmel.mel_filterbank(*args), atol=0)
    x = np.abs(rng.standard_normal(100)).astype(np.float32) * 1e-4
    _close(mel.dynamic_range_compression(torch.tensor(x)),
           jmel.dynamic_range_compression(jnp.asarray(x)))


@pytest.mark.parametrize("preset", ["HUBERT_ALIGNED_MEL_22K",
                                    "VOCODER_MEL_22K"])
def test_mel_spectrogram(rng, preset, n=11025):
    y = rng.standard_normal((2, n)).astype(np.float32) * 0.3
    cfg_t, cfg_j = getattr(mel, preset), getattr(jmel, preset)
    assert (cfg_t.padding, cfg_t.hop_size) == (cfg_j.padding, cfg_j.hop_size)
    want = jmel.mel_spectrogram(jnp.asarray(y), cfg_j)
    got = mel.mel_spectrogram(torch.tensor(y), cfg_t)
    assert got.shape == want.shape
    assert got.shape[-1] == cfg_t.num_frames(n)
    _close(got, want, atol=1e-5, rtol=1e-4)
