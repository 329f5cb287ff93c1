"""The port's inverse STFT and iSTFT-head generator against the JAX
package's, on the CPU in float32.

- `stft_complex` (hop 441, pad 312, and the iSTFT head's n_fft 16 / hop 4)
  against its JAX namesake: atol 1e-5 plus rel 1e-5, as
  test_torch_ops.py holds `stft_magnitude` (parts near 8 carry rel 1e-6
  of GEMM rounding);
- `istft_overlap_add` against its JAX namesake on N(0, 1) spectra, atol
  1e-5 (outputs O(1); the two sum the overlap-add in the same order);
- a narrow `ISTFTGenerator` (C8C8I at width 32) against flax's, through the
  port's plain ResBlock1 on the CPU, with weights that carry the signal
  (std 1/√fan-in, so conv_post's log-magnitudes are O(1) and exp moves
  them): atol 1e-4, the generator tests' tolerance, on a waveform whose
  peak is ~1;
- `InformedInpainter(generator=ISTFTGenerator)` against the JAX inpainter
  with the same override, the whole path: atol 1e-4 on mels and waveform.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.infer import inpaint as jinp
from speech_inpainting_tpu.models.hifigan import HiFiGANConfig as JaxGen
from speech_inpainting_tpu.models.hifigan_istft import \
    ISTFTGenerator as JaxISTFT
from speech_inpainting_tpu.models.hifigan_istft import \
    ISTFTGeneratorConfig as JaxISTFTConfig
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_tpu.ops import stft as jstft
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import istft_generator_from_jax
from speech_inpainting_torch.infer import inpaint
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.models.hifigan_istft import (
    ISTFTGenerator, ISTFTGeneratorConfig)
from speech_inpainting_torch.models.hubert import HubertConfig
from speech_inpainting_torch.ops import stft

NARROW = dict(upsample_initial_channel=32)
HUB = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, conv_dim=(32,) * 7,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.mark.parametrize("n_fft,hop,pad,n", [(1024, 441, 312, 4411),
                                             (16, 4, 6, 203)])
def test_stft_complex_matches_jax(rng, n_fft, hop, pad, n):
    y = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    want = jstft.stft_complex(y, n_fft=n_fft, hop=hop, win_size=n_fft,
                              pad=pad)
    got = stft.stft_complex(torch.tensor(y), n_fft=n_fft, hop=hop,
                            win_size=n_fft, pad=pad)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, n_fft // 2 + 1,
                                      stft.frame_count(n, n_fft, hop, pad))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    one = stft.stft_complex(torch.tensor(y[0]), n_fft=n_fft, hop=hop,
                            win_size=n_fft, pad=pad)
    np.testing.assert_array_equal(one[0].numpy(), got[0][0].numpy())


@pytest.mark.parametrize("n_fft,hop,frames", [(16, 4, 37), (16, 8, 5),
                                              (32, 4, 64)])
def test_istft_overlap_add_matches_jax(rng, n_fft, hop, frames):
    re, im = (rng.standard_normal((2, n_fft // 2 + 1, frames)
                                  ).astype(np.float32) for _ in range(2))
    want = np.asarray(jstft.istft_overlap_add(jnp.asarray(re),
                                              jnp.asarray(im),
                                              n_fft=n_fft, hop=hop))
    got = stft.istft_overlap_add(torch.tensor(re), torch.tensor(im),
                                 n_fft=n_fft, hop=hop).numpy()
    assert got.shape == want.shape == (2, (frames - 1) * hop)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_istft_refuses_a_hop_that_does_not_divide_n_fft():
    z = torch.zeros(1, 9, 4)
    with pytest.raises(AssertionError):
        stft.istft_overlap_add(z, z, n_fft=16, hop=5)


def _istft_tree(rng):
    cfg = ISTFTGeneratorConfig(**NARROW)
    tree = testing.generator_tree(cfg, rng, carry=True)
    shapes = jax.eval_shape(JaxISTFT(JaxISTFTConfig(**NARROW)).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 80, 8)))
    assert jax.tree_util.tree_map(np.shape, tree) == \
        jax.tree_util.tree_map(lambda s: s.shape, shapes["params"])
    return cfg, tree


def test_narrow_istft_generator_matches_flax(rng):
    cfg, tree = _istft_tree(rng)
    mel = rng.standard_normal((2, 80, 9)).astype(np.float32)
    want = np.asarray(jax.jit(JaxISTFT(JaxISTFTConfig(**NARROW)).apply)(
        {"params": tree}, jnp.asarray(mel)))
    gen = istft_generator_from_jax(cfg, tree, device="cpu")
    assert isinstance(gen, ISTFTGenerator)
    assert gen.cfg.upsample_rates == (8, 8) and gen.istft.total_upsample == 256
    with torch.no_grad():
        got = gen(torch.tensor(mel)).numpy()
        gen.use_kernel = False       # the plain route is the same on the CPU
        np.testing.assert_array_equal(gen(torch.tensor(mel)).numpy(), got)
    assert got.shape == want.shape == (2, 1, 9 * 256)
    assert np.abs(want).std() > 0.05      # not a silent waveform
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_inpainter_with_the_istft_engine_matches_jax(rng):
    hp = testing.hubert_tree(HubertConfig.base(**HUB), 80, rng)
    cfg, tree = _istft_tree(rng)
    centroids = rng.standard_normal((7, 80)).astype(np.float32)
    w22, w16, pos, lens = testing.synthetic_batch(rng, 2, 0.5, mask_frames=5)
    ref = jinp.InformedInpainter(
        jinp.InpainterConfig(JaxHub.base(**HUB), JaxGen(**NARROW)), hp, tree,
        centroids, generator=JaxISTFT(JaxISTFTConfig(**NARROW)))
    want = {k: np.asarray(v) for k, v in ref.batch(
        w22, w16, pos.astype(np.int32), lens.astype(np.int32)).items()}
    port = inpaint.InformedInpainter(
        inpaint.InpainterConfig(HubertConfig.base(**HUB),
                                HiFiGANConfig(**NARROW)),
        hp, None, centroids, device="cpu",
        generator=istft_generator_from_jax(cfg, tree, device="cpu"))
    got = {k: v.numpy() for k, v in port.batch(w22, w16, pos, lens).items()}
    for k in ("mel_masked", "mel_inpainted", "inpainted"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="not both"):
        inpaint.InformedInpainter(
            port.cfg, hp, tree, centroids, device="cpu",
            generator=istft_generator_from_jax(cfg, tree, device="cpu"))
