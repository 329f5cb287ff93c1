"""The whole slice: the port's InformedInpainter against the JAX package's,
on the CPU in float32, at a tiny HuBERT and a narrow V1 generator on 0.5 s
of audio. Tolerances: atol 1e-4 on the log-mels (|values| ≲ 12) and the
waveform; labels compared where the top-2 similarity margin clears 1e-4.

Weights come from speech_inpainting_torch/testing.py's numpy trees, whose
names and shapes are checked against the JAX package's init by abstract
evaluation (compiling those inits costs more than this suite's time
budget)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.infer import inpaint as jinp
from speech_inpainting_tpu.models.hifigan import Generator
from speech_inpainting_tpu.models.hifigan import HiFiGANConfig as JaxGen
from speech_inpainting_tpu.models.hubert import EncoderWithHead
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_torch import testing
from speech_inpainting_torch.infer import inpaint
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.models.hubert import HubertConfig

HUB = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, conv_dim=(32,) * 7,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
GEN = dict(upsample_initial_channel=32)


def _shapes(tree):
    return jax.tree_util.tree_map(np.shape, tree)


def test_smoke_trees_have_the_jax_init_layout():
    rng = np.random.default_rng(0)
    hp = testing.hubert_tree(HubertConfig.base(**HUB), 80, rng)
    want = jax.eval_shape(EncoderWithHead(JaxHub.base(**HUB), out_dim=80).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 3200)))
    assert _shapes(hp) == jax.tree_util.tree_map(lambda s: s.shape,
                                                 want["params"])
    gp = testing.generator_tree(HiFiGANConfig(**GEN), rng)
    want = jax.eval_shape(Generator(JaxGen(**GEN)).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 80, 8)))
    assert _shapes(gp) == jax.tree_util.tree_map(lambda s: s.shape,
                                                 want["params"])


def test_slice_matches_jax(rng):
    hp = testing.hubert_tree(HubertConfig.base(**HUB), 80, rng)
    gp = testing.generator_tree(HiFiGANConfig(**GEN), rng)
    centroids = rng.standard_normal((7, 80)).astype(np.float32)
    w22, w16, pos, lens = testing.synthetic_batch(rng, 2, 0.5,
                                                  mask_frames=5)
    ref = jinp.InformedInpainter(
        jinp.InpainterConfig(JaxHub.base(**HUB), JaxGen(**GEN)), hp, gp,
        centroids)
    want = {k: np.asarray(v) for k, v in ref.batch(w22, w16, pos.astype(
        np.int32), lens.astype(np.int32)).items()}
    port = inpaint.InformedInpainter(
        inpaint.InpainterConfig(HubertConfig.base(**HUB), HiFiGANConfig(**GEN)),
        hp, gp, centroids, device="cpu")
    got = {k: v.numpy() for k, v in port.batch(w22, w16, pos, lens).items()}
    for k in ("mel_masked", "mel_inpainted", "inpainted"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    # labels where the nearest centroid is clear of the runner-up
    emb = port.hubert(inpaint.meanvar_normalize(
        inpaint.mask_wave_frames(torch.tensor(w16), torch.tensor(pos),
                                 torch.tensor(lens)))).numpy()
    cc = centroids - centroids.mean(0)
    sim = (emb / np.linalg.norm(emb, axis=-1, keepdims=True)) @ (
        cc / np.linalg.norm(cc, axis=-1, keepdims=True)).T
    top2 = np.sort(sim, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got["pred_labels"][clear],
                                  want["pred_labels"][clear])
    # one utterance through __call__ is row 0 of the batch
    one = port(w22[0], w16[0], int(pos[0]), int(lens[0]))
    np.testing.assert_allclose(one["inpainted"].numpy(), got["inpainted"][0],
                               atol=1e-6)


def test_normalizations_and_splice(rng):
    x = rng.standard_normal((2, 1000)).astype(np.float32) * 3.0
    np.testing.assert_allclose(inpaint.peak_normalize(torch.tensor(x)),
                               jinp.peak_normalize(jnp.asarray(x)), atol=1e-6)
    np.testing.assert_allclose(inpaint.meanvar_normalize(torch.tensor(x)),
                               jinp.meanvar_normalize(jnp.asarray(x)),
                               atol=1e-5)
    mel = rng.standard_normal((2, 80, 20)).astype(np.float32)
    pos, ln = np.array([3, 15]), np.array([4, 10])
    for t in (12, 20, 31):   # the predicted stream is padded or cut to 20
        frames = rng.standard_normal((2, t, 80)).astype(np.float32)
        got = inpaint._splice(torch.tensor(mel), torch.tensor(frames),
                              torch.tensor(pos), torch.tensor(ln))
        want = jinp._splice(jnp.asarray(mel), jnp.asarray(frames),
                            jnp.asarray(pos), jnp.asarray(ln))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
