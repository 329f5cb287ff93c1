"""The port's HuBERT encoder + head (loaded by convert/from_jax.py) against
the flax EncoderWithHead, on the CPU in float32, at a tiny config
(2 layers, hidden 64, 4 heads, conv_dim 32) with the JAX package's own init,
and an even positional-conv kernel, whose last output frame is dropped.
Tolerance atol 1e-4 on the head's output, which is O(1) after its
LayerNorm; in bfloat16 (flax `dtype=jnp.bfloat16` against the port's
`dtype=torch.bfloat16`: convs and dense layers in bf16, norms, softmax,
residual stream and head in f32 on both sides) rel 3e-2, bench.py's bf16
tolerance.

The large arrangement (conv biases and a LayerNorm after every conv,
pre-LN layers, the final LayerNorm only without a tap) at the same tiny
widths, against flax's HubertModel (with and without `tap_layer`) and
EncoderWithHead, float32, atol 1e-4 on outputs of LayerNorm scale; its
weights are testing.py's tree (layout checked against flax's init by
abstract evaluation) with every norm and bias drawn at random, so that a
norm or bias loaded into the wrong place moves the output."""
import numpy as np
import torch

import pytest

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.models.hubert import EncoderWithHead
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxConfig
from speech_inpainting_tpu.models.hubert import HubertModel as JaxModel
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (hubert_from_jax,
                                                      hubert_model_from_jax)
from speech_inpainting_torch.models.hubert import HubertConfig

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, conv_dim=(32,) * 7,
            num_conv_pos_embedding_groups=4)


def _flax_and_port(rng, jax_dtype, torch_dtype):
    over = dict(TINY, num_conv_pos_embeddings=16)
    wav = rng.standard_normal((2, 4000)).astype(np.float32) * 0.3
    init = EncoderWithHead(JaxConfig.base(**over), out_dim=80)
    params = jax.jit(init.init)(jax.random.PRNGKey(0),
                                jnp.asarray(wav))["params"]
    model = EncoderWithHead(JaxConfig.base(**over, dtype=jax_dtype),
                            out_dim=80)
    want = np.asarray(jax.jit(model.apply)({"params": params},
                                           jnp.asarray(wav)), np.float32)
    port = hubert_from_jax(HubertConfig.base(**over, dtype=torch_dtype),
                           jax.tree_util.tree_map(np.asarray, params),
                           out_dim=80, device="cpu")
    with torch.no_grad():
        got = port(torch.tensor(wav)).float().numpy()
    assert got.shape == want.shape == (2, 12, 80)
    return port, got, want


def test_encoder_with_head_matches_flax(rng):
    port, got, want = _flax_and_port(rng, jnp.float32, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert port.hubert.pos_conv_embed.drop_last


def test_encoder_with_head_matches_flax_in_bf16(rng):
    port, got, want = _flax_and_port(rng, jnp.bfloat16, torch.bfloat16)
    assert port.hubert.feature_extractor.convs[0].weight.dtype == \
        torch.bfloat16
    assert np.abs(got - want).max() / np.abs(want).max() <= 3e-2


LARGE = dict(TINY, num_conv_pos_embeddings=16)


def jitter(tree, rng):
    """`tree` with every norm's scale and bias and every bias drawn at
    random (the tree's own init makes them 1 and 0)."""
    def leaf(path, a):
        if path[-1] in ("scale", "bias") or path[-1].startswith("conv_") \
                and path[-1].endswith("_b"):
            base = 1.0 if path[-1] == "scale" else 0.0
            return (base + 0.2 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return a
    return jax.tree_util.tree_map_with_path(
        lambda p, a: leaf([k.key for k in p], a), tree)


def test_large_tree_has_the_jax_init_layout():
    tree = testing.hubert_tree(HubertConfig.large(**LARGE), 80,
                               np.random.default_rng(0))
    want = jax.eval_shape(
        EncoderWithHead(JaxConfig.large(**LARGE), out_dim=80).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 3200)))["params"]
    assert jax.tree_util.tree_map(np.shape, tree) == \
        jax.tree_util.tree_map(lambda s: s.shape, want)


@pytest.mark.parametrize("tap_layer", [None, 1])
def test_large_hubert_model_matches_flax(rng, tap_layer):
    tree = jitter(testing.hubert_tree(HubertConfig.large(**LARGE), 80, rng),
                  rng)
    wav = rng.standard_normal((2, 4000)).astype(np.float32) * 0.3
    want = np.asarray(JaxModel(JaxConfig.large(**LARGE)).apply(
        {"params": tree["hubert"]}, jnp.asarray(wav), tap_layer=tap_layer))
    port = hubert_model_from_jax(HubertConfig.large(**LARGE), tree["hubert"],
                                 device="cpu")
    assert port.pre_ln and port.feature_extractor.convs[3].bias is not None
    with torch.no_grad():
        got = port(torch.tensor(wav), tap_layer=tap_layer).numpy()
    assert got.shape == want.shape == (2, 12, 64)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_large_encoder_with_head_matches_flax(rng):
    tree = jitter(testing.hubert_tree(HubertConfig.large(**LARGE), 80, rng),
                  rng)
    wav = rng.standard_normal((2, 4000)).astype(np.float32) * 0.3
    want = np.asarray(EncoderWithHead(JaxConfig.large(**LARGE), out_dim=80)
                      .apply({"params": tree}, jnp.asarray(wav)))
    port = hubert_from_jax(HubertConfig.large(**LARGE), tree, out_dim=80,
                           device="cpu")
    with torch.no_grad():
        got = port(torch.tensor(wav)).numpy()
    assert got.shape == want.shape == (2, 12, 80)
    np.testing.assert_allclose(got, want, atol=1e-4)
