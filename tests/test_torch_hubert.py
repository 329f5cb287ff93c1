"""The port's HuBERT-base encoder + head (loaded by convert/from_jax.py)
against the flax EncoderWithHead, on the CPU in float32, at a tiny config
(2 layers, hidden 64, 4 heads, conv_dim 32) with the JAX package's own init,
and an even positional-conv kernel, whose last output frame is dropped.
Tolerance atol 1e-4 on the head's output, which is O(1) after its
LayerNorm."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.models.hubert import EncoderWithHead
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxConfig
from speech_inpainting_torch.convert.from_jax import hubert_from_jax
from speech_inpainting_torch.models.hubert import HubertConfig

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, conv_dim=(32,) * 7,
            num_conv_pos_embedding_groups=4)


def test_encoder_with_head_matches_flax(rng):
    over = dict(TINY, num_conv_pos_embeddings=16)
    wav = rng.standard_normal((2, 4000)).astype(np.float32) * 0.3
    model = EncoderWithHead(JaxConfig.base(**over), out_dim=80)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(wav))["params"]
    want = np.asarray(jax.jit(model.apply)({"params": params},
                                           jnp.asarray(wav)))
    port = hubert_from_jax(HubertConfig.base(**over),
                           jax.tree_util.tree_map(np.asarray, params),
                           out_dim=80, device="cpu")
    with torch.no_grad():
        got = port(torch.tensor(wav)).numpy()
    assert got.shape == want.shape == (2, 12, 80)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert port.hubert.pos_conv_embed.drop_last
