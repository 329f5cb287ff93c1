"""The port's HuBERT-base encoder + head (loaded by convert/from_jax.py)
against the flax EncoderWithHead, on the CPU in float32, at a tiny config
(2 layers, hidden 64, 4 heads, conv_dim 32) with the JAX package's own init,
and an even positional-conv kernel, whose last output frame is dropped.
Tolerance atol 1e-4 on the head's output, which is O(1) after its
LayerNorm; in bfloat16 (flax `dtype=jnp.bfloat16` against the port's
`dtype=torch.bfloat16`: convs and dense layers in bf16, norms, softmax,
residual stream and head in f32 on both sides) rel 3e-2, bench.py's bf16
tolerance."""
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
