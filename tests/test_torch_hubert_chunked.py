"""`models/hubert.py:extract_features_chunked` against the JAX package's,
on the CPU at tests/test_hubert.py:test_chunked_feature_extraction's
geometry (TINY_BASE: three convs, hidden 16, two layers) and inputs: 4000
samples in chunks of 2000, atol 1e-5 (the headless models agree to float32
rounding), with and without a tapped layer; a 5-sample input, shorter than
one receptive field, gives (0, hidden)."""
import numpy as np
import pytest

import jax

from speech_inpainting_tpu.models import hubert as jhub
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import hubert_model_from_jax
from speech_inpainting_torch.models.hubert import (HubertConfig,
                                                    extract_features_chunked)

TINY_BASE = dict(conv_dim=(8, 8, 8), conv_stride=(5, 2, 2),
                 conv_kernel=(10, 3, 3), hidden_size=16, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=24,
                 num_conv_pos_embeddings=15, num_conv_pos_embedding_groups=1)


@pytest.mark.parametrize("tap_layer", [None, 1])
def test_chunked_features_match_jax(tap_layer):
    rng = np.random.default_rng(0)
    cfg = HubertConfig.base(**TINY_BASE)
    tree = testing.hubert_model_tree(cfg, rng)
    wav = rng.standard_normal(4000).astype(np.float32) * 0.1
    model = hubert_model_from_jax(cfg, tree, device="cpu")
    got = extract_features_chunked(model, wav, tap_layer=tap_layer,
                                   chunk=2000, device="cpu")
    jmodel = jhub.HubertModel(jhub.HubertConfig(**TINY_BASE))
    apply = jax.jit(jmodel.apply, static_argnames="tap_layer")

    class Jitted:  # the JAX function applies `model.apply`; jit it
        cfg = jmodel.cfg

        @staticmethod
        def apply(variables, x, tap_layer=None):
            return apply(variables, x, tap_layer=tap_layer)

    want = jhub.extract_features_chunked(Jitted, tree, wav,
                                         tap_layer=tap_layer, chunk=2000)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    per_chunk = int(cfg.feature_lengths(2000))
    assert got.shape == want.shape == (2 * per_chunk, 16)
    np.testing.assert_allclose(got, want, atol=1e-5)
    tail = extract_features_chunked(model, wav[:5], chunk=2000, device="cpu")
    assert tail.shape == (0, cfg.hidden_size) and tail.dtype == np.float32
