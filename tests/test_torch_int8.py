"""The port's int8 serving option (ops/int8.py, `HubertConfig.int8`)
against the JAX package's, on the CPU:

- `quantize_rows` and `quantize_cols`: codes and scales bit-equal (the same
  float32 division, half-to-even rounding and clip);
- `dynamic_int8_dot`: equal to float32 rounding (rtol 1e-6; the int32 sums
  are exact and the rescale is the same two float32 products), also where
  the operands are padded for `torch._int_mm` (rows ≤ 16, K and N not
  multiples of 8) and for a 3-D input;
- `Int8Linear` takes the port's `Dense` parameters as they are;
- the int8 encoder (tests/test_int8.py's geometry: two layers, hidden 16)
  in float32 and bfloat16 within tests/test_int8.py's rel 0.05 of the
  port's own float32 encoder, and against JAX's int8 encoder at rel 1e-2
  in float32 and 2e-2 in bfloat16. The float32 encoders agree to float32
  rounding without int8, but a rounding gap in an activation moves a code
  across a rounding boundary now and then, one step of 1/127 of its row's
  largest, and the two layers carry it to the whole utterance (these
  inputs read 2.7e-3). In bfloat16 the two frameworks round at different
  places before the quantizer.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.models.hubert import EncoderWithHead as JaxEnc
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_tpu.ops import int8 as jint8
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import hubert_from_jax
from speech_inpainting_torch.models.hubert import Dense, HubertConfig
from speech_inpainting_torch.ops import int8

# tests/test_int8.py:test_encoder_int8_flag_same_params_close_output
HUB = dict(conv_dim=(8,) * 7, hidden_size=16, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=24,
           num_conv_pos_embeddings=15, num_conv_pos_embedding_groups=1)


def _rows(rng):
    x = rng.standard_normal((5, 64)).astype(np.float32) * np.array(
        [1e-3, 1.0, 50.0, 1.0, 1.0], np.float32)[:, None]
    x[3] = 0.0                                   # an all-zero row
    return x


def test_quantizers_bit_equal_jax():
    rng = np.random.default_rng(0)
    x = _rows(rng)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    w[:, 5] = 0.0                                # an all-zero column
    for port, ref, a in ((int8.quantize_rows, jint8.quantize_rows, x),
                         (int8.quantize_cols, jint8.quantize_cols, w)):
        q, s = port(torch.tensor(a))
        qj, sj = ref(jnp.asarray(a))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    q, _ = int8.quantize_rows(torch.tensor(x))
    assert q.abs().max() <= 127 and not q[3].any()


@pytest.mark.parametrize("shape", [(40, 256, 128), (5, 20, 12),
                                   ((2, 3), 24, 40)])
def test_dynamic_int8_dot_matches_jax(shape):
    rows, K, N = shape
    rows = rows if isinstance(rows, tuple) else (rows,)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((*rows, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    got = int8.dynamic_int8_dot(torch.tensor(x), torch.tensor(w))
    want = np.asarray(jint8.dynamic_int8_dot(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == want.shape == (*rows, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    bf = int8.dynamic_int8_dot(torch.tensor(x), torch.tensor(w),
                               torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(), got.bfloat16()
                                  .float().numpy())


def test_int8_linear_takes_dense_parameters():
    dense = Dense(24, 8, torch.float32)
    q = int8.Int8Linear(24, 8, torch.float32)
    q.load_state_dict(dense.state_dict())
    assert isinstance(q, Dense)
    x = torch.tensor(np.random.default_rng(2).standard_normal((3, 24)),
                     dtype=torch.float32)
    with torch.no_grad():
        want, got = dense(x), q(x)
    assert (torch.linalg.norm(got - want) / torch.linalg.norm(want)) < 0.02


def _tree(rng, cfg):
    """testing.hubert_tree with every bias drawn N(0, 0.1)."""
    def fill(t):
        return {k: (fill(v) if isinstance(v, dict) else
                    (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                    if k == "bias" else v) for k, v in t.items()}
    return fill(testing.hubert_tree(cfg, 12, rng))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype,jtol", [("float32", 1e-2),
                                        ("bfloat16", 2e-2)])
def test_int8_encoder_close_to_f32_and_to_jax(dtype, jtol):
    rng = np.random.default_rng(3)
    tree = _tree(rng, HubertConfig.base(**HUB))
    wav = (rng.standard_normal((2, 6400)) * 0.1).astype(np.float32)
    tdt = getattr(torch, dtype)

    def port(**over):
        model = hubert_from_jax(HubertConfig.base(**HUB, **over), tree,
                                out_dim=12, device="cpu")
        with torch.no_grad():
            return model(torch.tensor(wav)).float().numpy()

    f32 = port()
    got = port(dtype=tdt, int8=True)
    assert got.shape == f32.shape == (2, 19, 12)
    assert _rel(got, f32) < 0.05
    jcfg = dataclasses.replace(JaxHub.base(**HUB, dtype=getattr(jnp, dtype)),
                               int8=True)
    want = np.asarray(jax.jit(JaxEnc(jcfg, out_dim=12).apply)(
        {"params": tree}, jnp.asarray(wav)), np.float32)
    assert _rel(got, want) < jtol, _rel(got, want)
