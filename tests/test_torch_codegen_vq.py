"""The port's VQ eval forwards, jukebox Decoder, FoVQVAE and the
CodeGenerator's content-VQ regime against the JAX package's flax modules,
on the CPU in float32, at small widths with the same numpy trees.

Tolerances: codes and units must agree exactly (the codebooks are drawn
N(0, 1), their nearest entries far apart at these widths, and the margin is
asserted); real outputs at atol 1e-5 (float32 rounding of convolution sums
of a few hundred terms), the waveforms of the content-VQ generator at 1e-4,
the I_da generator tests' tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.models import codegen as jcodegen
from speech_inpainting_tpu.models import jukebox as jjukebox
from speech_inpainting_tpu.quantize.vq import Bottleneck as JaxBottleneck
from speech_inpainting_tpu.quantize.vq import (
    EMAVectorQuantizer as JaxQuantizer)
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (_load_plain,
                                                      codegen_from_jax,
                                                      fo_vqvae_from_jax)
from speech_inpainting_torch.models import codegen, jukebox
from speech_inpainting_torch.quantize.kmeans import pairwise_sqdist
from speech_inpainting_torch.quantize.vq import Bottleneck, EMAVectorQuantizer

ONE = dict(input_emb_width=1, output_emb_width=16, levels=1, downs_t=(2,),
           strides_t=(2,), width=8, depth=2, dilation_growth_rate=3)
# two levels (stride 2 then 3) with a reversed-dilation decoder: the skip
# addition needs each transposed conv's padding right
TWO = dict(ONE, levels=2, downs_t=(2, 1), strides_t=(2, 3),
           reverse_decoder_dilation=True)
# tests/test_codegen.py::test_content_vq_regime's geometry, as a config
CONTENT_VQ = {
    "resblock": "1", "upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
    "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
    "resblock_dilation_sizes": [[1, 3]], "model_in_dim": 16,
    "sampling_rate": 16000, "num_embeddings": 6, "embedding_dim": 16,
    "lambda_commit_code": 1.0,
    "code_encoder_params": dict(ONE, depth=1),
    "code_vq_params": {"l_bins": 6, "emb_width": 16}}


def _close(got, want, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("width", [16, 32])     # emb_width, 2·emb_width
def test_quantizer_eval_forward_matches_jax(rng, width):
    vq = testing.vq_collection(rng, 1, 6, 16)["level_0"]
    x = rng.standard_normal((2, width, 9)).astype(np.float32)
    labels, x_q, commit, metrics = JaxQuantizer(6, 16).apply(
        {"vq": vq}, jnp.asarray(x))
    port = EMAVectorQuantizer(6, 16)
    port.k.copy_(torch.tensor(vq["k"]))
    got = port(torch.tensor(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(labels))
    _close(got[1], x_q)
    # the straight-through output in eval is the codebook rows
    np.testing.assert_array_equal(got[1].numpy(),
                                  port.decode(got[0]).numpy())
    _close(got[2], commit)
    assert sorted(got[3]) == sorted(metrics) == ["fit", "pn"]
    for k in metrics:
        _close(got[3][k], metrics[k])
    # the training forward (tests/test_torch_vq_train.py) now runs
    train = port(torch.tensor(x), train=True,
                 generator=torch.Generator().manual_seed(0))
    assert sorted(train[3]) == ["dk", "entropy", "fit", "pn", "usage",
                                "used_curr"]


def test_bottleneck_eval_forward_matches_jax(rng):
    vq = testing.vq_collection(rng, 2, 6, 16)
    xs = [rng.standard_normal((2, 16, t)).astype(np.float32) for t in (12, 4)]
    jb = JaxBottleneck(2, 6, 16)
    want = jb.apply({"vq": vq}, [jnp.asarray(x) for x in xs], train=False)
    port = Bottleneck(2, 6, 16)
    for i in range(2):
        getattr(port, f"level_{i}").k.copy_(
            torch.tensor(vq[f"level_{i}"]["k"]))
    got = port([torch.tensor(x) for x in xs])
    assert len(got) == 4 and all(len(g) == 2 for g in got)
    for z, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(z.numpy(), np.asarray(w))
    for a, b in zip(got[1], want[1]):
        _close(a, b)
    for a, b in zip(got[2], want[2]):
        _close(a, b)
    for a, b in zip(got[3], want[3]):
        _close(a["fit"], b["fit"])
        _close(a["pn"], b["pn"])


@pytest.mark.parametrize("stack", [ONE, TWO], ids=["one_level", "two_level"])
def test_decoder_matches_jax(rng, stack):
    cfg = jukebox.ConvStackConfig(**stack)
    jcfg = jjukebox.ConvStackConfig(**stack)
    # each level's latent: 12 frames over the strides down to it
    lengths = np.cumprod([s ** d for s, d in zip(cfg.strides_t, cfg.downs_t)])
    xs = [rng.standard_normal((2, 16, 12 // t)).astype(np.float32)
          for t in lengths]
    tree = testing.jukebox_tree(cfg, rng, decoder=True)
    shapes = jax.eval_shape(jjukebox.Decoder(jcfg).init,
                            jax.random.PRNGKey(0),
                            [jnp.asarray(x) for x in xs])["params"]
    assert (jax.tree_util.tree_map(np.shape, tree)
            == jax.tree_util.tree_map(lambda s: s.shape, shapes))
    want = jjukebox.Decoder(jcfg).apply({"params": tree},
                                        [jnp.asarray(x) for x in xs])
    port = jukebox.Decoder(cfg)
    with torch.no_grad():
        _load_plain(port, tree)
        got = port([torch.tensor(x) for x in xs])
    assert got.shape == want.shape == (2, 1, 12)
    _close(got, want)
    with pytest.raises(ValueError):
        port(xs[:1] if cfg.levels == 2 else xs * 2)


@pytest.mark.parametrize("stack", [ONE, TWO], ids=["one_level", "two_level"])
def test_fo_vqvae_forward_matches_jax(rng, stack):
    cfg = codegen.FoVQVAEConfig(
        encoder=jukebox.ConvStackConfig(**stack),
        decoder=jukebox.ConvStackConfig(**stack), l_bins=6, emb_width=16,
        levels=len(stack["downs_t"]))
    jcfg = jcodegen.FoVQVAEConfig(
        encoder=jjukebox.ConvStackConfig(**stack),
        decoder=jjukebox.ConvStackConfig(**stack), l_bins=6, emb_width=16,
        levels=len(stack["downs_t"]))
    params, vq = testing.fo_vqvae_tree(cfg, rng)
    f0 = rng.standard_normal((2, 1, 24)).astype(np.float32)
    jm = jcodegen.FoVQVAE(jcfg)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0),
                                      "vq": jax.random.PRNGKey(1)},
                            jnp.asarray(f0))
    assert (jax.tree_util.tree_map(np.shape, (params, vq))
            == jax.tree_util.tree_map(lambda s: s.shape,
                                      (shapes["params"], shapes["vq"])))
    out, commits, metrics = jm.apply({"params": params, "vq": vq},
                                     jnp.asarray(f0))
    want_units = jm.apply({"params": params, "vq": vq}, jnp.asarray(f0),
                          method=jm.encode_units)
    port = fo_vqvae_from_jax(cfg, params, vq, device="cpu")
    with torch.no_grad():
        got, got_commits, got_metrics = port(torch.tensor(f0))
        units = port.encode_units(torch.tensor(f0))
    assert got.shape == out.shape == f0.shape
    _close(got, out)
    np.testing.assert_array_equal(units.numpy(), np.asarray(want_units))
    for a, b in zip(got_commits, commits):
        _close(a, b)
    for a, b in zip(got_metrics, metrics):
        _close(a["fit"], b["fit"])


def test_content_vq_regime_matches_jax(rng):
    cfg = codegen.CodeGeneratorConfig.from_dict(CONTENT_VQ)
    jcfg = jcodegen.CodeGeneratorConfig.from_dict(CONTENT_VQ)
    params, vq = testing.codegen_tree(cfg, rng)
    x = (0.5 * rng.standard_normal((2, 1, 64))).astype(np.float32)
    jm = jcodegen.CodeGenerator(jcfg)
    variables = {"params": params, "vq": vq}
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0),
                                      "vq": jax.random.PRNGKey(1)},
                            jnp.asarray(x))
    assert (jax.tree_util.tree_map(np.shape, (params, vq))
            == jax.tree_util.tree_map(lambda s: s.shape,
                                      (shapes["params"], shapes["vq"])))
    wav, commit, metrics = jm.apply(variables, jnp.asarray(x))
    units = jm.apply(variables, jnp.asarray(x), method=jm.encode_codes)
    wav_u, commit_u, metrics_u = jm.apply(variables, units)
    port = codegen_from_jax(cfg, params, vq, device="cpu")
    assert not hasattr(port, "emb_c")
    with torch.no_grad():
        got_units = port.encode_codes(torch.tensor(x))
        feats = port.code_encoder(torch.tensor(x))[0]
        got, got_commit, got_metrics = port(torch.tensor(x))
        got_u, got_commit_u, got_metrics_u = port(got_units)
    # units far from a tie
    d = pairwise_sqdist(feats.transpose(1, 2).reshape(-1, 16),
                        port.code_vq.level_0.k).sort(-1).values
    assert (d[:, 1] - d[:, 0]).min() > 1e-3
    assert got_units.shape == units.shape == (2, 16)
    np.testing.assert_array_equal(got_units.numpy(), np.asarray(units))
    assert got.shape == wav.shape == (2, 1, 64)
    assert np.abs(np.asarray(wav)).std() > 0.05   # not a silent waveform
    _close(got, wav, atol=1e-4)
    _close(got_commit, commit)
    _close(got_metrics["fit"], metrics["fit"])
    _close(got_metrics["pn"], metrics["pn"])
    # integer units dequantize through the codebook: no commit term
    assert got_commit_u is None and commit_u is None
    assert got_metrics_u == {} and metrics_u == {}
    _close(got_u, wav_u, atol=1e-4)
    # a d-vector is concatenated after the content features
    h = dict(CONTENT_VQ, model_in_dim=24)
    cfg2 = codegen.CodeGeneratorConfig.from_dict(h)
    params2, vq2 = testing.codegen_tree(cfg2, rng)
    emb = rng.standard_normal((2, 8)).astype(np.float32)
    want2 = jcodegen.CodeGenerator(jcodegen.CodeGeneratorConfig.from_dict(
        h)).apply({"params": params2, "vq": vq2}, units,
                  emb=jnp.asarray(emb))[0]
    with torch.no_grad():
        got2 = codegen_from_jax(cfg2, params2, vq2, device="cpu")(
            got_units, emb=torch.tensor(emb))[0]
    _close(got2, want2, atol=1e-4)
