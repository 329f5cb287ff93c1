"""The port's HiFi-GAN generator (FastGenerator over weights folded by
convert/from_jax.py) against the flax Generator, on the CPU in float32,
atol 1e-4: a narrow V1-shaped config, and the trained width-192 proxy whose
numpy pickle the repo keeps. In bfloat16 (flax `dtype=jnp.bfloat16` against
the port's `dtype=torch.bfloat16`, whose ResBlock1s run their plain version
on the CPU) rel 3e-2, bench.py's bf16 tolerance, with weights that carry
the signal through every stage.

The narrow config's weights are speech_inpainting_torch/testing.py's numpy
tree, checked here against the names and shapes of the JAX package's init by
abstract evaluation: compiling that init for V1's graph takes ~26 s on a
CPU, most of this suite's time budget."""
import json
import pickle
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.models.hifigan import Generator
from speech_inpainting_tpu.models.hifigan import HiFiGANConfig as JaxConfig
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import generator_from_jax
from speech_inpainting_torch.models.hifigan import Generator as Generator_
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.models.hifigan_fast import FastGenerator

ROOT = Path(__file__).resolve().parents[1]

NARROW = dict(upsample_initial_channel=32)
# examples/eval_e2e.py:small_hifigan_22k, the config of eval_r5/hifigan_v1_g.pkl
PROXY = dict(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
             upsample_initial_channel=192, resblock_kernel_sizes=(3, 7),
             resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _compare(over, params, mel):
    gen_j = Generator(JaxConfig(**over))
    want = np.asarray(jax.jit(gen_j.apply)({"params": params},
                                           jnp.asarray(mel)))
    gen = generator_from_jax(HiFiGANConfig(**over), _np_tree(params),
                             device="cpu")
    with torch.no_grad():
        got = gen(torch.tensor(mel)).numpy()
        gen.use_kernel = False       # the plain route is the same on the CPU
        np.testing.assert_array_equal(gen(torch.tensor(mel)).numpy(), got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_narrow_v1_matches_flax(rng):
    mel = rng.standard_normal((2, 80, 9)).astype(np.float32)
    params = testing.generator_tree(HiFiGANConfig(**NARROW), rng)
    shapes = jax.eval_shape(Generator(JaxConfig(**NARROW)).init,
                            jax.random.PRNGKey(0), jnp.asarray(mel))["params"]
    assert (jax.tree_util.tree_map(np.shape, params)
            == jax.tree_util.tree_map(lambda s: s.shape, shapes))
    _compare(NARROW, params, mel)


def test_narrow_v1_matches_flax_in_bf16(rng):
    mel = rng.standard_normal((2, 80, 9)).astype(np.float32)
    params = testing.generator_tree(HiFiGANConfig(**NARROW), rng, carry=True)
    gen_j = Generator(JaxConfig(**NARROW, dtype=jnp.bfloat16))
    want = np.asarray(jax.jit(gen_j.apply)({"params": params},
                                           jnp.asarray(mel)), np.float32)
    gen = generator_from_jax(HiFiGANConfig(**NARROW, dtype=torch.bfloat16),
                             _np_tree(params), device="cpu")
    assert gen.resblocks[0]["w1"].dtype == torch.bfloat16
    with torch.no_grad():
        got = gen(torch.tensor(mel)).float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() <= 3e-2


def test_trained_proxy_pickle_matches_flax(rng):
    with open(ROOT / "eval_r5" / "hifigan_v1_g.pkl", "rb") as f:
        params = pickle.load(f)
    mel = rng.standard_normal((1, 80, 6)).astype(np.float32) - 4.0
    _compare(PROXY, params, mel)


def test_config_from_v1_json():
    with open(ROOT / "configs" / "hifigan_v1.json") as f:
        h = json.load(f)
    got, want = HiFiGANConfig.from_dict(h), JaxConfig.from_dict(h)
    for field in ("resblock", "upsample_rates", "upsample_kernel_sizes",
                  "upsample_initial_channel", "resblock_kernel_sizes",
                  "resblock_dilation_sizes", "in_dim", "sampling_rate"):
        assert getattr(got, field) == getattr(want, field), field
    assert got == HiFiGANConfig() and got.total_upsample == 256


# configs/hifigan_v3.json at width 32: ResBlock2, kernel sizes 3/5/7
V3_NARROW = dict(resblock="2", upsample_rates=(8, 8, 4),
                 upsample_kernel_sizes=(16, 16, 8),
                 upsample_initial_channel=32,
                 resblock_kernel_sizes=(3, 5, 7),
                 resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))


def test_resblock2_is_refused(rng):
    """Once refused, ResBlock2 (config V3) now runs: the port's generators
    (FastGenerator and the K2 `Generator`, whose ResBlock2s are torch
    convolutions in both) against flax's V3 at width 32, with weights that
    carry the signal through every block, atol 1e-4."""
    with open(ROOT / "configs" / "hifigan_v3.json") as f:
        h = json.load(f)
    assert HiFiGANConfig.from_dict(h) == HiFiGANConfig(
        **dict(V3_NARROW, upsample_initial_channel=256))
    mel = rng.standard_normal((2, 80, 7)).astype(np.float32)
    params = testing.generator_tree(HiFiGANConfig(**V3_NARROW), rng,
                                    carry=True)
    shapes = jax.eval_shape(Generator(JaxConfig(**V3_NARROW)).init,
                            jax.random.PRNGKey(0), jnp.asarray(mel))["params"]
    assert (jax.tree_util.tree_map(np.shape, params)
            == jax.tree_util.tree_map(lambda s: s.shape, shapes))
    want = np.asarray(jax.jit(Generator(JaxConfig(**V3_NARROW)).apply)(
        {"params": params}, jnp.asarray(mel)))
    assert want.shape == (2, 1, 7 * 256)
    assert np.abs(want).std() > 0.05          # not a silent waveform
    for cls in (FastGenerator, Generator_):
        gen = generator_from_jax(HiFiGANConfig(**V3_NARROW), params,
                                 device="cpu", cls=cls)
        assert set(gen.resblocks[0]) == {"w", "b"}
        with torch.no_grad():
            got = gen(torch.tensor(mel)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
