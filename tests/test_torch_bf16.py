"""Where the port's bfloat16 paths compute in which type, held against the
flax modules' own split: the HuBERT EncoderWithHead (base and large) and
the HiFi-GAN Generator built with `dtype=jnp.bfloat16` on the JAX side and
`dtype=torch.bfloat16` on the port's, and the GAN trainer's discriminators
with disc_bf16 (bf16 convolutions over float32 parameters).

The outputs alone cannot show the split: the port's bf16 output lies about
as far from flax's bf16 output as from flax's f32 one, since bf16 rounding
dominates both gaps. So each operation where the split matters is counted
by kind and operand types on both sides, and the counts must be equal:
flax's from the jaxpr of its forward (`conv_general_dilated`,
`dot_general`, the `rsqrt` of each normalisation, the `reduce_max` of each
softmax, `tanh`, and the `select_n` of each leaky ReLU), the port's from
the torch calls of its forward (convolutions with their input and weight
types, `linear`, `layer_norm`/`group_norm`, `softmax`, `leaky_relu`,
`tanh`; `scaled_dot_product_attention` counts as its two products in the
inputs' type and a softmax in float32, which is how torch's kernels
compute it for bf16 inputs). A port that ran a norm or a softmax in bf16,
a convolution or a dense layer in f32 (or with bf16 weights and f32
inputs), or skipped one, fails here.

Known differences that the counts do not see: flax rounds attention scores
to bf16 before its f32 softmax, where SDPA keeps them in f32; XLA's CPU
evaluates bf16 elementwise functions (gelu's erf, leaky ReLU's slope 0.1
as a bf16 constant) with other rounding than torch's round-once.
"""
import collections

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.extend
import jax.numpy as jnp

from speech_inpainting_tpu.models.hifigan import Generator
from speech_inpainting_tpu.models.hifigan import HiFiGANConfig as JaxGenConfig
from speech_inpainting_tpu.models.hubert import EncoderWithHead
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxConfig
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (generator_from_jax,
                                                      hubert_from_jax,
                                                      trainable_hubert)
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.models.hubert import HubertConfig

# test_torch_hubert.py's tiny HuBERT and test_torch_hifigan.py's narrow V1
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, conv_dim=(32,) * 7,
            num_conv_pos_embedding_groups=4, num_conv_pos_embeddings=16)
NARROW = dict(upsample_initial_channel=32)

# jaxpr primitive → kind, and which operands it is counted by
_FLAX_KINDS = {"conv_general_dilated": ("conv", 2), "dot_general": ("dot", 2),
               "rsqrt": ("norm", 1), "reduce_max": ("softmax", 1),
               "tanh": ("tanh", 1), "select_n": ("lrelu", 1)}


def _eqns(jaxpr):
    for e in jaxpr.eqns:
        yield e
        for v in e.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    yield from _eqns(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    yield from _eqns(sub)


def _flax_census(apply, *args):
    counts = collections.Counter()
    for e in _eqns(jax.make_jaxpr(apply)(*args).jaxpr):
        if e.primitive.name in _FLAX_KINDS:
            kind, n = _FLAX_KINDS[e.primitive.name]
            # select_n's first operand is the predicate
            ops = e.invars[1:2] if kind == "lrelu" else e.invars[:n]
            counts[(kind, tuple(str(v.aval.dtype) for v in ops))] += 1
    return counts


class _PortCensus(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def _add(self, kind, *tensors):
        self.counts[(kind, tuple(str(t.dtype).removeprefix("torch.")
                                 for t in tensors))] += 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.conv1d, torch.conv2d, torch.conv_transpose1d,
                    torch.nn.functional.linear):
            self._add("conv" if func is not torch.nn.functional.linear
                      else "dot", args[0], args[1])
        elif func in (torch.nn.functional.layer_norm,
                      torch.nn.functional.group_norm):
            self._add("norm", args[0])
        elif func in (torch.softmax, torch.Tensor.softmax,
                      torch.nn.functional.softmax):
            self._add("softmax", args[0])
        elif func is torch.nn.functional.leaky_relu:
            self._add("lrelu", args[0])
        elif func in (torch.tanh, torch.Tensor.tanh):
            self._add("tanh", args[0])
        elif func is torch.nn.functional.scaled_dot_product_attention:
            q, k, v = args[:3]
            self._add("dot", q, k)
            self._add("dot", v, v)
            self.counts[("softmax", ("float32",))] += 1
        return func(*args, **kwargs)


def _port_census(module, *args):
    census = _PortCensus()
    with torch.no_grad(), census:
        module(*args)
    return census.counts


@pytest.mark.parametrize("arrangement", ["base", "large"])
def test_hubert_bf16_computes_in_flax_types(rng, arrangement):
    cfg = getattr(HubertConfig, arrangement)(**TINY)
    params = testing.hubert_tree(cfg, 80, rng)
    wav = rng.standard_normal((2, 4000)).astype(np.float32) * 0.3
    model = EncoderWithHead(
        getattr(JaxConfig, arrangement)(**TINY, dtype=jnp.bfloat16),
        out_dim=80)
    want = _flax_census(model.apply, {"params": params}, jnp.asarray(wav))
    port = hubert_from_jax(
        getattr(HubertConfig, arrangement)(**TINY, dtype=torch.bfloat16),
        params, out_dim=80, device="cpu")
    got = _port_census(port, torch.tensor(wav))
    # the split itself: convs and the encoder's dense layers in bf16, the
    # head in f32, every norm and softmax in f32 (large: a LayerNorm after
    # each of the 7 convs, where base has one GroupNorm)
    assert want[("conv", ("bfloat16", "bfloat16"))] == 8
    assert want[("dot", ("float32", "float32"))] == 1
    assert want[("norm", ("float32",))] == (
        2 * 2 + 3 + (7 if arrangement == "large" else 1))
    assert set(k for k in want if k[0] in ("norm", "softmax")) == {
        ("norm", ("float32",)), ("softmax", ("float32",))}
    assert got == want


@pytest.mark.parametrize("arrangement", ["base", "large"])
def test_masked_training_forward_computes_in_flax_types(rng, arrangement):
    """The trainer's forward: float32 parameters cast to bf16 per call
    (flax's param_dtype/dtype split), weight norm computed per call, and an
    attention mask over rows of two lengths. Counted as above, but for the
    mask's own selects: flax builds a finfo.min bias (and floor-divides the
    lengths with selects) where the port passes a boolean mask to SDPA, so
    `select_n` (counted as "lrelu"; HuBERT has no leaky ReLU) is left out
    on both sides."""
    cfg = getattr(HubertConfig, arrangement)(**TINY, dtype=torch.bfloat16)
    params = testing.hubert_tree(cfg, 80, rng)
    wav = rng.standard_normal((2, 4000)).astype(np.float32) * 0.3
    mask = (np.arange(4000)[None] < np.array([[4000], [2500]])).astype(
        np.int32)
    model = EncoderWithHead(
        getattr(JaxConfig, arrangement)(**TINY, dtype=jnp.bfloat16),
        out_dim=80)
    want = _flax_census(model.apply, {"params": params}, jnp.asarray(wav),
                        jnp.asarray(mask))
    port = trainable_hubert(cfg, params, 80, device="cpu")
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got = _port_census(port, torch.tensor(wav), torch.tensor(mask))
    kept = lambda c: {k: n for k, n in c.items()  # noqa: E731
                      if k[0] != "lrelu"}
    assert want[("lrelu", ("bfloat16",))] == 1   # the features' zeroing
    assert kept(want)[("conv", ("bfloat16", "bfloat16"))] == 8
    assert kept(got) == kept(want)


def test_generator_bf16_computes_in_flax_types(rng):
    params = testing.generator_tree(HiFiGANConfig(**NARROW), rng, carry=True)
    mel = rng.standard_normal((2, 80, 9)).astype(np.float32)
    gen_j = Generator(JaxGenConfig(**NARROW, dtype=jnp.bfloat16))
    want = _flax_census(gen_j.apply, {"params": params}, jnp.asarray(mel))
    gen = generator_from_jax(HiFiGANConfig(**NARROW, dtype=torch.bfloat16),
                             jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")
    got = _port_census(gen, torch.tensor(mel))
    assert set(want) == {("conv", ("bfloat16", "bfloat16")),
                         ("lrelu", ("bfloat16",)), ("tanh", ("bfloat16",))}
    assert got == want


@pytest.mark.parametrize("which", ["mpd", "msd"])
def test_disc_bf16_convs_compute_in_flax_types(rng, which):
    """GANConfig.disc_bf16: every discriminator convolution (1-D and the
    MPD's 2-D) takes bf16 inputs and a bf16 kernel, and every leaky ReLU a
    bf16 input, on both sides; the parameters stay float32. The MSD's
    power iteration (float32 products, which the port computes with
    matmul, not counted) is left out: only conv and lrelu are compared."""
    from speech_inpainting_tpu.models import hifigan as jh
    from speech_inpainting_torch.convert.from_jax import (mpd_from_jax,
                                                          mpd_tree,
                                                          msd_from_jax,
                                                          msd_tree,
                                                          spectral_tree)
    y, y_hat = (rng.standard_normal((2, 2, 1, 2048)).astype(np.float32)
                * 0.3)
    gen = torch.Generator().manual_seed(0)
    if which == "mpd":
        port = mpd_from_jax(None, dtype=torch.bfloat16, device="cpu",
                            generator=gen)
        want = _flax_census(
            lambda p, a, b: jh.MultiPeriodDiscriminator(
                dtype=jnp.bfloat16).apply({"params": p}, a, b),
            mpd_tree(port), y, y_hat)
    else:
        port = msd_from_jax(None, dtype=torch.bfloat16, device="cpu",
                            generator=gen)
        want = _flax_census(
            lambda p, s, a, b: jh.MultiScaleDiscriminator(
                dtype=jnp.bfloat16).apply({"params": p, "spectral": s}, a, b,
                                          True, mutable=["spectral"]),
            msd_tree(port), spectral_tree(port), y, y_hat)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got = _port_census(port, torch.tensor(y), torch.tensor(y_hat))
    kept = lambda c: {k: n for k, n in c.items()  # noqa: E731
                      if k[0] in ("conv", "lrelu")}
    n_convs = 2 * (5 * 6 if which == "mpd" else 3 * 8)
    assert kept(want) == {("conv", ("bfloat16", "bfloat16")): n_convs,
                          ("lrelu", ("bfloat16",)): n_convs - (
                              10 if which == "mpd" else 6)}
    assert kept(got) == kept(want)
