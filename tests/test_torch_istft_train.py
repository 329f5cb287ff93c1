"""The iSTFT-head generator's training (models/hifigan_istft.py:
WNISTFTGenerator, convert/from_jax.py:trainable_istft_generator and
istft_generator_tree) against the JAX package's, on the CPU in float32,
from the same numpy trees and batches:
  - `istft_overlap_add`'s VJP against `jax.vjp` at n_fft 16, hop 4 (atol
    1e-6 on unit-scale spectra);
  - the trainable generator's waveform against JAX's `ISTFTGenerator`
    (atol 2e-5), its `fold()` equal to it within 1e-6 and bit-equal to
    `istft_generator_from_jax` of the same tree, the tree round trip
    exact; and past the head's clip (log-magnitudes beyond ±20) the same
    waveform as JAX's (rtol 1e-5 of e^20-scale samples) with no gradient
    into the clipped channels;
  - one vanilla and one modified-recipe GAN step with the iSTFT generator
    against JAX's `make_vanilla_step(generator=…)` / `make_modified_step(
    generator=…)`, MPD periods (2, 3) and one MSD scale (as
    tests/test_istft_gen.py), by test_torch_gan_step.py's `check_step`
    (metrics rel 1e-5; every parameter, moment and u/v by
    testing.parity_gate beside the port's float64 step);
  - the validation sweep's `fold()` between two steps leaves the second
    step bit-equal to one without it;
  - the overfit case of tests/test_istft_gen.py: mel error falls over 15
    steps on one batch (of one 1024-sample item, where JAX's tiles a
    2048-sample one four times and takes 30 steps).
The trunk is two stages of 16 and 8 channels at upsample (2, 2), so that
with the hop-4 head it upsamples 16×, test_torch_gan_step.py's mel hop.
JAX's generator is initialised and applied under one `jax.jit` each,
shared by the tests through a module fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_inpainting_tpu.models import hifigan as jh
from speech_inpainting_tpu.models import hifigan_istft as ji
from speech_inpainting_tpu.ops.stft import istft_overlap_add as jistft
from speech_inpainting_tpu.train import hifigan as jhg
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (
    istft_generator_from_jax, istft_generator_tree, mpd_from_jax,
    mpd_tree, msd_from_jax, msd_tree, spectral_tree,
    trainable_istft_generator)
from speech_inpainting_torch.models import hifigan_istft as pi
from speech_inpainting_torch.ops import mel as pmel
from speech_inpainting_torch.ops.stft import istft_overlap_add as pistft
from speech_inpainting_torch.train import gan as pgan
from speech_inpainting_torch.train import hifigan as phg
from test_torch_gan_models import _two_threads  # noqa: F401
from test_torch_gan_step import (batches, check_step, configs, f64_batch,
                                 jax_states, to_f64)

ICFG = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),))
PERIODS, SCALES = (2, 3), 1


def icfgs(**kw):
    return ji.ISTFTGeneratorConfig(**ICFG, **kw), \
        pi.ISTFTGeneratorConfig(**ICFG, **kw)


def istft_trees(seed):
    """(generator, MPD, MSD, spectral) numpy trees: the generator drawn to
    carry its input (testing.generator_tree's carry=True), the reduced
    discriminators the port's init."""
    gen = testing.generator_tree(icfgs()[1], np.random.default_rng(seed),
                                 carry=True)
    mpd = mpd_from_jax(None, PERIODS, device="cpu",
                       generator=torch.Generator().manual_seed(seed + 1))
    msd = msd_from_jax(None, None, SCALES, device="cpu",
                       generator=torch.Generator().manual_seed(seed + 2))
    return gen, mpd_tree(mpd), msd_tree(msd), spectral_tree(msd)


def port_state(pcfg, tree, f64=False):
    g, mp, mv, spec = tree
    state = pgan.create_gan_state(
        pcfg.gan, trainable_istft_generator(icfgs()[1], g, device="cpu"),
        mpd_from_jax(mp, PERIODS, device="cpu"),
        msd_from_jax(mv, spec, SCALES, device="cpu"))
    return to_f64(state) if f64 else state


def compare_step(jcfg, pcfg, tree, jmake, pmake, batch):
    """One step of each side from `tree` on `batch`, held by check_step
    beside the port's float64 step. jmake(cfg, generator=, mpd=, msd=)
    builds JAX's step, pmake(cfg) the port's."""
    gen = ji.ISTFTGenerator(icfgs()[0])
    mpd = jh.MultiPeriodDiscriminator(periods=PERIODS)
    msd = jh.MultiScaleDiscriminator(scales=SCALES)
    (js, jm), = jax_states(
        jcfg, tree, lambda c, **_: jmake(c, generator=gen, mpd=mpd, msd=msd),
        [batch])
    step = pmake(pcfg)
    ps, pm = step(port_state(pcfg, tree), batch)
    ref, _ = step(port_state(pcfg, tree, f64=True), f64_batch(batch))
    print("outside both gates:", check_step(js, jm, ps, pm, ref))
    return ps


def test_istft_vjp_matches_jax(rng):
    re, im = (rng.standard_normal((2, 9, 40)).astype(np.float32)
              for _ in range(2))
    ct = rng.standard_normal((2, 39 * 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jistft(a, b, n_fft=16, hop=4),
                        jnp.asarray(re), jnp.asarray(im))
    a, b = (torch.tensor(x, requires_grad=True) for x in (re, im))
    got = pistft(a, b, n_fft=16, hop=4)
    (got * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    for g, w in zip((a.grad, b.grad), vjp(jnp.asarray(ct))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.fixture(scope="module")
def jax_generator():
    """(port config, numpy tree, jitted JAX apply) of a 32-wide generator
    drawn by JAX's init."""
    jcfg, pcfg = (dataclasses.replace(c, upsample_initial_channel=32)
                  for c in icfgs())
    jgen = ji.ISTFTGenerator(jcfg)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 80, 8)))["params"]
    apply = jax.jit(lambda p, x: jgen.apply({"params": p}, x))
    return pcfg, jax.tree.map(np.asarray, params), apply


def test_trainable_generator_matches_jax(rng, jax_generator):
    pcfg, tree, apply = jax_generator
    x = rng.standard_normal((2, 80, 13)).astype(np.float32)
    want = np.asarray(apply(tree, jnp.asarray(x)))
    gen = trainable_istft_generator(pcfg, tree, device="cpu")
    got = gen(torch.tensor(x))
    assert got.shape == want.shape == (2, 1, 13 * pcfg.total_upsample)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5)
    folded = gen.fold()
    assert isinstance(folded, pi.ISTFTGenerator)
    assert not any(p.requires_grad for p in folded.parameters())
    with torch.no_grad():
        fx = folded(torch.tensor(x))
        np.testing.assert_allclose(fx.numpy(), got.detach().numpy(),
                                   atol=1e-6)
        assert torch.equal(fx, istft_generator_from_jax(
            pcfg, tree, device="cpu")(torch.tensor(x)))
    # the tree round trip, and the gradients' tree laid out as JAX's
    back = istft_generator_tree(gen)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    got.square().mean().backward()
    grads = istft_generator_tree(gen, of=lambda p: p.grad)
    assert jax.tree.map(np.shape, grads) == jax.tree.map(np.shape, tree)
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(grads))
    # a fresh init drawn as the JAX package's: HiFi-GAN's N(0, 0.01)
    # conv_post with n_fft + 2 outputs, g = ‖v‖ per row
    fresh = istft_generator_tree(trainable_istft_generator(
        pcfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    assert jax.tree.map(np.shape, fresh) == jax.tree.map(np.shape, tree)
    v = fresh["conv_post"]["v"]
    assert v.shape[0] == pcfg.istft_n_fft + 2 and 0.009 < v.std() < 0.011
    np.testing.assert_allclose(fresh["conv_post"]["g"],
                               np.sqrt((v * v).sum(axis=(1, 2))), rtol=1e-6)


def test_magnitude_clip_matches_jax(rng, jax_generator):
    """conv_post's magnitude biases at ±30, past the head's clip at ±20:
    the waveform (samples up to ~e^20) equal to JAX's within rtol 1e-5 of
    its largest sample, and no gradient reaches a bias whose every
    log-magnitude lies past the clip (JAX's clip passes none there)."""
    pcfg, tree, apply = jax_generator
    n_freq = pcfg.istft_n_fft // 2 + 1
    tree = jax.tree.map(np.copy, tree)
    b = tree["conv_post"]["b"]
    b[:n_freq] = np.where(np.arange(n_freq) % 2, 30.0, -30.0)
    x = rng.standard_normal((1, 80, 9)).astype(np.float32)
    want = np.asarray(apply(tree, jnp.asarray(x)))
    gen = trainable_istft_generator(pcfg, tree, device="cpu")
    got = gen(torch.tensor(x))
    scale = float(np.abs(want).max())
    assert scale > np.exp(19)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    (got / scale).sum().backward()
    with torch.no_grad():
        pre = gen.conv_post(gen.trunk(torch.tensor(x)))[0, :n_freq]
    past = (pre.abs() > 20).all(dim=-1)
    assert past.any()
    grad = gen.conv_post.bias.grad[:n_freq]
    assert torch.equal(grad[past], torch.zeros_like(grad[past]))
    assert gen.conv_post.bias.grad[n_freq:].abs().max() > 0


def test_vanilla_step_matches_jax(rng):
    jcfg, pcfg = configs()
    ps = compare_step(jcfg, pcfg, istft_trees(3), jhg.make_vanilla_step,
                      phg.make_vanilla_step, batches(rng, 1)[0])
    assert ps.step == 1


def test_modified_step_matches_jax(rng):
    jcfg, pcfg = configs(mask_len=2)
    C = rng.standard_normal((10, 80)).astype(np.float32)
    compare_step(jcfg, pcfg, istft_trees(5),
                 lambda c, **kw: jhg.make_modified_step(c, C, **kw),
                 lambda c: phg.make_modified_step(c, C),
                 batches(rng, 1, mask=True)[0])


def test_sweep_fold_leaves_the_step_alone(rng):
    """The validation sweep folds the trained generator (`fold()`, under
    no_grad) between steps; the next step is bit-equal to one without
    the fold: the fold neither joins the step's graph nor touches the
    parameters or the optimizer's moments."""
    _, pcfg = configs()
    tree = istft_trees(9)
    b1, b2 = batches(rng, 2)
    step = phg.make_vanilla_step(pcfg)
    runs = []
    for fold in (False, True):
        state, _ = step(port_state(pcfg, tree), b1)
        if fold:
            folded = state.generator.fold()
            assert not any(p.requires_grad for p in folded.parameters())
        runs.append(step(state, b2))
    (a, ma), (b, mb) = runs
    assert {k: float(v) for k, v in ma.items()} == {
        k: float(v) for k, v in mb.items()}
    for (n, p), q in zip(a.generator.named_parameters(),
                         b.generator.parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad), n
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.g_opt.state[p][k], b.g_opt.state[q][k]), n


def test_istft_generator_trains_with_gan_recipe():
    """tests/test_istft_gen.py's overfit case through the port: a 32-wide
    C8C8I generator (upsample 8·8·4 = 256), lr 2e-3, MPD periods (2, 3)
    and one MSD scale, one batch of two tones (1024 samples, 4 frames);
    mel error falls over 15 steps."""
    mel = dict(n_fft=1024, num_mels=80, hop_size=256, win_size=1024,
               fmax=None)
    seg = 1024
    cfg = pi.ISTFTGeneratorConfig(upsample_initial_channel=32,
                                  resblock_kernel_sizes=(3,),
                                  resblock_dilation_sizes=((1, 3),))
    tcfg = phg.HiFiGANTrainConfig(
        gan=pgan.GANConfig(learning_rate=2e-3, steps_per_epoch=10),
        mel_input=pmel.MelConfig(**mel), mel_loss=pmel.MelConfig(**mel),
        segment_size=seg)
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    state = pgan.create_gan_state(
        tcfg.gan, trainable_istft_generator(cfg, device="cpu",
                                            generator=gens[0]),
        mpd_from_jax(None, PERIODS, device="cpu", generator=gens[1]),
        msd_from_jax(None, None, SCALES, device="cpu", generator=gens[2]))
    t = np.arange(seg)
    y = (0.4 * np.sin(2 * np.pi * 110 * t / 22050)
         + 0.2 * np.sin(2 * np.pi * 347 * t / 22050)).astype(np.float32)
    batch = {"audio": y[None, None]}
    step = phg.make_vanilla_step(tcfg)
    state, m0 = step(state, batch)
    for _ in range(15):
        state, m = step(state, batch)
    first, last = float(m0["mel_error"]), float(m["mel_error"])
    assert np.isfinite(last) and last < first, (first, last)
