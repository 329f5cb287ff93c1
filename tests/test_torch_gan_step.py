"""One and two GAN train steps of the port (train/gan.py, train/hifigan.py)
against the JAX package's, on the CPU in float32, at
tests/test_train_variants.py's sizes: TINY_G (two upsamplers, 16 channels),
the full MPD and MSD, B = 2 × 2048 samples, its mel configs; both sides fed
the same numpy trees (the port's init) and batches. The helpers and gates
(`check_step`) serve test_torch_gan_modified.py and
test_torch_gan_guard.py too.

Gates of a step: every metric rel 1e-5; the optimizers' counts equal;
every parameter of the generator, the MPD and the MSD, both AdamW moments
of each, and the MSD's u/v by testing.parity_gate, each leaf one tensor:
JAX's element within rtol 2e-5, atol 2e-6 of the port's, or, where
float32 cannot give that, within the port's own float32 noise of the
port's step in float64 from the same start (`step_gates`); of the
elements that pass neither, a tensor of more than 16 elements may hold a
tenth, and each must lie within 100 × that tolerance (testing.NOISE, set
from the readings of float32's kink noise, below those of planted faults:
test_torch_gan_gate.py). Run with `-s`, each step prints its largest
share and excess. The vanilla run takes steps_per_epoch = 1, so its
second update already runs at the decayed learning rate; the optimizer
alone is held to optax's adamw with that schedule at 1e-7 (a wrong count
would move it by 1e-3 of an update).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_inpainting_tpu.models import hifigan as jh
from speech_inpainting_tpu.ops import mel as jmel
from speech_inpainting_tpu.train import gan as jgan
from speech_inpainting_tpu.train import hifigan as jhg
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (
    _state_dict_of, generator_tree, mpd_from_jax, mpd_tree, msd_from_jax, msd_tree,
    spectral_tree, trainable_generator)
from speech_inpainting_torch.models import hifigan as ph
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.ops import mel as pmel
from speech_inpainting_torch.train import gan as pgan
from speech_inpainting_torch.train import hifigan as phg
from speech_inpainting_torch.train.optim import AdamW, exponential_decay
from test_torch_gan_models import TINY, _leaves, discs
from test_torch_gan_models import _two_threads  # noqa: F401


SEG = 2048
MEL = dict(n_fft=512, num_mels=80, hop_size=16, win_size=512)
MEL441 = dict(n_fft=512, num_mels=80, hop_size=441, win_size=512)
MEL_FULL = dict(MEL, fmax=None)


def configs(mask_len=2, **gan):
    """(JAX, port) HiFiGANTrainConfig at these sizes."""
    def one(train, gan_mod, models, mel):
        return train.HiFiGANTrainConfig(
            gan=gan_mod.GANConfig(**gan),
            hifigan=models.HiFiGANConfig(**TINY), segment_size=SEG,
            mask_len=mask_len, mel_input=mel.MelConfig(**MEL),
            mel_441=mel.MelConfig(**MEL441),
            mel_loss=mel.MelConfig(**MEL_FULL))
    return one(jhg, jgan, jh, jmel), one(phg, pgan, ph, pmel)


def trees(seed=0, mpd=None, msd=None):
    """The numpy trees both sides start from: a generator whose weights
    carry the signal (testing.generator_tree's carry=True), and full
    discriminators (the port's init) or the given reduced ones. At HiFi-GAN's
    N(0, 0.01) init the generator's output is its biases' nearly constant
    waveform, so every position of a discriminator channel sits at the same
    pre-activation; where that is near zero, float32 noise of 1e-8 in ŷ
    flips all of them across the leaky ReLU's kink at once, and the two
    sides' gradients part by 1e-4 of their scale."""
    gen = testing.generator_tree(HiFiGANConfig(**TINY),
                                 np.random.default_rng(seed), carry=True)
    if mpd is None:
        mpd, msd, mp, mv, spec = discs(seed + 1)
    else:
        mp, mv, spec = mpd_tree(mpd), msd_tree(msd), spectral_tree(msd)
    return gen, mp, mv, spec


def batches(rng, n, mask=False):
    out = []
    for _ in range(n):
        b = {"audio": (rng.standard_normal((2, 1, SEG)) * 0.2
                       ).astype(np.float32)}
        if mask:
            b["mask_start"] = rng.integers(0, 3, 2).astype(np.int32)
        out.append(b)
    return out


def jax_discs(mpd_periods=(2, 3, 5, 7, 11), scales=3):
    """The JAX step's discriminators, as module overrides."""
    return dict(mpd=jh.MultiPeriodDiscriminator(periods=mpd_periods),
                msd=jh.MultiScaleDiscriminator(scales=scales))


def jax_states(jcfg, tree, make, bs, **kw):
    """The JAX step over `bs`: [(state, metrics)] after each.
    make(cfg, mpd=, msd=) builds it; `kw` sizes the discriminators."""
    g, mp, mv, spec = jax.tree.map(jnp.asarray, tree)
    state = jgan.create_gan_state(jcfg.gan, g, mp, mv, spec)
    step = jax.jit(make(jcfg, **jax_discs(**kw)))
    out = []
    for b in bs:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((state, {k: float(v) for k, v in m.items()}))
    return out


def port_state(pcfg, tree, mpd_periods=(2, 3, 5, 7, 11), scales=3):
    g, mp, mv, spec = tree
    return pgan.create_gan_state(
        pcfg.gan, trainable_generator(pcfg.hifigan, g, device="cpu"),
        mpd_from_jax(mp, mpd_periods, device="cpu"),
        msd_from_jax(mv, spec, scales, device="cpu"))


def _inner(opt):
    return opt.inner_state if hasattr(opt, "inner_state") else opt


def moments(state, key):
    """Port: {generator, mpd, msd} trees of each optimizer's `key`."""
    opt = {"generator": state.g_opt, "mpd": state.d_opt,
           "msd": state.d_opt}
    of = lambda o: lambda p: o.state[p][key]  # noqa: E731
    return {"generator": generator_tree(state.generator,
                                        of(opt["generator"])),
            "mpd": mpd_tree(state.mpd, of(opt["mpd"])),
            "msd": msd_tree(state.msd, of(opt["msd"]))}


def jax_moments(state, name):
    g = getattr(_inner(state.g_opt)[0], name)
    d = getattr(_inner(state.d_opt)[0], name)
    return {"generator": g, "mpd": d["mpd"], "msd": d["msd"]}


def params(ps) -> dict:
    return {"generator": generator_tree(ps.generator),
            "mpd": mpd_tree(ps.mpd), "msd": msd_tree(ps.msd)}


def step_gates(js, ps, ref, lr=2e-4, limits=testing.NOISE) -> dict:
    """testing.parity_gate of every parameter, both AdamW moments and the
    u/v after one step from the same start: the JAX state `js` against the
    port's `ps`, beside `ref`, the port's step in float64, each leaf one
    tensor: {"param" | "mu" | "nu" | "u/v": report}. JAX's float32 result
    is what the gate checks, against the port's float64 step within the
    port's own float32 noise (its gap to its float64 step): a fault of the
    port's moves both its steps alike and leaves that noise as it was, so
    the gate sees it whole. A parameter element outside whose gradient is
    zero up to rounding (the port's float64 first moment within the
    moment's tolerance of zero) is held to AdamW's noise bound instead."""
    leaves = lambda *t: [_leaves(x) for x in t]  # noqa: E731
    zero = testing.zero_up_to_rounding(*leaves(moments(ps, "exp_avg"),
                                               moments(ref, "exp_avg")))
    out = {"param": testing.parity_gate(
        *leaves({"generator": js.g_params, **js.d_params}, params(ps),
                params(ref)),
        exempt=zero, bound=testing.ADAMW_NOISE * lr, limits=limits)}
    for pk, jk in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        out[jk] = testing.parity_gate(*leaves(
            jax_moments(js, jk), moments(ps, pk), moments(ref, pk)),
            limits=limits)
    out["u/v"] = testing.parity_gate(*leaves(
        {"msd": js.spectral}, {"msd": spectral_tree(ps.msd)},
        {"msd": spectral_tree(ref.msd)}), limits=limits)
    return out


def check_step(js, jm, ps, pm, ref, lr=2e-4):
    """The gates of one step (module docstring) against the JAX state `js`,
    beside the port's float64 step `ref` from the same start; returns
    {"kind tensor": elements outside both gates}. A float32 step cannot
    hold every element to 2e-5: a leaky ReLU or |·| input within rounding
    of its kink (the full discriminators meet several a step) takes its
    slope by the rounding's sign and moves every gradient behind it;
    AdamW's early updates turn a small gradient's sign into ±lr. The
    float64 step meets the same kinks on their true side."""
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-5,
                                   err_msg=k)
    noisy, worst = {}, {}
    for what, rep in step_gates(js, ps, ref, lr).items():
        assert rep["ok"], (what, rep["failed"], rep["outside"])
        worst[what] = (rep["share_max"], rep["excess_max"],
                       rep["small_excess_max"])
        noisy.update({f"{what} {k}": n for k, n in rep["outside"].items()})
        noisy.update({f"{what} {k} (exempt)": n
                      for k, n in rep["exempt"].items()})
    print("largest share outside both gates, largest excess (and in a "
          "tensor of at most 16 elements):", worst)
    for popt, jopt in ((ps.g_opt, js.g_opt), (ps.d_opt, js.d_opt)):
        counts = {s["step"] for s in popt.state.values()}
        assert counts == {int(_inner(jopt)[0].count)}
    assert ps.step == int(js.step)
    return noisy


@torch.no_grad()
def adopt(ps, js):
    """Hand the JAX state over to the port's: parameters, u/v, both
    moments and counts, the step; so that a second step is compared from
    one start (float32's rounding of the first does not compound)."""
    tree = (js.g_params, js.d_params["mpd"], js.d_params["msd"],
            js.spectral)
    tree = jax.tree.map(np.asarray, tree)
    ps.generator.load_state_dict(_state_dict_of(ps.generator, tree[0]))
    ps.mpd.load_state_dict(_state_dict_of(ps.mpd, tree[1]))
    ps.msd.load_state_dict(_state_dict_of(ps.msd, tree[2], tree[3]))
    for pk, jk in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        want = jax_moments(js, jk)
        for name, module, opt in (("generator", ps.generator, ps.g_opt),
                                  ("mpd", ps.mpd, ps.d_opt),
                                  ("msd", ps.msd, ps.d_opt)):
            sd = _state_dict_of(module, jax.tree.map(np.asarray, want[name]),
                                jax.tree.map(np.asarray, js.spectral))
            for pname, p in module.named_parameters():
                opt.state[p][pk] = sd[pname].reshape(p.shape).clone()
    for opt, jopt in ((ps.g_opt, js.g_opt), (ps.d_opt, js.d_opt)):
        for st in opt.state.values():
            st["step"] = int(_inner(jopt)[0].count)
    ps.step = int(js.step)


@torch.no_grad()
def to_f64(ps):
    """`ps` computing and stored in float64, moments too."""
    for m in (ps.generator, ps.mpd, ps.msd):
        m.double()
        for c in m.modules():
            if hasattr(c, "dtype"):
                c.dtype = torch.float64
    for opt in (ps.g_opt, ps.d_opt):
        for st in opt.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = st[k].double()
    return ps


def f64_batch(b: dict) -> dict:
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in b.items()}


def port_start(pcfg, tree, start=None, f64=False, **kw):
    """The port's state from `tree`, then the JAX state `start` (adopted)
    where one is given; in float64 with f64."""
    state = port_state(pcfg, tree, **kw)
    if start is not None:
        adopt(state, start)
    return to_f64(state) if f64 else state


def compare_steps(jcfg, pcfg, tree, jmake, pmake, bs, **kw):
    """Steps of both sides from `tree` over `bs`, each later step from the
    JAX state the earlier one reached, each held by check_step beside the
    port's float64 step from the same start. jmake(cfg, mpd=, msd=) builds
    the JAX step, pmake(cfg) the port's; `kw` sizes the discriminators.
    Returns the port's states and metrics, JAX's, and the elements outside
    both gates."""
    want = jax_states(jcfg, tree, jmake, bs, **kw)
    step = pmake(pcfg)
    out, noisy = [], {}
    for i, (b, (js, jm)) in enumerate(zip(bs, want)):
        start = want[i - 1][0] if i else None
        state, pm = step(port_start(pcfg, tree, start, **kw), b)
        ref, _ = step(port_start(pcfg, tree, start, f64=True, **kw),
                      f64_batch(b))
        noisy.update({f"step {i + 1} {k}": n for k, n in check_step(
            js, jm, state, pm, ref).items()})
        out.append((state, pm))
    return out, want, noisy


# ---------------------------------------------------------------- the tests

def test_vanilla_two_steps_match_jax(rng):
    """Two vanilla steps, the second at the staircase's decayed rate."""
    jcfg, pcfg = configs(steps_per_epoch=1)
    out, _, noisy = compare_steps(jcfg, pcfg, trees(), jhg.make_vanilla_step,
                                  phg.make_vanilla_step, batches(rng, 2))
    print("outside both gates:", noisy)
    sched = out[-1][0].g_opt.schedule
    assert sched(0) == np.float32(2e-4)
    assert sched(1) == np.float32(2e-4) * np.float32(0.999)


def test_vanilla_eval_matches_jax(rng):
    """make_vanilla_eval's mel_error, the in-graph mel and the teacher
    'mel' regime, through the folded generator."""
    jcfg, pcfg = configs()
    tree = trees(2)
    b = batches(rng, 1)[0]
    teacher = dict(b, mel=rng.standard_normal(
        (2, 80, pmel.MelConfig(**MEL).num_frames(SEG))).astype(np.float32))
    gen = trainable_generator(pcfg.hifigan, tree[0], device="cpu")
    ev = phg.make_vanilla_eval(pcfg)
    jev = jax.jit(jhg.make_vanilla_eval(jcfg))
    for batch in (b, teacher):
        want = float(jev(jax.tree.map(jnp.asarray, tree[0]),
                         {k: jnp.asarray(v) for k, v in batch.items()})[
            "mel_error"])
        got = ev(gen, batch)["mel_error"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert ev(gen.fold(), b) == ev(gen, b)


def test_adamw_schedule_matches_optax(rng):
    """The optimizer alone, fed the same gradients three times at
    steps_per_epoch = 1 (so each update's rate decays): parameters and
    moments within 1e-7 of optax.adamw over the staircase schedule."""
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32)
             for _ in range(3)]
    sched = optax.exponential_decay(2e-4, 1, 0.999, staircase=True)
    opt = optax.adamw(sched, b1=0.8, b2=0.99, weight_decay=0.01)
    jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.tensor(p0))
    port = AdamW([p], lr=2e-4, betas=(0.8, 0.99), eps=1e-8,
                 weight_decay=0.01,
                 schedule=exponential_decay(2e-4, 1, 0.999))
    for g in grads:
        u, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        p.grad = torch.tensor(g)
        port.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-7)
    np.testing.assert_allclose(port.state[p]["exp_avg"].numpy(),
                               np.asarray(js[0].mu), rtol=1e-6)
    # without the decay the third update is off by more than the gate
    flat = AdamW([torch.nn.Parameter(torch.tensor(p0))], lr=2e-4,
                 betas=(0.8, 0.99), eps=1e-8, weight_decay=0.01)
    q = flat.param_groups[0]["params"][0]
    for g in grads:
        q.grad = torch.tensor(g)
        flat.step()
    assert np.abs(q.detach().numpy() - np.asarray(jp)).max() > 2e-7


def test_config_refusals():
    jcfg, pcfg = configs()
    mpd, msd, *_ = discs()
    gen = trainable_generator(pcfg.hifigan, trees()[0], device="cpu")
    # folded_mpd, the JAX package's TPU layout of the period fold, is
    # refused wherever a config reaches the trainer
    folded = dataclasses.replace(pcfg.gan, folded_mpd=True)
    with pytest.raises(NotImplementedError, match="folded_mpd"):
        pgan.default_discriminators(folded, "cpu")
    with pytest.raises(NotImplementedError, match="folded_mpd"):
        pgan.create_gan_state(folded, gen, mpd, msd)
    # the config's disc_bf16 against the type the discriminators compute in
    bf16 = dataclasses.replace(pcfg.gan, disc_bf16=True)
    with pytest.raises(ValueError, match="disc_bf16"):
        pgan.create_gan_state(bf16, gen, mpd, msd)
    with pytest.raises(ValueError, match="disc_bf16"):
        pgan.create_gan_state(pcfg.gan, gen, *pgan.default_discriminators(
            bf16, "cpu"))
    pgan.create_gan_state(bf16, gen, *pgan.default_discriminators(
        bf16, "cpu"))
    # the inference iSTFT generator is refused by name; the trainable one
    # is taken
    from speech_inpainting_torch.convert.from_jax import (
        trainable_istft_generator)
    from speech_inpainting_torch.models.hifigan_istft import (
        ISTFTGenerator, ISTFTGeneratorConfig)
    icfg = ISTFTGeneratorConfig(upsample_initial_channel=16)
    with pytest.raises(ValueError, match="trainable_istft_generator"):
        pgan.create_gan_state(pcfg.gan, ISTFTGenerator(icfg), mpd, msd)
    state = pgan.create_gan_state(
        pcfg.gan, trainable_istft_generator(icfg, device="cpu"), mpd, msd)
    assert state.g_parameters() == list(state.generator.parameters())
