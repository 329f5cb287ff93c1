"""The unit HiFi-GAN trainer's pieces (losses.commit_loss,
models/codegen.py:WNCodeGenerator and its fold(), convert/from_jax.py:
trainable_codegen and codegen_tree, train/da.py, and train/gan.py's
frozen_g_paths) against the JAX package's, on the CPU in float32, in the
decoder-only regime: test_train_variants.py's CodeGenerator (two
upsamplers, 16 channels, an f0-VQ-VAE of width 8, a 10-unit table, a
16-wide d-vector), B = 2 × 16 units (320 samples), its 20-band mel;
reduced discriminators (MPD period 2, one MSD scale: full width, one of
each kind of discriminator) as module overrides on both sides, so that
the JAX step compiles in seconds.

JAX's trees come from `CodeGenerator(cfg).init`, two of their parts then
replaced: the generator by `testing.generator_tree(carry=True)` (at
HiFi-GAN's N(0, 0.01) init the waveform is its biases' nearly constant
output, which puts whole discriminator channels at one pre-activation:
test_torch_gan_step.py's `trees`), and the pitch quantizer's codebook by
N(0, 1) rows (init leaves it zero, which sends every frame to code 0), as
loading a trained quantizer would.

Tolerances: metrics rel 1e-5; every trained parameter, both AdamW moments
and the u/v by testing.parity_gate beside the port's float64 step from the
same start (test_torch_gan_step.py's gates); the frozen pitch quantizer
bit-unchanged on both sides, with weight decay 0.01; fold() equal to
codegen_from_jax of the same tree (atol 1e-6); commit_loss and its
gradient rel 1e-6; the fresh init's tensors of the JAX init's shapes, each
spread within 4/√n of JAX's (n elements) and each mean within 5 standard
errors.
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_inpainting_tpu import losses as jl
from speech_inpainting_tpu.models import codegen as jcg
from speech_inpainting_tpu.models import hifigan as jh
from speech_inpainting_tpu.models import jukebox as jj
from speech_inpainting_tpu.ops import mel as jmel
from speech_inpainting_tpu.train import da as jda
from speech_inpainting_tpu.train import gan as jgan
from speech_inpainting_torch import losses as pl
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (
    _load_plain, _state_dict_of, codegen_from_jax, codegen_tree, mpd_from_jax,
    mpd_tree, msd_from_jax, msd_tree, spectral_tree, trainable_codegen)
from speech_inpainting_torch.device import full_f32
from speech_inpainting_torch.models import codegen as pcg
from speech_inpainting_torch.models import hifigan as ph
from speech_inpainting_torch.models import jukebox as pj
from speech_inpainting_torch.ops import mel as pmel
from speech_inpainting_torch.train import da as pda
from speech_inpainting_torch.train import gan as pgan
from test_torch_gan_models import _leaves, _two_threads  # noqa: F401
from test_torch_gan_step import f64_batch

B, UNITS = 2, 16
SEG = UNITS * 20                  # upsample 5 · 4
PERIODS, SCALES = (2,), 1
MEL = dict(n_fft=128, num_mels=20, hop_size=32, win_size=128,
           sampling_rate=16000, fmax=None)
STACK = dict(input_emb_width=1, output_emb_width=16, levels=1, downs_t=(2,),
             strides_t=(2,), width=8, depth=2, dilation_growth_rate=3)
HIFI = dict(upsample_rates=(5, 4), upsample_kernel_sizes=(11, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),), in_dim=48,
            sampling_rate=16000)


def codegen_cfg(m):
    """test_train_variants.py's decoder-only CodeGenerator config, for the
    JAX package (m = its modules) or the port."""
    stack = m.jukebox.ConvStackConfig(**STACK)
    return m.codegen.CodeGeneratorConfig(
        hifigan=m.hifigan.HiFiGANConfig(**HIFI), num_embeddings=10,
        embedding_dim=16, f0_quantizer=m.codegen.FoVQVAEConfig(
            encoder=stack, decoder=stack, l_bins=6, emb_width=16))


class _Mods:
    def __init__(self, codegen, hifigan, jukebox):
        self.codegen, self.hifigan, self.jukebox = codegen, hifigan, jukebox


JAX, PORT = _Mods(jcg, jh, jj), _Mods(pcg, ph, pj)


def da_configs(jcodegen, pcodegen, **gan):
    """(JAX, port) DATrainConfig over these CodeGenerator configs, the
    frozen pitch quantizer out of the generator's optimizer."""
    gan.setdefault("frozen_g_paths", ("fo_vqvae",))
    return (jda.DATrainConfig(codegen=jcodegen, gan=jgan.GANConfig(**gan),
                              mel_loss=jmel.MelConfig(**MEL)),
            pda.DATrainConfig(codegen=pcodegen, gan=pgan.GANConfig(**gan),
                              mel_loss=pmel.MelConfig(**MEL)))


@functools.cache
def _jax_init(cfg, code, f0, emb):
    zeros = lambda spec: None if spec is None else jnp.zeros(*spec)  # noqa
    v = jax.jit(jcg.CodeGenerator(cfg).init)(
        {"params": jax.random.PRNGKey(0), "vq": jax.random.PRNGKey(1)},
        zeros(code), f0=zeros(f0), emb=zeros(emb))
    return jax.tree.map(np.asarray, (v["params"], v.get("vq", {})))


def jax_init(cfg, code, f0=None, emb=None):
    """CodeGenerator(cfg).init on inputs of these arrays' shapes and types
    (the trees depend on nothing else), jitted (eager flax init takes
    longer than the compile) and compiled once per process: numpy trees
    (params, vq), a copy for the caller to change."""
    spec = lambda a: None if a is None else (a.shape, a.dtype)  # noqa
    return copy.deepcopy(_jax_init(cfg, spec(code), spec(f0), spec(emb)))


def reduced_discs(seed):
    """Reduced MPD and MSD at the port's init, as trees."""
    mpd = mpd_from_jax(None, PERIODS, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    msd = msd_from_jax(None, None, SCALES, device="cpu",
                       generator=torch.Generator().manual_seed(seed + 1))
    return mpd_tree(mpd), msd_tree(msd), spectral_tree(msd)


def jax_discs():
    return dict(mpd=jh.MultiPeriodDiscriminator(periods=PERIODS),
                msd=jh.MultiScaleDiscriminator(scales=SCALES))


def decoder_only_inputs(rng):
    """(JAX trees, batches of two steps) of the decoder-only regime."""
    jc = codegen_cfg(JAX)
    code = rng.integers(0, 10, (B, UNITS)).astype(np.int32)
    f0 = rng.standard_normal((B, 1, UNITS * 4)).astype(np.float32)
    emb = rng.standard_normal((B, 16)).astype(np.float32)
    params, vq = jax_init(jc, code, f0=f0, emb=emb)
    params["generator"] = testing.generator_tree(jc.hifigan, rng, carry=True)
    vq["fo_vqvae"]["vq"]["level_0"]["k"] = rng.standard_normal(
        (6, 16)).astype(np.float32)
    batches = []
    for _ in range(2):
        batches.append({
            "code": rng.integers(0, 10, (B, UNITS)).astype(np.int32),
            "f0": rng.standard_normal((B, 1, UNITS * 4)).astype(np.float32),
            "emb": rng.standard_normal((B, 16)).astype(np.float32),
            "audio": (rng.standard_normal((B, 1, SEG)) * 0.2).astype(
                np.float32)})
    return params, vq, batches


# ----------------------------------------------------- the states and gates

def _adam(s):
    """The ScaleByAdamState inside an optax state (masked, partitioned or
    guarded)."""
    if hasattr(s, "mu") and hasattr(s, "nu"):
        return s
    for x in (s.values() if isinstance(s, dict)
              else s if isinstance(s, tuple) else ()):
        found = _adam(x)
        if found is not None:
            return found
    return None


def jax_state(create, *trees):
    """create(*trees) jitted: eager, optax's init compiles one small
    program per leaf shape."""
    return jax.jit(create)(*jax.tree.map(jnp.asarray, trees))


def jax_run(jcfg, params, vq, discs, batches):
    """The JAX step over `batches` from these trees: [(state, metrics)]
    after each."""
    step = jax.jit(jda.make_da_step(jcfg, jax.tree.map(jnp.asarray, vq),
                                    **jax_discs()))
    state = jax_state(lambda *t: jgan.create_gan_state(jcfg.gan, *t),
                      params, *discs)
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((state, {k: float(v) for k, v in m.items()}))
    return out


def port_state(pcfg, params, vq, discs, content_vq=False, seed=1234):
    mp, mv, spec = discs
    gen = trainable_codegen(pcfg.codegen, params, vq, device="cpu")
    mods = (gen, mpd_from_jax(mp, PERIODS, device="cpu"),
            msd_from_jax(mv, spec, SCALES, device="cpu"))
    if content_vq:
        return pda.create_da_state(pcfg, *mods, seed=seed)
    return pgan.create_gan_state(pcfg.gan, *mods)


def _of(opt, key):
    return lambda p: opt.state[p][key] if p in opt.state else None


def port_params(ps, of=lambda p: p) -> dict:
    return {"generator": codegen_tree(ps.generator, of)[0],
            "mpd": mpd_tree(ps.mpd, of), "msd": msd_tree(ps.msd, of)}


def port_moments(ps, key) -> dict:
    g, d = _of(ps.g_opt, key), _of(ps.d_opt, key)
    return {"generator": codegen_tree(ps.generator, g)[0],
            "mpd": mpd_tree(ps.mpd, d), "msd": msd_tree(ps.msd, d)}


def jax_moments(js, name) -> dict:
    d = getattr(_adam(js.d_opt), name)
    return {"generator": getattr(_adam(js.g_opt), name), "mpd": d["mpd"],
            "msd": d["msd"]}


def gates(js, ps, ref, lr=2e-4) -> dict:
    """testing.parity_gate of every parameter (the frozen ones too), both
    AdamW moments (the trained parameters'), the u/v and, in the joint
    regime, the codebook buffers: JAX's state against the port's, beside
    the port's float64 step from the same start (test_torch_gan_step.py's
    step_gates)."""
    L = lambda t: _leaves(t)  # noqa: E731
    zero = testing.zero_up_to_rounding(L(port_moments(ps, "exp_avg")),
                                       L(port_moments(ref, "exp_avg")))
    out = {"param": testing.parity_gate(
        L({"generator": js.g_params, **js.d_params}), L(port_params(ps)),
        L(port_params(ref)), exempt=zero, bound=testing.ADAMW_NOISE * lr)}
    for pk, jk in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        out[jk] = testing.parity_gate(L(jax_moments(js, jk)),
                                      L(port_moments(ps, pk)),
                                      L(port_moments(ref, pk)))
    out["u/v"] = testing.parity_gate(
        L({"msd": js.spectral}), L({"msd": spectral_tree(ps.msd)}),
        L({"msd": spectral_tree(ref.msd)}))
    if js.vq is not None:
        float_vq = lambda t: {k: v for k, v in L(t).items()  # noqa: E731
                              if "initted" not in k}
        out["vq"] = testing.parity_gate(
            float_vq(js.vq), float_vq(codegen_tree(ps.generator)[1]),
            float_vq(codegen_tree(ref.generator)[1]))
    return out


def check_step(js, jm, ps, pm, ref):
    """The gates of one step; metrics rel 1e-5, the optimizers' counts
    and the step equal."""
    assert set(pm) == set(jm), (set(pm), set(jm))
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-5,
                                   err_msg=k)
    worst = {}
    for what, rep in gates(js, ps, ref).items():
        assert rep["ok"], (what, rep["failed"], rep["outside"])
        worst[what] = (rep["share_max"], rep["excess_max"])
    print("largest share outside both gates, largest excess:", worst)
    for popt, jopt in ((ps.g_opt, js.g_opt), (ps.d_opt, js.d_opt)):
        assert {s["step"] for s in popt.state.values()} == {
            int(_adam(jopt).count)}
    assert ps.step == int(js.step)


def _filled(masked, like):
    """A JAX moment tree with the frozen leaves (optax's MaskedNode) taken
    from `like`, as numpy."""
    if isinstance(masked, dict):
        return {k: _filled(masked[k], like[k]) for k in like}
    if not hasattr(masked, "shape"):            # MaskedNode
        return np.asarray(like)
    return np.asarray(masked)


@torch.no_grad()
def _load_codegen(module, params, vq):
    _load_plain(module, {k: v for k, v in params.items()
                         if k != "generator"})
    module.generator.load_state_dict(
        _state_dict_of(module.generator, params["generator"]))
    for name, block in codegen_tree(module)[1].items():
        src = vq[name]["vq"] if name == "fo_vqvae" else vq[name]
        bn = module.fo_vqvae.vq if name == "fo_vqvae" else module.code_vq
        for level, bufs in src.items():
            for key, value in bufs.items():
                buf = getattr(getattr(bn, level), key)
                buf.copy_(torch.as_tensor(np.array(value)).to(buf.dtype))


@torch.no_grad()
def adopt(ps, js, vq=None):
    """Hand the JAX state over to the port's (parameters, codebooks, u/v,
    both moments and counts, the step), so that a later step is compared
    from one start."""
    params = jax.tree.map(np.asarray, js.g_params)
    _load_codegen(ps.generator, params,
                  jax.tree.map(np.asarray, js.vq if js.vq is not None
                               else vq))
    spec = jax.tree.map(np.asarray, js.spectral)
    ps.mpd.load_state_dict(_state_dict_of(
        ps.mpd, jax.tree.map(np.asarray, js.d_params["mpd"])))
    ps.msd.load_state_dict(_state_dict_of(
        ps.msd, jax.tree.map(np.asarray, js.d_params["msd"]), spec))
    for pk, jk in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        want = jax_moments(js, jk)
        holder = trainable_codegen(ps.generator.cfg, _filled(
            want["generator"], params), vq, device="cpu")
        named = dict(holder.named_parameters())
        trained = set(ps.g_parameters())
        for n, p in ps.generator.named_parameters():
            if p in trained:
                ps.g_opt.state[p][pk] = named[n].detach().clone()
        for name, module in (("mpd", ps.mpd), ("msd", ps.msd)):
            sd = _state_dict_of(module, jax.tree.map(np.asarray, want[name]),
                                spec)
            for n, p in module.named_parameters():
                ps.d_opt.state[p][pk] = sd[n].reshape(p.shape).clone()
    for opt, jopt in ((ps.g_opt, js.g_opt), (ps.d_opt, js.d_opt)):
        for st in opt.state.values():
            st["step"] = int(_adam(jopt).count)
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


def frozen_snapshot(module) -> dict:
    return {n: t.detach().clone() for n, t in
            [*module.fo_vqvae.named_parameters(),
             *module.fo_vqvae.named_buffers()]}


# ---------------------------------------------------------------- the tests

def test_commit_loss_matches_jax(rng):
    x = rng.standard_normal((3, 16, 7)).astype(np.float32)
    xq = rng.standard_normal((3, 16, 7)).astype(np.float32)
    want, jgrad = jax.value_and_grad(jl.commit_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(xq))
    xt = torch.tensor(x, requires_grad=True)
    xqt = torch.tensor(xq, requires_grad=True)
    got = pl.commit_loss(xt, xqt)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad[0]),
                               rtol=1e-6, atol=1e-9)
    assert xqt.grad is None and not np.asarray(jgrad[1]).any()


def test_fresh_init_matches_jax_distributions(rng):
    """The port's fresh init against JAX's `init` by distribution: the
    same trees and shapes; each tensor of at least 16 elements with a
    spread within 4/√n of JAX's and a mean within 5 standard errors; every
    weight-norm gain the norm of its direction; the codebooks zero and
    uninitialised; the pitch quantizer frozen, in eval mode."""
    jc, pc = codegen_cfg(JAX), codegen_cfg(PORT)
    params, vq = jax_init(jc, np.zeros((B, UNITS), np.int32),
                          f0=np.zeros((B, 1, UNITS * 4), np.float32),
                          emb=np.zeros((B, 16), np.float32))
    module = trainable_codegen(pc, seed=3, device="cpu")
    got, got_vq = codegen_tree(module)
    want, ours = _leaves(params), _leaves(got)
    assert want.keys() == ours.keys()
    for k in want:
        n = want[k].size
        assert ours[k].shape == want[k].shape, k
        if n < 16:
            continue
        sw, so = want[k].std(), ours[k].std()
        if sw == 0:
            assert so == 0, k
            continue
        # a weight-norm gain is the norm of its direction (checked below)
        if not k.endswith("['g']"):
            assert abs(so / sw - 1) < 4 / np.sqrt(n), (k, so, sw)
        assert abs(ours[k].mean() - want[k].mean()) <= 5 * sw / np.sqrt(n), k
    for name, p in module.generator.named_parameters():
        if name.endswith("weight_g"):
            v = dict(module.generator.named_parameters())[
                name[:-1] + "v"]
            np.testing.assert_allclose(
                p.detach().reshape(-1).numpy(),
                v.detach().reshape(v.shape[0], -1).norm(dim=1).numpy(),
                rtol=1e-6)
    for k, v in _leaves(got_vq).items():
        assert not v.any(), k
    assert _leaves(vq).keys() == _leaves(got_vq).keys()
    assert not any(p.requires_grad for p in module.fo_vqvae.parameters())
    assert all(p.requires_grad for n, p in module.named_parameters()
               if not n.startswith("fo_vqvae."))
    module.train()
    assert module.training and not module.fo_vqvae.training
    other = trainable_codegen(pc, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(module.state_dict().values(), other.state_dict().values()))


def test_fold_equals_codegen_from_jax(rng):
    """fold() gives the inference CodeGenerator of the same weights:
    equal to codegen_from_jax of the same trees (atol 1e-6), and
    codegen_tree reads back the trees it was loaded from."""
    params, vq, batches = decoder_only_inputs(rng)
    pc = codegen_cfg(PORT)
    module = trainable_codegen(pc, params, vq, device="cpu")
    got, got_vq = codegen_tree(module)
    for a, b in ((got, params), (got_vq, vq)):
        la, lb = _leaves(a), _leaves(b)
        assert la.keys() == lb.keys()
        for k in lb:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    folded = module.fold()
    assert type(folded) is pcg.CodeGenerator
    want = codegen_from_jax(pc, params, vq, device="cpu")
    b = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    with torch.no_grad(), full_f32():
        ya = folded(b["code"], f0=b["f0"], emb=b["emb"])
        yb = want(b["code"], f0=b["f0"], emb=b["emb"])
        yc = module(b["code"], f0=b["f0"], emb=b["emb"])
    np.testing.assert_allclose(ya.numpy(), yb.numpy(), atol=1e-6)
    np.testing.assert_allclose(yc.numpy(), yb.numpy(), atol=1e-6)
    assert not any(p.requires_grad for p in folded.parameters())


def test_decoder_only_two_steps_match_jax(rng):
    """Two DA steps, the frozen pitch quantizer out of the generator's
    optimizer, weight decay 0.01, steps_per_epoch 1 (the second update
    decayed): every gate; the pitch quantizer bit-unchanged on both sides,
    the unit and pitch tables and the generator moved; then
    make_da_eval's mel_error against JAX's."""
    params, vq, batches = decoder_only_inputs(rng)
    discs = reduced_discs(5)
    jcfg, pcfg = da_configs(codegen_cfg(JAX), codegen_cfg(PORT),
                            steps_per_epoch=1)
    want = jax_run(jcfg, params, vq, discs, batches)
    step = pda.make_da_step(pcfg)
    for i, (b, (js, jm)) in enumerate(zip(batches, want)):
        start = want[i - 1][0] if i else None
        runs = []
        for f64 in (False, True):
            ps = port_state(pcfg, params, vq, discs)
            if start is not None:
                adopt(ps, start, vq)
            before = frozen_snapshot(ps.generator)
            ps = to_f64(ps) if f64 else ps
            ps, pm = step(ps, f64_batch(b) if f64 else b)
            runs.append((ps, pm, before))
        (ps, pm, before), (ref, _, _) = runs
        check_step(js, jm, ps, pm, ref)
        after = frozen_snapshot(ps.generator)
        assert all(torch.equal(after[k], before[k]) for k in before)
        assert not any(p in ps.g_opt.state
                       for p in ps.generator.fo_vqvae.parameters())
    js = want[-1][0]
    for k, v in _leaves(js.g_params["fo_vqvae"]).items():
        np.testing.assert_array_equal(v, _leaves(params["fo_vqvae"])[k])
    moved = _leaves(codegen_tree(ps.generator)[0])
    start = _leaves(params)
    for part in ("['emb_c']", "['emb_p']", "['generator']"):
        assert any(not np.array_equal(moved[k], start[k])
                   for k in start if k.startswith(part)), part
    # the validation metric, through the folded generator
    jev = jax.jit(jda.make_da_eval(jcfg))
    ev = pda.make_da_eval(pcfg)
    got = ev(ps.generator, batches[0])["mel_error"]
    jvars = (jax.tree.map(jnp.asarray, js.g_params),
             jax.tree.map(jnp.asarray, vq))
    ref = float(jev(jvars, {k: jnp.asarray(v) for k, v in
                            batches[0].items()})["mel_error"])
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_da_step_refuses_a_closed_over_codebook():
    _, pcfg = da_configs(codegen_cfg(JAX), codegen_cfg(PORT))
    with pytest.raises(ValueError, match="carries its codebooks"):
        pda.make_da_step(pcfg, {"fo_vqvae": {}})
    joint = dataclasses.replace(pcfg, codegen=dataclasses.replace(
        pcfg.codegen, code_encoder=pj.ConvStackConfig(**STACK),
        use_f0=False))
    with pytest.raises(ValueError, match="silently freeze"):
        pda.make_da_step(joint, {"code_vq": {}})
