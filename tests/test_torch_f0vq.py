"""The f0-VQ-VAE trainer (train/f0vq.py, FoVQVAE's training forward, the
fresh init) against the JAX package's make_f0vq_step and make_f0vq_eval,
on the CPU in float32 at small widths, with the same numpy tree.

The codebook's restart candidates are JAX's own, handed to the port as in
tests/test_torch_vq_train.py. Three steps from an uninitialised codebook
(the first initialises it and restarts codes): labels equal; every
parameter within atol 1e-6 (AdamW's three updates of at most ~lr each,
float32 rounding of the gradients moving them by far less); both AdamW
moments, the codebook buffers and the metrics within rtol 1e-5 (atol 1e-6
for the buffers and metrics, 1e-9 for the moments, whose gradients are
~1e-4 to 1e-1). The fresh init is held by its distributions only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import speech_inpainting_tpu.quantize.vq as jvq
from speech_inpainting_tpu.models import codegen as jcodegen
from speech_inpainting_tpu.train import f0vq as jf0vq
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import trainable_fo_vqvae
from speech_inpainting_torch.models import codegen
from speech_inpainting_torch.models.jukebox import ConvStackConfig
from speech_inpainting_torch.train import f0vq
from test_torch_vq_train import jax_candidates  # noqa: F401

STACK = dict(input_emb_width=1, output_emb_width=16, levels=1, downs_t=(2,),
             strides_t=(2,), width=8, depth=2, dilation_growth_rate=3)


def configs(**kw):
    stack = ConvStackConfig(**STACK)
    pcfg = codegen.FoVQVAEConfig(encoder=stack, decoder=stack, l_bins=8,
                                 emb_width=16)
    jstack = jcodegen.ConvStackConfig(**STACK)
    jcfg = jcodegen.FoVQVAEConfig(encoder=jstack, decoder=jstack, l_bins=8,
                                  emb_width=16)
    return (jf0vq.F0VQConfig(model=jcfg, **kw),
            f0vq.F0VQConfig(model=pcfg, **kw))


def f0_batch(rng, b=4, t=64):
    """Normalised-f0-like rows: a slow glide around 0, with unvoiced
    zeros: scattered frames, the second half of row 3 and the whole of rows
    1 and 2, whose latents are all alike (so that candidates repeat and the
    first step restarts the repeats)."""
    x = np.cumsum(rng.standard_normal((b, 1, t)) * 0.2, axis=-1)
    x[..., rng.uniform(size=t) < 0.2] = 0.0
    x[1:3] = 0.0
    x[3, :, t // 2:] = 0.0
    return {"f0": x.astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _torch_name(name):
    head, leaf = name.rsplit(".", 1)
    return f"{head}.{dict(w='weight', b='bias')[leaf]}"


def _adam(opt_state):
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(s, "nu"):
            return s
    raise AssertionError("no ScaleByAdamState")


def _empty_vq(cfg):
    return {"vq": {f"level_{i}": {
        "k": np.zeros((cfg.l_bins, cfg.emb_width), np.float32),
        "k_sum": np.zeros((cfg.l_bins, cfg.emb_width), np.float32),
        "k_elem": np.zeros(cfg.l_bins, np.float32),
        "initted": np.zeros((), bool)} for i in range(cfg.levels)}}


@pytest.fixture
def labels_of_both(monkeypatch):
    """Each side's training-forward labels, in call order."""
    seen = {"jax": [], "port": []}
    orig = jvq.EMAVectorQuantizer.quantise

    def quantise(self, x_flat):
        labels, fit = orig(self, x_flat)
        jax.debug.callback(lambda v: seen["jax"].append(np.array(v)), labels)
        return labels, fit

    monkeypatch.setattr(jvq.EMAVectorQuantizer, "quantise", quantise)
    return seen


def test_three_steps_match_jax(rng, jax_candidates, labels_of_both):
    jcfg, pcfg = configs()
    params, _ = testing.fo_vqvae_tree(pcfg.model, rng)
    vq = _empty_vq(pcfg.model)
    jstate = jf0vq.create_f0vq_state(jcfg, jax.tree.map(jnp.asarray, params),
                                     jax.tree.map(jnp.asarray, vq))
    jstep = jax.jit(jf0vq.make_f0vq_step(jcfg))
    model = trainable_fo_vqvae(pcfg.model, params, vq, device="cpu")
    model.vq.level_0.register_forward_hook(
        lambda m, a, out: labels_of_both["port"].append(out[0].numpy()))
    state = f0vq.create_f0vq_state(pcfg, model)
    step = f0vq.make_f0vq_step(pcfg, device="cpu")
    for i in range(3):
        batch = f0_batch(rng)
        jstate, jm = jstep(jstate, {"f0": jnp.asarray(batch["f0"])},
                           jax.random.PRNGKey(i))
        state, m = step(state, batch, torch.Generator().manual_seed(i))
        assert not jax_candidates
        np.testing.assert_array_equal(labels_of_both["port"][-1],
                                      labels_of_both["jax"][-1].reshape(
                                          labels_of_both["port"][-1].shape))
        assert sorted(m) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        jp = _flat(jstate.params)
        got = dict(model.named_parameters())
        assert sorted(got) == sorted(_torch_name(k) for k in jp)
        adam = _adam(jstate.opt_state)
        jmu, jnu = _flat(adam.mu), _flat(adam.nu)
        for k in jp:
            p = got[_torch_name(k)]
            np.testing.assert_allclose(p.detach().numpy(), jp[k], rtol=0,
                                       atol=1e-6, err_msg=k)
            opt = state.optimizer.state[p]
            np.testing.assert_allclose(opt["exp_avg"].numpy(), jmu[k],
                                       rtol=1e-5, atol=1e-9, err_msg=k)
            np.testing.assert_allclose(opt["exp_avg_sq"].numpy(), jnu[k],
                                       rtol=1e-5, atol=1e-9, err_msg=k)
            assert opt["step"] == int(adam.count)
        for name, want in _flat(jstate.vq["vq"]).items():
            got_buf = getattr(model.vq, name.split(".")[0]).get_buffer(
                name.split(".")[1])
            np.testing.assert_allclose(got_buf.numpy().astype(np.float64),
                                       np.asarray(want, np.float64),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        if i == 0:                 # the first step initialised and restarted
            assert bool(model.vq.level_0.initted)
            assert float(m["usage"]) < pcfg.model.l_bins
    assert state.step == int(jstate.step) == 3
    # the eval, on the trained state, leaves the codebook as it is
    f0 = f0_batch(rng)["f0"]
    want = jax.jit(jf0vq.make_f0vq_eval(jcfg))(jstate.params, jstate.vq,
                                               jnp.asarray(f0))
    before = model.vq.level_0.k.clone()
    got = f0vq.make_f0vq_eval(pcfg, device="cpu")(model, f0)
    for k in ("recon", "commit"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert torch.equal(model.vq.level_0.k, before)


def test_step_learns(rng):
    """As the JAX package's test_f0vq_step_learns: 30 steps from a fresh
    init on one sine batch lower the reconstruction; the codebook is
    initialised and the eval is finite."""
    _, pcfg = configs(steps_per_epoch=10)
    model = trainable_fo_vqvae(pcfg.model, seed=0, device="cpu")
    state = f0vq.create_f0vq_state(pcfg, model)
    step = f0vq.make_f0vq_step(pcfg, device="cpu")
    f0 = {"f0": np.sin(np.linspace(0, 20, 2 * 64)).reshape(2, 1, 64)
          .astype(np.float32)}
    gen = torch.Generator().manual_seed(2)
    _, m0 = step(state, f0, gen)
    for _ in range(30):
        state, m = step(state, f0, gen)
    assert float(m["recon"]) < float(m0["recon"])
    assert bool(model.vq.level_0.initted)
    assert np.isfinite(f0vq.make_f0vq_eval(pcfg, device="cpu")(
        model, f0["f0"])["recon"])


def test_fresh_init_draws_torch_default_distributions():
    """Every conv's weight and bias U(±1/√fan_in) (fan_in C_in·K, or
    C_out·K for a transposed conv), as the JAX package's init draws them:
    the bound is reached to within 2% and the mean and spread are a
    uniform's; the codebook starts uninitialised; a seed redraws the same
    tree. zero_out zeroes each residual block's k1 conv."""
    _, pcfg = configs()
    model = trainable_fo_vqvae(pcfg.model, seed=3, device="cpu")
    for name, p in model.named_parameters():
        assert p.requires_grad, name
        mod = model.get_submodule(name.rsplit(".", 1)[0])
        w = mod.weight
        bound = 1.0 / np.sqrt(w.shape[1] * w.shape[2])
        v = p.detach().numpy().ravel()
        assert np.abs(v).max() <= bound, name
        if v.size >= 200:
            assert np.abs(v).max() > 0.98 * bound, name
            assert abs(v.mean()) < 4 * bound / np.sqrt(3 * v.size), name
            np.testing.assert_allclose(v.std(), bound / np.sqrt(3),
                                       rtol=0.15, err_msg=name)
    assert not bool(model.vq.level_0.initted)
    assert float(model.vq.level_0.k.abs().max()) == 0.0
    again = trainable_fo_vqvae(pcfg.model, seed=3, device="cpu")
    for (n, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), n
    stack = ConvStackConfig(**dict(STACK, zero_out=True))
    zcfg = codegen.FoVQVAEConfig(encoder=stack, decoder=stack, l_bins=8,
                                 emb_width=16)
    zero = trainable_fo_vqvae(zcfg, seed=3, device="cpu")
    for name, p in zero.named_parameters():
        assert (float(p.detach().abs().max()) == 0.0) == (".conv1." in name), name
