"""The port's I_ea trainer (losses.py, the masked and trainable HuBERT,
train/ea.py) against the JAX package's, on the CPU in float32, at
tests/test_train_ea.py's TINY HuBERT (hidden 16, one layer, conv_dim 8),
fed the same numpy tree (testing.hubert_tree) and the same batches: rows of
two lengths, zero-padded, with their attention mask. The step's helpers
and gates (`check_step`) serve tests/test_torch_train_step.py,
test_torch_train_modes.py and test_torch_run.py too.

Tolerances:
  - CentroidLosses: rel 1e-6, predicted labels equal;
  - the masked forward: atol 1e-5 on the head's output;
  - a step (`check_step`): loss rel 1e-5, acc and cos-sim-acc equal;
    parameters and both AdamW moments within rtol 2e-5, atol 2e-6
    (tests/test_train_ea.py's gate);
  - twelve steps: parameters within 1e-5 (the k_proj bias below), each
    loss rel 1e-4;
  - the optimizer alone, fed JAX's gradients: parameters within 1e-7;
  - the init: each weight's std within 5% of flax's at the same shape.

The attention's k_proj bias has a gradient of exactly zero (a constant
added to every key's score of a query leaves its softmax unchanged), so
each side's gradient there is rounding noise, and AdamW's first step turns
noise n into an update of lr·n/(|n| + eps), up to ±lr: the two sides'
noises, and so their updates of that tensor, are unrelated. `check_step`
holds that tensor to what exact arithmetic gives instead: each side's
update no larger than its own noise allows,
|p' − p·(1 − lr·wd)| ≤ lr·n/(n + eps) with n its largest |gradient|;
over twelve steps, each side within the most Adam can move a parameter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from speech_inpainting_tpu.losses import CentroidLosses as JaxLosses
from speech_inpainting_tpu.models.hubert import EncoderWithHead as JaxModel
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxConfig
from speech_inpainting_tpu.train import ea as jea
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (hubert_tree,
                                                      inference_hubert,
                                                      trainable_hubert)
from speech_inpainting_torch.losses import CentroidLosses
from speech_inpainting_torch.models.hubert import (EncoderWithHead,
                                                   HubertConfig, init_flax_)
from speech_inpainting_torch.train import ea as pea

TINY = dict(conv_dim=(8,) * 7, hidden_size=16, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=24,
            num_conv_pos_embeddings=15, num_conv_pos_embedding_groups=1)
L = 3           # mask frames
K = 10          # centroids
NOISE = "['hubert']['layers_0']['attention']['k_proj']['bias']"


def make_batch(rng, B=4, T=3200, lengths=(3200, 2600, 3200, 2000)):
    """Rows of two or more lengths, zero past each, masks inside them."""
    lens = np.resize(np.asarray(lengths), B)
    attn = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    wav = rng.standard_normal((B, T)).astype(np.float32) * 0.1 * attn
    max_pos = (lens - 80) // 320 - L
    return {"wav": wav, "attn_mask": attn,
            "mask_pos": np.array([rng.integers(0, m) for m in max_pos],
                                 np.int32),
            "labels": rng.integers(0, K, (B, L)).astype(np.int32)}


def setup(rng, loss="cos_sim", **over):
    out_dim = K if loss == "softmax" else 8
    tree = testing.hubert_tree(HubertConfig(**TINY), out_dim, rng)
    centroids = rng.standard_normal((K, 8)).astype(np.float32)
    return tree, centroids, out_dim, dict(mask_length=L, loss=loss, **over)


def jax_run(tree, centroids, out_dim, over, batches, dtype=jnp.float32):
    """The JAX step over `batches`: (final state, [metrics])."""
    cfg = jea.EAConfig(**over)
    model = JaxModel(JaxConfig(**TINY, dtype=dtype), out_dim=out_dim)
    step = jax.jit(jea.make_train_step(model, cfg, centroids))
    state = jea.create_state(cfg, jax.tree.map(jnp.asarray, tree))
    ms = []
    for b in batches:
        state, m = step(state, b)
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


def port_run(tree, centroids, out_dim, over, batches, dtype=torch.float32):
    cfg = pea.EAConfig(**over)
    model = trainable_hubert(HubertConfig(**TINY, dtype=dtype), tree,
                             out_dim, device="cpu")
    state = pea.create_state(cfg, model)
    step = pea.make_train_step(cfg, centroids, "cpu")
    ms = []
    for b in batches:
        state, m = step(state, b)
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


def jax_moments(opt_state, name):
    """AdamW's `name` moment ("mu", "nu") of each group, as one tree."""
    if hasattr(opt_state, "inner_state"):          # the guard's wrapper
        opt_state = opt_state.inner_state
    groups = opt_state[1].inner_states
    out = {"head": getattr(groups["head"].inner_state[0], name)["head"]}
    if isinstance(groups["base"].inner_state[0], optax.ScaleByAdamState):
        out["hubert"] = getattr(groups["base"].inner_state[0],
                                name)["hubert"]
    return out


def port_moments(state, name):
    """AdamW's exp_avg ("mu") or exp_avg_sq ("nu") as a JAX-layout tree
    of the groups it has."""
    key = {"mu": "exp_avg", "nu": "exp_avg_sq"}[name]
    opt = state.optimizer
    tree = hubert_tree(state.model, of=lambda p: opt.state[p][key]
                       if p in opt.state else torch.zeros_like(p))
    return tree if len(opt.param_groups) == 2 else {"head": tree["head"]}


def assert_trees(want, got, rtol, atol, what, skip=None):
    """Leaf by leaf; `skip` names a leaf the caller holds otherwise."""
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(flat)
    for path, a in leaves:
        if jax.tree_util.keystr(path) == skip:
            continue
        np.testing.assert_allclose(flat[path], np.asarray(a), rtol=rtol,
                                   atol=atol, err_msg=f"{what} "
                                   f"{jax.tree_util.keystr(path)}")


# --------------------------------------------------------------- the losses

@pytest.mark.parametrize("fn", ["compute_targets", "cos_sim", "mse",
                                "soft_ce", "cos_sim_pred_target"])
def test_centroid_losses_match_jax(rng, fn):
    C = rng.standard_normal((K, 8)).astype(np.float32)
    out = rng.standard_normal((3, 5, K if fn == "soft_ce" else 8)
                              ).astype(np.float32)
    labels = rng.integers(0, K, (3, 5))
    want, got = JaxLosses(C), CentroidLosses(C)
    if fn == "compute_targets":
        args = ()
    elif fn == "cos_sim_pred_target":
        args = (rng.integers(0, K, (3, 5)), labels)
    else:
        args = (out, labels)
    w = getattr(want, fn)(*(jnp.asarray(a) for a in args))
    g = getattr(got, fn)(*(torch.as_tensor(a) for a in args))
    if fn in ("cos_sim", "mse", "soft_ce"):
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
        w, g = w[0], g[0]
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ------------------------------------------------- the masked, trainable model

@pytest.mark.parametrize("arrangement", ["base", "large"])
def test_masked_forward_matches_flax(rng, arrangement):
    """Two lengths in one padded batch: the projected features past each
    row's frames are zeroed and its padded keys left out, in both."""
    cfg = getattr(HubertConfig, arrangement)(**TINY)
    tree = testing.hubert_tree(cfg, 8, rng)
    b = make_batch(rng, B=2, lengths=(3200, 1900))
    want = jax.jit(JaxModel(getattr(JaxConfig, arrangement)(**TINY),
                            out_dim=8).apply)(
        {"params": tree}, jnp.asarray(b["wav"]), jnp.asarray(b["attn_mask"]))
    for model in (trainable_hubert(cfg, tree, 8, device="cpu"),
                  inference_hubert(trainable_hubert(cfg, tree, 8,
                                                    device="cpu"))):
        with torch.no_grad():
            got = model(torch.as_tensor(b["wav"]),
                        torch.as_tensor(b["attn_mask"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the mask matters: without it the short row's output moves
    with torch.no_grad():
        unmasked = model(torch.as_tensor(b["wav"]))
    assert np.abs(unmasked[1].numpy() - np.asarray(want[1])).max() > 1e-3


def test_trainable_form(rng):
    """float32 parameters that require grad whatever cfg.dtype, weight
    norm's (g, v) apart, the tree read back as it went in; the inference
    form folds it and stores cfg.dtype."""
    tree = testing.hubert_tree(HubertConfig(**TINY), 8, rng)
    model = trainable_hubert(HubertConfig(**TINY, dtype=torch.bfloat16),
                             tree, 8, device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    names = {n for n, _ in model.named_parameters()}
    assert "hubert.pos_conv_embed.conv.parametrizations.weight.original0" \
        in names and "hubert.pos_conv_embed.conv.weight" not in names
    assert_trees(tree, hubert_tree(model), 0, 0, "round trip")
    inf = inference_hubert(model)
    assert not any(p.requires_grad for p in inf.parameters())
    assert inf.hubert.pos_conv_embed.conv.weight.dtype == torch.bfloat16
    assert inf.head.linear.weight.dtype == torch.float32


def test_init_follows_flax(rng):
    """Each parameter's std within 5% of flax's init at the same shape
    (weights of 2 000 to 800 000 entries), flax's fans: dense (in, out),
    convs (C_out, C_in, K) with the fan over all but the last axis; norms
    one and zero, biases zero, conv_g = ‖v‖ per tap."""
    over = dict(conv_dim=(512,) * 7, hidden_size=256, num_hidden_layers=1,
                num_attention_heads=4, intermediate_size=1024,
                num_conv_pos_embeddings=32, num_conv_pos_embedding_groups=16)
    cfg = HubertConfig.large(**over)
    want = jax.jit(JaxModel(JaxConfig.large(**over), out_dim=80).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3200)))["params"]
    model = EncoderWithHead(cfg, 80, weight_norm=True)
    init_flax_(model, torch.Generator().manual_seed(0))
    got = dict(jax.tree_util.tree_leaves_with_path(hubert_tree(model)))
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        a, b, name = np.asarray(a), got[path], jax.tree_util.keystr(path)
        assert a.shape == b.shape, name
        if a.size >= 2000:
            assert abs(b.std() / a.std() - 1) < 0.05, name
            assert abs(b.mean()) < 0.05 * a.std(), name
        elif "conv_g" not in name:
            np.testing.assert_array_equal(b, a, err_msg=name)
    pc = hubert_tree(model)["hubert"]["pos_conv_embed"]
    np.testing.assert_allclose(
        pc["conv_g"], np.sqrt((pc["conv_v"] ** 2).sum(axis=(0, 1))),
        rtol=1e-5)       # float32 sums of 2 048 squares, in two orders


# ------------------------------------------------------------- the step

def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def check_step(tree, js, jm, ps, pm):
    """One step's metrics, parameters and moments at the step's gates, the
    zero-gradient k_proj bias held to its noise bound (module docstring)."""
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5)
    assert (pm["acc"], pm["cos_sim_acc"]) == (jm["acc"], jm["cos_sim_acc"])
    got_p = hubert_tree(ps.model)
    path = ("hubert", "layers_0", "attention", "k_proj", "bias")
    for side, params, mu in (("jax", js.params, jax_moments(js.opt_state,
                                                            "mu")),
                             ("port", got_p, port_moments(ps, "mu"))):
        # the gradient the step saw: mu = (1 − b1)·g after one step
        p0, p1, g = (np.asarray(_at(t, path)) for t in (tree, params, mu))
        n = float(np.abs(g).max()) / 0.1
        assert np.abs(p1 - p0 * (1 - 1e-4 * 1e-2)).max() <= \
            1e-4 * n / (n + 1e-6) * 1.001 + 1e-12, side
    assert_trees(js.params, got_p, 2e-5, 2e-6, "params", skip=NOISE)
    for m in ("mu", "nu"):
        assert_trees(jax_moments(js.opt_state, m), port_moments(ps, m),
                     2e-5, 2e-6, m)


def test_twelve_steps_match_jax(rng):
    tree, centroids, out_dim, over = setup(rng)
    batch = make_batch(rng)
    js, jms = jax_run(tree, centroids, out_dim, over, [batch] * 12)
    ps, pms = port_run(tree, centroids, out_dim, over, [batch] * 12)
    np.testing.assert_allclose([m["loss"] for m in pms],
                               [m["loss"] for m in jms], rtol=1e-4)
    assert pms[-1]["loss"] < pms[0]["loss"]
    assert ps.step == 12
    got = hubert_tree(ps.model)
    assert_trees(js.params, got, 0, 1e-5, "params", skip=NOISE)
    # the zero-gradient k_proj bias moves by noise alone on each side:
    # Adam's |m̂|/√v̂ stays below 2.5 for betas (0.9, 0.98), so 12 steps
    # move it by at most 12·2.5·lr
    path = ("hubert", "layers_0", "attention", "k_proj", "bias")
    for params in (js.params, got):
        assert np.abs(np.asarray(_at(params, path))
                      - _at(tree, path)).max() <= 12 * 2.5 * 1e-4


@pytest.mark.parametrize("case", ["clip_acts", "frozen_encoder"])
def test_optimizer_alone_matches_optax(rng, case):
    """The update alone, fed JAX's own gradients (×1000 in `clip_acts`, so
    that ‖g‖ > 10 and the clip scales them; `frozen_encoder`: the
    encoder's gradients count in the norm, and the encoder moves not at
    all): two steps, parameters within 1e-7."""
    tree, centroids, out_dim, over = setup(rng)
    over["train_encoder"] = case != "frozen_encoder"
    grads = jax.jit(jax.grad(lambda p: sum(jnp.sum(jnp.sin(x) * x) for x in
                                           jax.tree.leaves(p))))(
        jax.tree.map(jnp.asarray, tree))
    if case == "clip_acts":
        grads = jax.tree.map(lambda g: g * 1000.0, grads)
    assert float(optax.global_norm(grads)) > 10
    cfg = jea.EAConfig(**over)
    params = jax.tree.map(jnp.asarray, tree)
    opt = jea.make_optimizer(cfg, params)
    opt_state = opt.init(params)
    model = trainable_hubert(HubertConfig(**TINY), tree, out_dim,
                             device="cpu")
    popt = pea.make_optimizer(pea.EAConfig(**over), model)
    # the same gradients in the port's layout, parameter by parameter
    as_port = trainable_hubert(HubertConfig(**TINY),
                               jax.tree.map(np.asarray, grads), out_dim,
                               device="cpu")
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    for _ in range(2):
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(model.parameters(), as_port.parameters()):
            p.grad = g.detach().clone()
        pea.clip_by_global_norm_([p.grad for p in model.parameters()],
                                 cfg.clip_norm)
        popt.step()
    assert_trees(params, hubert_tree(model), 0, 1e-7, "params")
    if case == "frozen_encoder":
        assert_trees(tree["hubert"], hubert_tree(model)["hubert"], 0, 0,
                     "frozen")


def test_gather_clamps_as_dynamic_slice(rng):
    out = rng.standard_normal((3, 7, 2)).astype(np.float32)
    pos = np.array([5, -2, 1], np.int32)
    want = jax.vmap(lambda o, p: jax.lax.dynamic_slice_in_dim(
        o, p, 4, axis=0))(jnp.asarray(out), jnp.asarray(pos))
    got = pea.gather_masked(torch.as_tensor(out), torch.as_tensor(pos), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_step_runs_in_full_f32(rng, monkeypatch):
    """The step pins full float32 for its forward and backward, and gives
    the caller's TF32 flags back."""
    tree, centroids, out_dim, over = setup(rng)
    model = trainable_hubert(HubertConfig(**TINY), tree, out_dim,
                             device="cpu")
    flags = lambda: (torch.backends.cudnn.allow_tf32,  # noqa: E731
                     torch.backends.cuda.matmul.allow_tf32)
    seen = []
    model.register_forward_pre_hook(lambda m, a: seen.append(flags()))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cfg = pea.EAConfig(**over)
    pea.make_train_step(cfg, centroids, "cpu")(pea.create_state(cfg, model),
                                               make_batch(rng))
    pea.eval_step(cfg, centroids, "cpu")(model, make_batch(rng))
    assert seen == [(False, False)] * 2 and flags() == (True, True)
