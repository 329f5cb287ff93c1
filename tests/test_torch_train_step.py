"""One I_ea train step of the port against the JAX package's, for each of
the three losses, on the CPU in float32 at tests/test_train_ea.py's TINY
HuBERT (the helpers and gates of tests/test_torch_train_ea.py): the loss,
the accuracies, the clipped gradients against jax.grad of the JAX step's
loss function (within 1e-5 of each tensor's largest magnitude; the k_proj
bias, whose gradient is zero in exact arithmetic, below 1e-6 of the
model's largest gradient on both sides), the parameters and both AdamW
moments after the step (rtol 2e-5, atol 2e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from speech_inpainting_tpu.losses import CentroidLosses as JaxLosses
from speech_inpainting_tpu.models.hubert import EncoderWithHead as JaxModel
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxConfig
from speech_inpainting_tpu.ops.masking import mask_wave_frames as jax_mask
from speech_inpainting_tpu.train import ea as jea
from speech_inpainting_torch.convert.from_jax import hubert_tree
from test_torch_train_ea import (L, NOISE, TINY, check_step, jax_run,
                                 make_batch, port_run, setup)


def jax_grads(tree, centroids, out_dim, over, batch):
    """jax.grad of the JAX step's loss (train/ea.py's loss_fn), clipped as
    optax.clip_by_global_norm(10) clips it."""
    cfg = jea.EAConfig(**over)
    model = JaxModel(JaxConfig(**TINY), out_dim=out_dim)
    closses = JaxLosses(centroids)
    loss_of = {"cos_sim": closses.cos_sim, "mse": closses.mse,
               "softmax": closses.soft_ce}[cfg.loss]

    def loss_fn(params):
        wav = jax.vmap(jax_mask, in_axes=(0, 0, None))(
            batch["wav"], batch["mask_pos"], L)
        out = model.apply({"params": params}, wav, batch["attn_mask"])
        values = jax.vmap(lambda o, p: jax.lax.dynamic_slice_in_dim(
            o, p, L, axis=0))(out, batch["mask_pos"])
        return loss_of(values, batch["labels"])[0]

    grads = jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, tree))
    return optax.clip_by_global_norm(cfg.clip_norm).update(grads, None)[0]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree



@pytest.mark.parametrize("loss", ["cos_sim", "mse", "softmax"])
def test_one_step_matches_jax(rng, loss):
    tree, centroids, out_dim, over = setup(rng, loss)
    batch = make_batch(rng)
    js, (jm,) = jax_run(tree, centroids, out_dim, over, [batch])
    ps, (pm,) = port_run(tree, centroids, out_dim, over, [batch])
    check_step(tree, js, jm, ps, pm)
    # the gradients the update saw (the clip scales them in place)
    want = jax_grads(tree, centroids, out_dim, over, batch)
    got = dict(jax.tree_util.tree_leaves_with_path(
        hubert_tree(ps.model, of=lambda p: p.grad)))
    top = max(float(np.abs(np.asarray(a)).max())
              for a in jax.tree.leaves(want))
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        a, name = np.asarray(a), jax.tree_util.keystr(path)
        if name == NOISE:   # zero in exact arithmetic, noise on each side
            assert max(np.abs(a).max(), np.abs(got[path]).max()) \
                < 1e-6 * top, name
            continue
        np.testing.assert_allclose(got[path], a, rtol=0,
                                   atol=1e-5 * np.abs(a).max(),
                                   err_msg=name)
