"""The port's I_ea train step in each of its modes against the JAX
package's same mode, on the CPU at tests/test_train_ea.py's TINY HuBERT
(the helpers and gates of tests/test_torch_train_ea.py):
  - grad_accum=2: two microbatches whose gradients add up, the summed loss
    and the mean accuracies; the step's gates (loss rel 1e-5, parameters
    and moments rtol 2e-5, atol 2e-6);
  - skip_nonfinite: a batch with a nan sample leaves the parameters and
    both moments bit-equal to what they were and counts one skip; the
    finite batch after it updates as JAX's does (the step's gates);
  - bfloat16 compute: the parameters stay float32; against JAX's bf16 step
    and against the port's f32 step, the loss within rtol 2e-2 and the
    parameters within atol 5e-3 (tests/test_train_ea.py:55-89's bounds
    against f32);
  - length buckets: the same rows padded to a tight bucket (3200) and to
    twice that, each step against JAX's at the same padding (the step's
    gates): padding changes the outputs a little through HuBERT's
    GroupNorm and positional conv, in both packages alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from speech_inpainting_torch.convert.from_jax import hubert_tree
from test_torch_train_ea import (assert_trees, check_step, jax_moments,
                                 jax_run, make_batch, port_moments, port_run,
                                 setup)


def test_grad_accum_matches_jax(rng):
    tree, centroids, out_dim, over = setup(rng, grad_accum=2)
    batch = make_batch(rng)
    js, (jm,) = jax_run(tree, centroids, out_dim, over, [batch])
    ps, (pm,) = port_run(tree, centroids, out_dim, over, [batch])
    check_step(tree, js, jm, ps, pm)


def test_skip_nonfinite_matches_jax(rng):
    tree, centroids, out_dim, over = setup(rng, skip_nonfinite=5)
    batch = make_batch(rng)
    bad = dict(batch, wav=batch["wav"].copy())
    bad["wav"][0, 10] = np.nan
    ps, pms = port_run(tree, centroids, out_dim, over, [bad])
    assert not np.isfinite(pms[0]["loss"]) and pms[0]["nonfinite_skips"] == 1
    assert_trees(tree, hubert_tree(ps.model), 0, 0, "skipped params")
    assert not ps.optimizer.state       # no moment and no count were made
    assert ps.step == 1
    # the bad batch, then a finite one: the first real update
    js, jms = jax_run(tree, centroids, out_dim, over, [bad, batch])
    ps, pms = port_run(tree, centroids, out_dim, over, [bad, batch])
    assert [m["nonfinite_skips"] for m in pms] == \
        [m["nonfinite_skips"] for m in jms] == [1, 0]
    assert (ps.guard.notfinite_count, ps.guard.total_notfinite) == (0, 1)
    assert int(js.opt_state.total_notfinite) == 1 and ps.step == 2
    check_step(tree, js, jms[1], ps, pms[1])


def test_bf16_step_matches_jax(rng):
    tree, centroids, out_dim, over = setup(rng)
    batch = make_batch(rng)
    js, (jm,) = jax_run(tree, centroids, out_dim, over, [batch],
                        dtype=jnp.bfloat16)
    ps, (pm,) = port_run(tree, centroids, out_dim, over, [batch],
                         dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in ps.model.parameters())
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=2e-2)
    assert_trees(js.params, hubert_tree(ps.model), 0, 5e-3, "bf16 params")
    # and, as tests/test_train_ea.py holds JAX's, against the f32 step
    p32, (m32,) = port_run(tree, centroids, out_dim, over, [batch])
    np.testing.assert_allclose(pm["loss"], m32["loss"], rtol=2e-2)
    assert_trees(hubert_tree(p32.model), hubert_tree(ps.model), 0, 5e-3,
                 "bf16 vs f32 params")
    for m in ("mu", "nu"):
        assert jax.tree.structure(jax_moments(js.opt_state, m)) == \
            jax.tree.structure(port_moments(ps, m))


def test_bucketed_step_matches_jax(rng):
    tree, centroids, out_dim, over = setup(rng)
    tight = make_batch(rng, B=2, T=3200, lengths=(2000, 2600))
    full = dict(tight, wav=np.pad(tight["wav"], ((0, 0), (0, 3200))),
                attn_mask=np.pad(tight["attn_mask"], ((0, 0), (0, 3200))))
    losses = []
    for batch in (tight, full):
        js, (jm,) = jax_run(tree, centroids, out_dim, over, [batch])
        ps, (pm,) = port_run(tree, centroids, out_dim, over, [batch])
        check_step(tree, js, jm, ps, pm)
        losses.append(pm["loss"])
    assert losses[0] != losses[1]      # the padding is seen, as in JAX
