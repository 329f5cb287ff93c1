"""The centroid-substitution ("modified") GAN step of the port against the
JAX package's, on the CPU in float32, at tests/test_train_variants.py's
sizes (test_torch_gan_step.py's helpers and gates): a 2-frame span of the
hop-441 mel replaced by its nearest of 10 centroids at each row's
`mask_start`, and every frame replaced (mask_len = −1); then
make_modified_eval's mel_error (rel 1e-5) through the folded generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_inpainting_tpu.train import hifigan as jhg
from speech_inpainting_torch.convert.from_jax import trainable_generator
from speech_inpainting_torch.train import hifigan as phg
from test_torch_gan_step import batches, compare_steps, configs, trees
from test_torch_gan_models import _two_threads  # noqa: F401



@pytest.mark.parametrize("mask_len", [2, -1], ids=["span", "all_frames"])
def test_modified_step_matches_jax(rng, mask_len):
    jcfg, pcfg = configs(mask_len=mask_len)
    tree = trees(4)
    C = rng.standard_normal((10, 80)).astype(np.float32)
    bs = batches(rng, 2, mask=True)
    out, want, noisy = compare_steps(
        jcfg, pcfg, tree, lambda c, **d: jhg.make_modified_step(c, C, **d),
        lambda c: phg.make_modified_step(c, C), bs)
    print("outside both gates:", noisy)
    assert [s.step for s, _ in out] == [1, 2]


def test_modified_eval_matches_jax(rng):
    jcfg, pcfg = configs()
    tree = trees(5)
    C = rng.standard_normal((10, 80)).astype(np.float32)
    b = batches(rng, 1, mask=True)[0]
    want = jax.jit(jhg.make_modified_eval(jcfg, C))(
        jax.tree.map(jnp.asarray, tree[0]),
        {k: jnp.asarray(v) for k, v in b.items()})
    gen = trainable_generator(pcfg.hifigan, tree[0], device="cpu")
    got = phg.make_modified_eval(pcfg, C)(gen, b)
    np.testing.assert_allclose(got["mel_error"], float(want["mel_error"]),
                               rtol=1e-5)
    # the span matters: another mask start moves the generator's input
    other = dict(b, mask_start=(b["mask_start"] + 1) % 3)
    fwd = phg.modified_gen_fwd(pcfg, C)
    with torch.no_grad():
        a = fwd(gen, {k: torch.as_tensor(v) for k, v in b.items()})
        c = fwd(gen, {k: torch.as_tensor(v) for k, v in other.items()})
    assert not torch.equal(a, c)
