"""The port's AdamW (train/optim.py) against optax.adamw for a parameter
the loss does not reach: optax gives every leaf of its tree a gradient,
zero for such a leaf, so its moments decay and the decoupled weight decay
moves it by −lr·wd·p a step; the port steps a parameter whose `.grad` is
None the same way, on its group's count.

Over 6 steps (a drift of lr·wd·p a step, relative 2e-6 at lr 2e-4, grows
past float32 rounding only over several) at the f0-VQ-VAE trainer's
settings, with steps_per_epoch = 2 so that the rate decays twice:
parameters within atol 1e-7, moments within rtol 1e-6, the counts equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from speech_inpainting_torch.train.optim import AdamW, exponential_decay


@pytest.mark.parametrize("none_first", [False, True])
def test_adamw_steps_a_parameter_without_gradient_as_optax(rng,
                                                            none_first):
    p0 = {"used": rng.standard_normal((4, 6)).astype(np.float32),
          "unused": rng.standard_normal(5).astype(np.float32)}
    grads = [rng.standard_normal((4, 6)).astype(np.float32)
             for _ in range(6)]
    sched = optax.exponential_decay(2e-4, 2, 0.999, staircase=True)
    opt = optax.adamw(sched, b1=0.8, b2=0.99, eps=1e-8, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    order = ["unused", "used"] if none_first else ["used", "unused"]
    port = AdamW([params[k] for k in order], lr=2e-4, betas=(0.8, 0.99),
                 eps=1e-8, weight_decay=0.01,
                 schedule=exponential_decay(2e-4, 2, 0.999))
    for g in grads:
        u, js = opt.update({"used": jnp.asarray(g),
                            "unused": jnp.zeros(5, jnp.float32)}, js, jp)
        jp = optax.apply_updates(jp, u)
        params["used"].grad = torch.tensor(g)
        assert params["unused"].grad is None
        port.step()
    for k in p0:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=0, atol=1e-7,
                                   err_msg=k)
        st = port.state[params[k]]
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(js[0].mu[k]), rtol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(js[0].nu[k]), rtol=1e-6,
                                   err_msg=k)
        assert st["step"] == int(js[0].count) == 6
    # the parameter did move, by the weight decay alone (to within its six
    # updates' float32 rounding, half a spacing each)
    moved = np.abs(params["unused"].detach().numpy() - p0["unused"])
    want = np.abs(p0["unused"].astype(np.float64)) * (
        1 - np.prod([1 - float(sched(t)) * 0.01 for t in range(6)]))
    assert (np.abs(moved - want)
            <= 3 * np.abs(np.spacing(p0["unused"]))).all(), (
        moved, want)
    assert (moved > 0).all()
