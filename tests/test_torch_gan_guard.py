"""The GAN step's other paths against the JAX package's, on the CPU in
float32 (test_torch_gan_step.py's helpers and gates): the `has_commit`
path (a generator_fwd returning (ŷ, commit), lambda_commit 0.5) over
reduced discriminator overrides (MPD periods (2, 3), MSD 2 scales), two
steps; the nonfinite guard (a finite step, then a batch with a nan: no
parameter, moment or count moves on either side, one skip counted, the
u/v advanced as JAX's); and `batched_disc` on against off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speech_inpainting_tpu.ops.mel import mel_spectrogram as jax_mel
from speech_inpainting_tpu.train import gan as jgan
from speech_inpainting_tpu.train import hifigan as jhg
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (mpd_from_jax,
                                                      msd_from_jax)
from speech_inpainting_torch.ops.mel import mel_spectrogram
from speech_inpainting_torch.train import gan as pgan
from speech_inpainting_torch.train import hifigan as phg
from test_torch_gan_models import _leaves, _two_threads  # noqa: F401
from test_torch_gan_step import (batches, compare_steps, configs,
                                 f64_batch, jax_moments, jax_states, moments,
                                 params, port_state, to_f64, trees)


REDUCED = dict(mpd_periods=(2, 3), scales=2)


def reduced_trees(seed):
    mpd = mpd_from_jax(None, (2, 3), device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    msd = msd_from_jax(None, None, 2, device="cpu",
                       generator=torch.Generator().manual_seed(seed + 1))
    return trees(seed, mpd, msd)


def test_commit_path_over_reduced_overrides_matches_jax(rng):
    jcfg, pcfg = configs(lambda_commit=0.5)
    pfwd = phg.vanilla_gen_fwd(pcfg)

    def jmake(c, mpd, msd):
        return jgan.make_gan_step(
            lambda g, b: (lambda y: (y, jnp.mean(jnp.square(y))))(
                jhg.vanilla_gen_fwd(c)(g, b)),
            lambda w: jax_mel(w, c.mel_loss), c.gan, mpd=mpd, msd=msd)

    def pmake(c):
        return pgan.make_gan_step(
            lambda g, b: (lambda y: (y, torch.mean(torch.square(y))))(
                pfwd(g, b)),
            lambda w: mel_spectrogram(w, c.mel_loss), c.gan)

    out, want, noisy = compare_steps(jcfg, pcfg, reduced_trees(6), jmake,
                                     pmake, batches(rng, 2), **REDUCED)
    print("outside both gates:", noisy)
    for (_, pm), (_, jm) in zip(out, want):
        assert pm["commit"] > 0
        np.testing.assert_allclose(float(pm["commit"]), jm["commit"],
                                   rtol=1e-5)


def _frozen_copy(state):
    return {"params": jax.tree.map(np.copy, _leaves(params(state))),
            "mu": _leaves(moments(state, "exp_avg")),
            "nu": _leaves(moments(state, "exp_avg_sq")),
            "counts": [s["step"] for o in (state.g_opt, state.d_opt)
                       for s in o.state.values()]}


def test_guard_skips_a_nan_batch_as_jax_does(rng):
    jcfg, pcfg = configs(skip_nonfinite=3)
    tree = reduced_trees(8)
    good, bad = batches(rng, 2)
    bad["audio"][1, 0, 100] = np.nan
    want = jax_states(jcfg, tree, jhg.make_vanilla_step, [good, bad],
                      **REDUCED)
    state = port_state(pcfg, tree, **REDUCED)
    step = phg.make_vanilla_step(pcfg)
    state, m1 = step(state, good)
    before = _frozen_copy(state)
    uv = _leaves(jax.tree.map(np.copy, _spectral(state)))
    state, m2 = step(state, bad)
    after = _frozen_copy(state)
    for k in ("params", "mu", "nu"):
        for name in before[k]:
            np.testing.assert_array_equal(after[k][name], before[k][name])
    assert after["counts"] == before["counts"] == [1] * len(before["counts"])
    assert (m1["nonfinite_skips"], m2["nonfinite_skips"]) == (0, 1)
    assert state.g_guard.notfinite_count == state.d_guard.notfinite_count == 1
    assert state.step == 2
    (_, jm1), (js2, jm2) = want
    assert (jm1["nonfinite_skips"], jm2["nonfinite_skips"]) == (0, 1)
    # JAX leaves its state as it was too, and its u/v advance as the port's
    jprev = want[0][0]
    for a, b in zip(jax.tree.leaves(js2.g_params),
                    jax.tree.leaves(jprev.g_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got_uv, want_uv = _leaves(_spectral(state)), _leaves(js2.spectral)
    # (conv_post's u has one element, always 1)
    assert sum(not np.array_equal(got_uv[k], uv[k]) for k in uv) >= 14
    for k in want_uv:
        np.testing.assert_allclose(got_uv[k], want_uv[k], rtol=2e-5,
                                   atol=2e-6)
    for a, b in zip(jax.tree.leaves(jax_moments(js2, "mu")),
                    jax.tree.leaves(jax_moments(jprev, "mu"))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _spectral(state):
    from speech_inpainting_torch.convert.from_jax import spectral_tree
    return spectral_tree(state.msd)


def _tensors(ps) -> dict:
    """Every parameter, both moments and the u/v of a state, one flat dict
    ("kind leaf")."""
    kinds = {"param": params(ps), "mu": moments(ps, "exp_avg"),
             "nu": moments(ps, "exp_avg_sq"), "u/v": _spectral(ps)}
    return {f"{k} {n}": a for k, t in kinds.items()
            for n, a in _leaves(t).items()}


def test_batched_disc_against_two_calls(rng):
    """batched_disc on against off: the first step's losses bit-equal (the
    forwards are: test_torch_gan_models.py), its parameters, moments and
    u/v by testing.parity_gate beside the unbatched step in float64, and
    the second step's losses rel 1e-5. Not bit-equal: torch's convolution
    backward sums a weight's gradient over the 2B samples of the one call
    in one reduction, where the two calls add two B-sample sums, so the
    updates differ in rounding (and AdamW's first update in sign, where a
    gradient is that small)."""
    _, pcfg = configs()
    tree = trees(9)
    bs = batches(rng, 2)
    runs, firsts = [], []
    for batched in (False, True):
        cfg = dataclasses.replace(pcfg, gan=dataclasses.replace(
            pcfg.gan, batched_disc=batched))
        step = phg.make_vanilla_step(cfg)
        state, m = step(port_state(cfg, tree), bs[0])
        firsts.append(_tensors(state))
        state, m2 = step(state, bs[1])
        runs.append([{k: float(v) for k, v in x.items()} for x in (m, m2)])
    ref, _ = phg.make_vanilla_step(pcfg)(
        to_f64(port_state(pcfg, tree)), f64_batch(bs[0]))
    (ma, mb) = runs
    assert ma[0] == mb[0]
    for k in ma[1]:
        np.testing.assert_allclose(mb[1][k], ma[1][k], rtol=1e-5)
    off, on, r = firsts[0], firsts[1], _tensors(ref)
    mu = [k for k in off if k.startswith("mu ")]
    zero = testing.zero_up_to_rounding({k: off[k] for k in mu},
                                       {k: r[k] for k in mu})
    rep = testing.parity_gate(on, off, r, exempt={
        "param " + k[3:]: m for k, m in zero.items()},
        bound=testing.ADAMW_NOISE * 2e-4)
    print("batched vs two calls, outside both gates:", rep["outside"],
          rep["exempt"])
    assert rep["ok"], (rep["failed"], rep["outside"])
