"""The joint enc-VQ-dec regime of the unit HiFi-GAN trainer (train/da.py's
stateful step: the content codebook updates inside every generator
forward) against the JAX package's `make_da_step(cfg)` and
`create_da_state`, on the CPU in float32, in tests/test_train_da_vq.py's
geometry (:36-64): a content encoder of width 8 (stride 4), a 4 × 16
codebook, a 16-wide generator upsampling 4×, B = 2 × 64 samples, an
8-band mel; test_torch_da_step.py's reduced discriminators.

The restart candidates are the one drawn part: JAX draws them from its
state's PRNG key, the port from its state's CPU torch.Generator, and torch
cannot replay JAX's stream. So JAX's own candidates are recorded as its
step draws them (a `jax.debug.callback` around its `_tile_candidates`) and
handed to the port's step in place of its own draws, as
test_torch_vq_train.py does; JAX's labels are recorded the same way (around
its `pairwise_sqdist`), the port's by a forward hook. The two batch items
are equal, so every encoder frame has a twin, and the seed of JAX's key
makes its first draw take a twin pair: the first step initialises the
codebook from that draw and restarts the code that lost its twin (`SEED`
says why that seed).

Tolerances: labels equal at every step; metrics rel 1e-5; parameters,
moments, u/v and the codebook's float buffers by testing.parity_gate
beside the port's float64 step from the same start
(test_torch_da_step.py's gates), `initted` equal; a NaN batch under
skip_nonfinite leaves every codebook buffer, parameter and moment
bit-equal on the port's side (JAX's too) and counts one skip.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_inpainting_tpu.quantize.vq as jvq
import speech_inpainting_torch.quantize.vq as pvq
from speech_inpainting_tpu.models import codegen as jcg
from speech_inpainting_tpu.models import hifigan as jh
from speech_inpainting_tpu.models import jukebox as jj
from speech_inpainting_tpu.train import da as jda
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (codegen_from_jax,
                                                      codegen_tree)
from speech_inpainting_torch.device import full_f32
from speech_inpainting_torch.models import codegen as pcg
from speech_inpainting_torch.models import hifigan as ph
from speech_inpainting_torch.models import jukebox as pj
from speech_inpainting_torch.train import da as pda
from test_torch_da_step import (adopt, check_step, da_configs, jax_discs,
                                jax_init, jax_state, port_moments,
                                port_params, port_state, reduced_discs,
                                to_f64)
from test_torch_gan_models import _leaves, _two_threads  # noqa: F401
from test_torch_gan_step import f64_batch

T_IN = 64          # code samples → 16 encoder frames → 64 wav samples
STEPS = 3
# create_da_state's seed: its first draw of 4 of the 32 frames takes a
# twin pair (the two batch items are equal), so the first step restarts
# the second twin's code at its candidate, the first twin's frame. Each
# code then takes at least 4 frames, so the first twin's code moves off
# that frame: under a seed whose twin code takes the twins alone (7, 9),
# it stays there, the restarted code ties it, and the next step's labels
# go by rounding
SEED = 4
MEL = dict(n_fft=32, num_mels=8, hop_size=8, win_size=32,
           sampling_rate=16000, fmax=None)
STACK = dict(input_emb_width=1, output_emb_width=16, levels=1, downs_t=(2,),
             strides_t=(2,), width=8, depth=1, m_conv=1.0,
             dilation_growth_rate=3)


def joint_cfg(codegen, hifigan, jukebox):
    return codegen.CodeGeneratorConfig(
        hifigan=hifigan.HiFiGANConfig(
            resblock="1", upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3, 5),), in_dim=16,
            sampling_rate=16000),
        multispkr=False, use_f0=False, f0_quantizer=None,
        code_encoder=jukebox.ConvStackConfig(**STACK), code_vq_bins=4,
        code_vq_width=16)


JC, PC = joint_cfg(jcg, jh, jj), joint_cfg(pcg, ph, pj)


def configs():
    from speech_inpainting_tpu.ops import mel as jmel
    from speech_inpainting_torch.ops import mel as pmel
    jcfg, pcfg = da_configs(JC, PC, lambda_commit=0.02, skip_nonfinite=3)
    return (dataclasses.replace(jcfg, mel_loss=jmel.MelConfig(**MEL)),
            dataclasses.replace(pcfg, mel_loss=pmel.MelConfig(**MEL)))


def batches(rng, n):
    out = []
    for _ in range(n):
        code = rng.standard_normal((1, 1, T_IN)).astype(np.float32)
        y = (rng.standard_normal((1, 1, T_IN)) * 0.2).astype(np.float32)
        out.append({"code": np.concatenate([code, code]),
                    "audio": np.concatenate([y, y[:, :, ::-1]])})
    return out


class Recorder:
    """JAX's candidates and labels, one list per step."""

    def __init__(self):
        self.pending = {"cand": [], "labels": []}
        self.steps = []

    def close_step(self):
        jax.effects_barrier()
        self.steps.append({k: v[:] for k, v in self.pending.items()})
        for v in self.pending.values():
            v.clear()


def start_trees(rng):
    """The trees both sides start from: CodeGenerator(cfg).init's, the
    generator replaced by the signal-carrying one (an uninitialised
    codebook), and reduced discriminators."""
    params, vq = jax_init(JC, np.zeros((2, 1, T_IN), np.float32))
    params["generator"] = testing.generator_tree(JC.hifigan, rng, carry=True)
    return params, vq, reduced_discs(9)


def port_trees(rng):
    """start_trees' kind of trees from the port's own fresh init (no JAX
    compile), for the tests that run the port alone."""
    from speech_inpainting_torch.convert.from_jax import trainable_codegen
    params, vq = codegen_tree(trainable_codegen(PC, seed=int(rng.integers(
        1 << 30)), device="cpu"))
    params["generator"] = testing.generator_tree(JC.hifigan, rng, carry=True)
    return params, vq, reduced_discs(9)


def jax_joint_run(jcfg, params, vq, discs, bs):
    """JAX's steps over `bs`: its states, metrics and, per step, its
    candidates and labels."""
    rec = Recorder()
    cand, dist = jvq._tile_candidates, jvq.pairwise_sqdist

    def record_cand(key, x, k_bins):
        c = cand(key, x, k_bins)
        jax.debug.callback(lambda a: rec.pending["cand"].append(np.array(a)),
                           c)
        return c

    def record_labels(x, k):
        d = dist(x, k)
        jax.debug.callback(
            lambda a: rec.pending["labels"].append(np.array(a)),
            jnp.argmin(d, axis=-1))
        return d

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvq, "_tile_candidates", record_cand)
        mp.setattr(jvq, "pairwise_sqdist", record_labels)
        step = jax.jit(jda.make_da_step(jcfg, **jax_discs()))
        state = jax_state(lambda g, mp, mv, spec, q: jda.create_da_state(
            jcfg, g, mp, mv, spec, vq=q, seed=SEED), params, *discs, vq)
        runs = []
        for b in bs:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            runs.append((state, {k: float(v) for k, v in m.items()}))
            rec.close_step()
    return runs, rec.steps


def port_step_with(pcfg, state, batch, cand):
    """One port step whose VQ draws `cand` (JAX's) in place of its own
    candidates; returns (state, metrics, labels)."""
    labels = []
    hook = state.generator.code_vq.level_0.register_forward_hook(
        lambda m, a, out: labels.append(out[0].reshape(-1).numpy().copy()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pvq, "_tile_candidates", lambda gen, x, k: torch.as_tensor(
            cand).to(x.device, x.dtype))
        state, m = pda.make_da_step(pcfg)(state, batch)
    hook.remove()
    return state, m, labels


def test_joint_steps_match_jax():
    """STEPS joint steps from an uninitialised codebook, each from JAX's
    state before it: labels equal, every gate, the first step initialising
    the codebook and restarting a code, the codebook moving over the
    steps; then JAX's step on a NaN batch under skip_nonfinite (which the
    port's is held to in the next test) leaves its state as it was."""
    rng = np.random.default_rng(20)
    jcfg, pcfg = configs()
    params, vq, discs = start_trees(rng)
    bs = batches(rng, STEPS + 1)
    bs[-1]["code"][0, 0, 5] = np.nan
    runs, draws = jax_joint_run(jcfg, params, vq, discs, bs)
    start = dict(pcfg=pcfg, params=params, vq=vq, discs=discs,
                 content_vq=True)
    ks = []
    for i in range(STEPS):
        (js, jm), drawn = runs[i], draws[i]
        assert len(drawn["cand"]) == len(drawn["labels"]) == 1
        out = []
        for f64 in (False, True):
            ps = port_state(**start)
            if i:
                adopt(ps, runs[i - 1][0])
            ps = to_f64(ps) if f64 else ps
            b = f64_batch(bs[i]) if f64 else bs[i]
            out.append(port_step_with(pcfg, ps, b, drawn["cand"][0]))
        (ps, pm, labels), (ref, _, ref_labels) = out
        np.testing.assert_array_equal(labels[0], drawn["labels"][0])
        np.testing.assert_array_equal(ref_labels[0], drawn["labels"][0])
        check_step(js, jm, ps, pm, ref)
        vq = codegen_tree(ps.generator)[1]["code_vq"]["level_0"]
        assert bool(vq["initted"]) and bool(
            js.vq["code_vq"]["level_0"]["initted"])
        if i == 0:
            # the twin pair's second code lost every frame to the first:
            # k_elem 0.99 < 1, restarted at its candidate
            dead = vq["k_elem"] < 1.0
            assert dead.any()
            np.testing.assert_array_equal(
                vq["k"][dead], drawn["cand"][0][dead])
        ks.append(vq["k"])
    assert np.abs(ks[-1] - ks[0]).max() > 1e-6
    (js_prev, _), (js_bad, jm_bad) = runs[STEPS - 1], runs[STEPS]
    assert jm_bad["nonfinite_skips"] == 1
    for a, b in ((js_bad.vq, js_prev.vq), (js_bad.g_params, js_prev.g_params),
                 (js_bad.d_params, js_prev.d_params)):
        la, lb = _leaves(a), _leaves(b)
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_nan_batch_leaves_the_joint_state_as_it_was():
    """skip_nonfinite in the joint regime, the port's own candidates (its
    state's generator): after a clean step from an uninitialised codebook,
    a NaN in the code input moves no codebook buffer, parameter or moment
    (the codebooks are gated on their own finiteness, outside both
    optimizers) and counts one skip; the next clean step moves the
    codebook again."""
    rng = np.random.default_rng(21)
    _, pcfg = configs()
    params, vq, discs = port_trees(rng)
    good, bad, again = batches(rng, 3)
    bad["code"][0, 0, 5] = np.nan
    ps = port_state(pcfg, params, vq, discs, content_vq=True, seed=3)
    step = pda.make_da_step(pcfg)
    ps, m0 = step(ps, good)
    before = _snapshot(ps)
    ps, m = step(ps, bad)
    after = _snapshot(ps)
    assert before.keys() == after.keys()
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert (m0["nonfinite_skips"], m["nonfinite_skips"]) == (0, 1)
    assert ps.g_guard.notfinite_count == ps.d_guard.notfinite_count == 1
    ps, m = step(ps, again)
    assert m["nonfinite_skips"] == 0 and np.isfinite(float(m["commit"]))
    moved = _snapshot(ps)
    assert not np.array_equal(moved["vq ['code_vq']['level_0']['k']"],
                              after["vq ['code_vq']['level_0']['k']"])


def _snapshot(ps) -> dict:
    out = {f"param {k}": v for k, v in _leaves(port_params(ps)).items()}
    for key in ("exp_avg", "exp_avg_sq"):
        out.update({f"{key} {k}": v for k, v in
                    _leaves(port_moments(ps, key)).items()})
    out.update({f"vq {k}": v for k, v in
                _leaves(codegen_tree(ps.generator)[1]).items()})
    return out


def test_in_forward_update_leaves_the_backward_intact(rng):
    """The codebook's in-place update inside the training forward writes
    only buffers that no saved tensor of the graph aliases: the same
    forward's gradient is unchanged when every buffer is overwritten
    between the forward and the backward (the D step's place), and autograd
    raises no version-counter error."""
    from speech_inpainting_torch.convert.from_jax import trainable_codegen
    code = torch.as_tensor(rng.standard_normal((2, 1, T_IN)).astype(
        np.float32))
    grads = []
    for overwrite in (False, True):
        module = trainable_codegen(PC, seed=4, device="cpu")
        gen = torch.Generator().manual_seed(0)
        with full_f32():
            wav, commit, _ = module(code, train=True, generator=gen)
            if overwrite:
                with torch.no_grad():
                    for b in module.buffers():
                        b.add_(1) if b.is_floating_point() else b.fill_(
                            False)
            (wav.square().mean() + 0.02 * commit).backward()
        grads.append({n: p.grad.clone() for n, p in
                      module.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def test_joint_fold_equals_codegen_from_jax(rng):
    """The content-VQ WNCodeGenerator folded, after a training forward
    filled its codebook: equal to codegen_from_jax of its trees (float code
    and integer units, atol 1e-6), codebooks carried."""
    from speech_inpainting_torch.convert.from_jax import trainable_codegen
    module = trainable_codegen(PC, seed=5, device="cpu")
    code = torch.as_tensor(batches(rng, 1)[0]["code"])
    with torch.no_grad():
        module(code, train=True, generator=torch.Generator().manual_seed(1))
    params, vq = codegen_tree(module)
    folded, want = module.fold(), codegen_from_jax(PC, params, vq,
                                                   device="cpu")
    units = torch.as_tensor(np.asarray([[0, 1, 2, 3] * 4] * 2))
    with torch.no_grad(), full_f32():
        for x in (code, units):
            a, b = folded(x)[0], want(x)[0]
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    for k, v in _leaves(codegen_tree(module)[1]).items():
        np.testing.assert_array_equal(v, _leaves(vq)[k])
