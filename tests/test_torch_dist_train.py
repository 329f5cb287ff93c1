"""The port's trainers on two ranks (gloo on the CPU, each rank its half of
the global batch: tests/torch_dist_worker.py) against the JAX package's
single-device step on the global batch, as tests/test_run_mesh.py and
tests/test_multihost.py hold JAX's mesh: the I_ea step (whose losses are
sums, so the global gradient is the ranks' sum: a mean would halve the
loss and every gradient), the V1 GAN step, the joint DA step with its EMA
codebook, the f0-VQ step, the two runners on a mesh (only rank 0 writes,
a resume on rank 0 alone leaves both ranks equal), and a NaN in one
rank's rows skipping the update on both.

Gates: each step test's own (tests/test_torch_train_ea.py's check_step
but for the accuracies, a mean of the ranks' means, rel 1e-6;
test_torch_gan_step.py's and test_torch_da_step.py's check_step with
testing.parity_gate beside the port's float64 step on the global batch;
test_torch_f0vq.py's tolerances); the runners against the port's
one-process run on the same batches within 2·lr·steps (AdamW's first
updates are sign-like where a gradient is near zero: tests/
test_run_mesh.py's bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_inpainting_tpu.train import f0vq as jf0vq
from speech_inpainting_tpu.train import hifigan as jhg
from speech_inpainting_torch.convert.from_jax import (hubert_tree,
                                                      mpd_from_jax,
                                                      msd_from_jax,
                                                      trainable_fo_vqvae)
from speech_inpainting_torch.models.hubert import HubertConfig
from speech_inpainting_torch.train import ea as pea
from speech_inpainting_torch.train import f0vq as pf0vq
from speech_inpainting_torch.train import hifigan as phg
from speech_inpainting_torch.train.run import (RunConfig, run_ea_training,
                                               run_gan_training)
from test_torch_gan_models import _two_threads  # noqa: F401
from test_torch_train_ea import (NOISE, TINY, _at, assert_trees, jax_run,
                                 jax_moments, make_batch, port_moments,
                                 setup)
from test_torch_vq_train import jax_candidates  # noqa: F401
from torch_dist import launch
from torch_dist_worker import build_state

PERIODS, SCALES = (2,), 1


def _ea_kw(tree, out_dim, over):
    return {"hcfg": HubertConfig(**TINY), "out_dim": out_dim,
            "cfg": pea.EAConfig(**over)}


def _ea_start(kw, tree):
    from speech_inpainting_torch.convert.from_jax import trainable_hubert
    state = build_state("ea", kw)
    state.model.load_state_dict(trainable_hubert(
        kw["hcfg"], tree, kw["out_dim"], device="cpu").state_dict())
    return state


def _loaded(kind, kw, sd):
    state = build_state(kind, kw)
    state.load_state_dict(sd)
    return state


# ------------------------------------------------------------ I_ea

def test_ea_step_sums_over_ranks(rng, tmp_path):
    """One I_ea step, two rows a rank: the loss and every gradient are the
    global batch's sums (the parameters and both moments at the step's
    gates); the accuracies the means over all rows."""
    tree, centroids, out_dim, over = setup(rng)
    batch = make_batch(rng)
    js, (jm,) = jax_run(tree, centroids, out_dim, over, [batch])
    kw = _ea_kw(tree, out_dim, over)
    outs = launch("ea", 2, {"build": ("ea", kw),
                            "start": _ea_start(kw, tree).state_dict(),
                            "cfg": kw["cfg"], "centroids": centroids,
                            "batches": [batch]}, tmp_path)
    for o in outs:
        (pm,) = o["metrics"]
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5)
        for k in ("acc", "cos_sim_acc"):
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-6, err_msg=k)
    ps = _loaded("ea", kw, outs[0]["state"])
    got = hubert_tree(ps.model)
    assert_trees(js.params, got, 2e-5, 2e-6, "params", skip=NOISE)
    path = ("hubert", "layers_0", "attention", "k_proj", "bias")
    n = float(np.abs(np.asarray(_at(port_moments(ps, "mu"), path))).max()
              ) / 0.1
    p0 = np.asarray(_at(tree, path))
    assert np.abs(_at(got, path) - p0 * (1 - 1e-6)).max() <= \
        1e-4 * n / (n + 1e-6) * 1.001 + 1e-12
    for m in ("mu", "nu"):
        assert_trees(jax_moments(js.opt_state, m), port_moments(ps, m),
                     2e-5, 2e-6, m)
    other = _loaded("ea", kw, outs[1]["state"])
    for a, b in zip(ps.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["ea", "gan"])
def test_nan_on_one_rank_skips_on_both(rng, tmp_path, kind):
    """skip_nonfinite: a NaN in rank 1's rows reaches both ranks' reduced
    gradients, so both skip the update and count it; every parameter stays
    as it started, on both."""
    if kind == "ea":
        tree, centroids, out_dim, over = setup(rng, skip_nonfinite=3)
        batch = make_batch(rng)
        batch["wav"][3, 100] = np.nan                # rank 1's second row
        kw = _ea_kw(tree, out_dim, over)
        start = _ea_start(kw, tree).state_dict()
        inp = {"build": ("ea", kw), "start": start, "cfg": kw["cfg"],
               "centroids": centroids, "batches": [batch]}
    else:
        pcfg = _gan_cfgs(skip_nonfinite=3)[1]
        kw, start = _gan_start(pcfg)
        batch = {"audio": (rng.standard_normal((2, 1, 2048)) * 0.2
                           ).astype(np.float32)}
        batch["audio"][1, 0, 7] = np.nan
        inp = {"build": ("gan", kw), "start": start, "cfg": pcfg,
               "batches": [batch]}
    outs = launch(kind, 2, inp, tmp_path)

    def params(state):
        mods = ([state.model] if kind == "ea"
                else [state.generator, state.mpd, state.msd])
        return [p for m in mods for p in m.parameters()]

    before = params(_loaded(kind, kw, start))
    for o in outs:
        assert o["metrics"][0]["nonfinite_skips"] == 1
        after = params(_loaded(kind, kw, o["state"]))
        assert len(after) == len(before)
        for a, b in zip(after, before):
            assert torch.equal(a, b)


# ------------------------------------------------------------ GAN

def _gan_cfgs(**gan):
    from test_torch_gan_step import configs
    return configs(**gan)


def _gan_trees(seed=0):
    from test_torch_gan_step import trees
    mpd = mpd_from_jax(None, PERIODS, device="cpu",
                       generator=torch.Generator().manual_seed(seed + 1))
    msd = msd_from_jax(None, None, SCALES, device="cpu",
                       generator=torch.Generator().manual_seed(seed + 2))
    return trees(seed, mpd, msd)


def _gan_start(pcfg, tree=None):
    from test_torch_gan_step import port_state
    tree = tree or _gan_trees()
    kw = {"gcfg": pcfg.hifigan, "gan": pcfg.gan, "periods": PERIODS,
          "scales": SCALES}
    return kw, port_state(pcfg, tree, PERIODS, SCALES).state_dict()


def test_gan_step_matches_jax(rng, tmp_path):
    """One V1 GAN step (make_vanilla_step), one row a rank of a B = 2
    batch: D and G gradients averaged over the ranks equal the global
    batch's; testing.parity_gate on every parameter, moment and u/v."""
    from test_torch_gan_step import (batches, check_step, f64_batch,
                                     jax_states, port_start)
    jcfg, pcfg = _gan_cfgs()
    tree = _gan_trees()
    bs = batches(rng, 1)
    ((js, jm),) = jax_states(jcfg, tree, jhg.make_vanilla_step, bs,
                             mpd_periods=PERIODS, scales=SCALES)
    kw, start = _gan_start(pcfg, tree)
    outs = launch("gan", 2, {"build": ("gan", kw), "start": start,
                             "cfg": pcfg, "batches": bs}, tmp_path)
    ref, _ = phg.make_vanilla_step(pcfg)(
        port_start(pcfg, tree, None, f64=True, mpd_periods=PERIODS,
                   scales=SCALES), f64_batch(bs[0]))
    ps = _loaded("gan", kw, outs[0]["state"])
    print("outside both gates:",
          check_step(js, jm, ps, outs[0]["metrics"][0], ref))
    other = _loaded("gan", kw, outs[1]["state"]).state_dict()
    for name in ("generator", "mpd", "msd"):
        for k, v in ps.state_dict()[name].items():
            assert torch.equal(other[name][k], v), (name, k)


# ---------------------------------------------------------- DA joint

def test_da_joint_step_matches_jax(tmp_path):
    """The first joint enc-VQ-dec step (it initialises the codebook and
    restarts a code), one row a rank: the content codebook's sums run over
    both ranks' rows and its candidates come from the gathered rows (JAX's,
    recorded and replayed on every rank); labels equal, the codebook
    buffers and every parameter at the step's gates."""
    from test_torch_da_joint import (batches, configs, jax_joint_run,
                                     port_step_with, start_trees)
    from test_torch_da_step import check_step, port_state, to_f64
    from test_torch_gan_step import f64_batch
    rng = np.random.default_rng(20)
    jcfg, pcfg = configs()
    params, vq, discs = start_trees(rng)
    bs = batches(rng, 1)
    ((js, jm),), (drawn,) = jax_joint_run(jcfg, params, vq, discs, bs)
    start = dict(pcfg=pcfg, params=params, vq=vq, discs=discs,
                 content_vq=True)
    kw = {"cfg": pcfg, "periods": PERIODS, "scales": SCALES, "seed": 1234}
    outs = launch("da_joint", 2, {
        "build": ("da_joint", kw), "start": port_state(**start).state_dict(),
        "cfg": pcfg, "batches": bs, "cands": [drawn["cand"][0]]}, tmp_path)
    ref, _, _ = port_step_with(pcfg, to_f64(port_state(**start)),
                               f64_batch(bs[0]), drawn["cand"][0])
    labels = np.concatenate([o["labels"][0] for o in outs])
    np.testing.assert_array_equal(labels, drawn["labels"][0])
    got = _loaded("da_joint", kw, outs[0]["state"])
    check_step(js, jm, got, outs[0]["metrics"][0], ref)
    vq = got.generator.code_vq.level_0
    assert bool(vq.initted) and (vq.k_elem < 1.0).any()     # a restart
    other = _loaded("da_joint", kw, outs[1]["state"])
    for a, b in zip(got.generator.buffers(), other.generator.buffers()):
        assert torch.equal(a, b)


# ------------------------------------------------------------- f0-VQ

def test_f0vq_step_matches_jax(rng, jax_candidates, tmp_path):
    """Two f0-VQ steps from an uninitialised codebook, two rows a rank:
    rank 0 draws JAX's candidates, rank 1 its own, which the broadcast from
    rank 0 replaces; the codebook's sums over both ranks' rows, the
    gradients averaged (test_torch_f0vq.py's tolerances)."""
    from test_torch_f0vq import _adam, _empty_vq, _flat, _torch_name
    from test_torch_f0vq import configs, f0_batch
    from speech_inpainting_torch import testing
    jcfg, pcfg = configs()
    params, _ = testing.fo_vqvae_tree(pcfg.model, rng)
    vq = _empty_vq(pcfg.model)
    js = jf0vq.create_f0vq_state(jcfg, jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, vq))
    jstep = jax.jit(jf0vq.make_f0vq_step(jcfg))
    bs, jms = [f0_batch(rng) for _ in range(2)], []
    for i, b in enumerate(bs):
        js, m = jstep(js, {"f0": jnp.asarray(b["f0"])},
                      jax.random.PRNGKey(i))
        jms.append({k: float(v) for k, v in m.items()})
    cands = [jax_candidates.pop(0) for _ in bs]
    start = pf0vq.create_f0vq_state(pcfg, trainable_fo_vqvae(
        pcfg.model, params, vq, device="cpu"))
    outs = launch("f0vq", 2, {"build": ("f0vq", {"cfg": pcfg}),
                              "start": start.state_dict(), "cfg": pcfg,
                              "batches": bs, "cands": cands}, tmp_path)
    for o in outs:
        for pm, jm in zip(o["metrics"], jms):
            assert sorted(pm) == sorted(jm)
            for k in jm:
                np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
        state = _loaded("f0vq", {"cfg": pcfg}, o["state"])
        got = dict(state.model.named_parameters())
        adam = _adam(js.opt_state)
        jmu, jnu = _flat(adam.mu), _flat(adam.nu)
        for k, want in _flat(js.params).items():
            p = got[_torch_name(k)]
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                       atol=1e-6, err_msg=k)
            opt = state.optimizer.state[p]
            np.testing.assert_allclose(opt["exp_avg"].numpy(), jmu[k],
                                       rtol=1e-5, atol=1e-9, err_msg=k)
            np.testing.assert_allclose(opt["exp_avg_sq"].numpy(), jnu[k],
                                       rtol=1e-5, atol=1e-9, err_msg=k)
        for name, want in _flat(js.vq["vq"]).items():
            buf = getattr(state.model.vq, name.split(".")[0]).get_buffer(
                name.split(".")[1])
            np.testing.assert_allclose(buf.numpy().astype(np.float64),
                                       np.asarray(want, np.float64),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


# ----------------------------------------------------------- runners

def test_run_ea_training_on_a_mesh(rng, tmp_path):
    """run_ea_training over two ranks, each writing to a directory of its
    own: rank 0 alone writes ea_/last_; the run equals the one-process run
    on the same batches within 2·lr·steps; a second run resumes on rank 0
    from its ea_ (rank 1 has none) and leaves both ranks equal, at step 4."""
    tree, centroids, out_dim, over = setup(rng)
    batches = [make_batch(rng) for _ in range(2)]
    kw = _ea_kw(tree, out_dim, over)
    start = _ea_start(kw, tree)
    fresh = build_state("ea", kw)
    outs = launch("run_ea", 2, {
        "build": ("ea", kw), "start": start.state_dict(),
        "fresh": fresh.state_dict(), "cfg": kw["cfg"],
        "centroids": centroids, "batches": batches, "dir": str(tmp_path)},
        tmp_path / "io")
    one = run_ea_training(pea.make_train_step(kw["cfg"], centroids, "cpu"),
                          lambda m, b: {}, start, lambda e: iter(batches),
                          lambda e: iter(()),
                          RunConfig(epochs=1, checkpoint_dir=str(
                              tmp_path / "one"), stdout_interval=100))
    assert outs[0]["files_first"] == ["ea_00000002", "last_00000000"]
    assert outs[1]["files_first"] == outs[1]["files_resumed"] == []
    tol = 2 * kw["cfg"].base_lr * 2
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(outs[0]["first"]["model"][k].numpy(),
                                   v.numpy(), atol=tol, err_msg=k)
    assert outs[0]["resumed"]["step"] == outs[1]["resumed"]["step"] == 4
    for k, v in outs[0]["resumed"]["model"].items():
        assert torch.equal(outs[1]["resumed"]["model"][k], v), k


def test_run_gan_training_on_a_mesh(rng, tmp_path):
    """run_gan_training over two ranks, as the I_ea case: rank 0 alone
    writes g_/do_, the run equals one process's within 2·lr·steps, and a
    resume on rank 0 alone leaves both ranks equal."""
    _, pcfg = _gan_cfgs()
    kw, start = _gan_start(pcfg)
    batches = [{"audio": (rng.standard_normal((2, 1, 2048)) * 0.2
                          ).astype(np.float32)} for _ in range(2)]
    outs = launch("run_gan", 2, {
        "build": ("gan", kw), "start": start,
        "fresh": build_state("gan", kw).state_dict(), "cfg": pcfg,
        "batches": batches, "dir": str(tmp_path)}, tmp_path / "io")
    one = run_gan_training(phg.make_vanilla_step(pcfg),
                           _loaded("gan", kw, start), lambda e: iter(batches),
                           RunConfig(epochs=1, checkpoint_dir=str(
                               tmp_path / "one"), stdout_interval=100))
    assert outs[0]["files_first"] == ["do_00000002", "g_00000002"]
    assert outs[1]["files_first"] == outs[1]["files_resumed"] == []
    tol = 2 * pcfg.gan.learning_rate * 2
    for name, module in (("generator", one.generator), ("mpd", one.mpd)):
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(outs[0]["first"][name][k].numpy(),
                                       v.numpy(), atol=tol, err_msg=k)
    assert outs[0]["resumed"]["step"] == outs[1]["resumed"]["step"] == 4
    for name in ("generator", "mpd"):
        for k, v in outs[0]["resumed"][name].items():
            assert torch.equal(outs[1]["resumed"][name][k], v), k
