"""The port's scale-out layer (parallel/{mesh,distributed,tp}.py, the
EA-VQ's group, the tensor-parallel HuBERT) on the CPU over gloo, against
the JAX package's single-device results on the global batch, as its own
tests hold its mesh (tests/test_multihost.py, tests/test_tp.py,
tests/test_quantize.py's psum case). Multi-rank cases run in worker
processes (tests/torch_dist_worker.py, which imports no JAX); JAX runs
here.

Tolerances: the VQ update atol 1e-4 (k, k_sum) and 1e-5 (k_elem), as
test_quantize.py's; the tensor-parallel forward rtol 2e-5, atol 1e-5 and
three I_ea steps' metrics rtol 2e-4, atol 1e-6 and parameters rtol 1e-4,
atol 2e-6, as test_tp.py's, the attention's k_proj biases (whose gradient
is zero up to rounding, tests/test_torch_train_ea.py) held to the most
three AdamW updates can move them.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_inpainting_tpu.models.hubert import EncoderWithHead as JaxModel
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxConfig
from speech_inpainting_tpu.quantize.vq import EMAVectorQuantizer as JaxVQ
from speech_inpainting_tpu.train import ea as jea
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (hubert_tree,
                                                      trainable_hubert)
from speech_inpainting_torch.models.hubert import HubertConfig
from speech_inpainting_torch.parallel import distributed as pdist
from speech_inpainting_torch.parallel import mesh as pmesh
from speech_inpainting_torch.parallel import tp as ptp
from speech_inpainting_torch.quantize.vq import EMAVectorQuantizer
from speech_inpainting_torch.train import ea as pea
from torch.distributed.tensor import Replicate, Shard
from torch_dist import ROOT, env, group_of_one, launch  # noqa: F401

HCFG = dict(conv_dim=(8,) * 7, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=48,
            num_conv_pos_embeddings=15, num_conv_pos_embedding_groups=1)
K_BINS, EMB, MU = 12, 6, 0.97          # tests/test_quantize.py's


# ------------------------------------------------------- one process

def test_mesh_shapes_in_one_process(group_of_one):
    """make_mesh and make_hybrid_mesh over a group of one, beside
    tests/test_multihost.py:113-166: a ("dcn", "ici") mesh of one host
    holding every rank, the batch split over every axis of a mesh without
    dp; every helper the identity."""
    mesh = pmesh.make_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("dp",) and tuple(mesh.shape) == (1,)
    assert pmesh.data_spec(mesh) == ("dp",)
    assert pmesh.data_sharding(mesh) == (Shard(0),)
    assert pmesh.replicated(mesh) == (Replicate(),)
    hybrid = pdist.make_hybrid_mesh(device_type="cpu")
    assert hybrid.mesh_dim_names == ("dcn", "ici")
    assert tuple(hybrid.shape) == (1, 1)
    assert pmesh.data_spec(hybrid) == ("dcn", "ici")
    two = pmesh.make_mesh((("dp", -1), ("tp", 1)), device_type="cpu")
    assert pmesh.data_sharding(two) == (Shard(0), Replicate())
    assert pdist.is_coordinator()
    batch = {"x": np.arange(8, dtype=np.float32)}
    for out in (pdist.shard_host_batch(hybrid, batch),
                pmesh.shard_batch(hybrid, batch),
                pmesh.replicate(hybrid, batch)):
        np.testing.assert_array_equal(out["x"].numpy(), batch["x"])


def test_mesh_needs_a_group():
    """A mesh is made over a group the caller joined: without one,
    make_mesh and make_hybrid_mesh raise (the CLIs' --mesh joins one)."""
    assert not torch.distributed.is_initialized()
    for make in (pmesh.make_mesh, pdist.make_hybrid_mesh):
        with pytest.raises(RuntimeError, match="needs a process group"):
            make(device_type="cpu")


def test_local_batches_single_process_passthrough():
    batches = [{"x": np.arange(8).reshape(8, 1)} for _ in range(3)]
    got = list(pdist.local_batches(iter(batches)))
    assert len(got) == 3
    assert got[0]["x"] is batches[0]["x"]


def test_initialize_single_process_noop(monkeypatch):
    """num_processes <= 1 and a bare call outside a launcher's environment
    are no-ops (the reference dist shim's works-on-one-device contract);
    explicit arguments that cannot form a group raise, as
    jax.distributed.initialize does."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize(num_processes=1, device="cpu") is False
    assert pdist.initialize(device="cpu") is False
    with pytest.raises(ValueError, match="coordinator_address"):
        pdist.initialize(process_id=0, num_processes=2, device="cpu")


def test_initialize_bare_degrades_in_lying_env():
    """A launcher-like variable (RANK) without the rest of a group's
    description: the bare call says so on stderr and runs single-process,
    in a subprocess (a joined group is process-global)."""
    e = env()
    e["RANK"] = "0"
    code = ("from speech_inpainting_torch.parallel.distributed import "
            "initialize\n"
            "from speech_inpainting_torch.parallel.mesh import world_size\n"
            "assert initialize(device='cpu') is False\n"
            "assert world_size() == 1\n"
            "print('degraded ok')\n")
    p = subprocess.run([sys.executable, "-c", code], env=e, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "degraded ok" in p.stdout
    assert "bare autodetect failed" in p.stderr


def test_tp_spec_rules():
    """tests/test_tp.py:43-60's rules on the port's names."""
    model = trainable_hubert(HubertConfig(**HCFG), testing.hubert_tree(
        HubertConfig(**HCFG), 16, np.random.default_rng(0)), 16,
        device="cpu")
    specs = ptp.tp_specs(model)
    att = "hubert.layers.0.attention"
    assert specs[f"{att}.q_proj.weight"] == {"tp": Shard(0)}
    assert specs[f"{att}.q_proj.bias"] == {"tp": Shard(0)}
    assert specs[f"{att}.out_proj.weight"] == {"tp": Shard(1)}
    assert specs[f"{att}.out_proj.bias"] == {}
    ff = "hubert.layers.0.feed_forward"
    assert specs[f"{ff}.intermediate_dense.weight"] == {"tp": Shard(0)}
    assert specs[f"{ff}.output_dense.weight"] == {"tp": Shard(1)}
    assert specs[f"{ff}.output_dense.bias"] == {}
    assert specs["head.linear.weight"] == {}
    assert specs["hubert.fp_projection.weight"] == {}
    assert ptp.tp_spec("attention.q_proj.weight", axis="model") == {
        "model": Shard(0)}
    sharded = sum(bool(s) for s in specs.values())
    assert sharded == 2 * 10       # q/k/v (6), out_proj, MLP (3); 2 layers


def test_tp_refuses_int8(group_of_one):
    import dataclasses
    mesh = pmesh.make_mesh((("dp", -1), ("tp", 1)), device_type="cpu")
    cfg = dataclasses.replace(HubertConfig(**HCFG), int8=True)
    with pytest.raises(ValueError, match="int8"):
        ptp.check_tp(cfg, mesh)


# ------------------------------------------------------------ 2 ranks

def test_mesh_shapes_on_two_ranks(tmp_path):
    """Two ranks: ("dp", -1) spans both; ("dp", -1), ("tp", 2) puts them
    on tp; a hybrid mesh over two hosts (GROUP_RANK) is (2, 1) with the
    batch split over both axes; local_batches gives each rank its rows."""
    outs = launch("mesh", 2, {"x": np.arange(8.0).reshape(4, 2)},
                  tmp_path)
    for r, o in enumerate(outs):
        assert o["dp"] == (("dp",), (2,))
        assert o["dptp"] == (("dp", "tp"), (1, 2))
        assert o["hybrid"] == (("dcn", "ici"), (2, 1))
        assert o["hybrid_index"] == (r, 2)
        np.testing.assert_array_equal(
            o["rows"], np.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2])
        assert o["coordinator"] == (r == 0)


def test_vq_all_reduce_matches_jax(tmp_path):
    """tests/test_quantize.py:176-200's inputs: the codebook update of two
    ranks, four rows each, over the group equals JAX's on all eight rows;
    a restart from an empty codebook gives both ranks rank 0's
    candidates."""
    rng = np.random.default_rng(1234)
    k = rng.standard_normal((K_BINS, EMB)).astype(np.float32)
    state = {"k": k.copy(), "k_sum": (k * 3.0).copy(),
             "k_elem": np.full((K_BINS,), 3.0, np.float32),
             "initted": np.ones((), bool)}
    x = rng.standard_normal((8, EMB, 16)).astype(np.float32) * 2.0
    _, upd = JaxVQ(K_BINS, EMB, MU).apply(
        {"vq": jax.tree.map(jnp.asarray, state)}, jnp.asarray(x),
        train=True, rngs={"vq": jax.random.PRNGKey(0)}, mutable=["vq"])
    q = EMAVectorQuantizer(K_BINS, EMB, MU)
    for name, v in state.items():
        getattr(q, name).copy_(torch.as_tensor(v))
    outs = launch("vq", 2, {"vq": q, "x": x}, tmp_path)
    for o in outs:
        b = o["buffers"]
        np.testing.assert_allclose(b["k_sum"].numpy(),
                                   np.asarray(upd["vq"]["k_sum"]), atol=1e-4)
        np.testing.assert_allclose(b["k_elem"].numpy(),
                                   np.asarray(upd["vq"]["k_elem"]),
                                   atol=1e-5)
        np.testing.assert_allclose(b["k"].numpy(),
                                   np.asarray(upd["vq"]["k"]), atol=1e-4)
    r0, r1 = outs[0]["restart"], outs[1]["restart"]
    for name in r0:
        np.testing.assert_array_equal(r0[name].numpy(), r1[name].numpy())
    assert (r0["k_elem"].numpy() < 1.0).any()     # codes restarted


# ------------------------------------------------------------ 4 ranks

def _tp_batch(rng):
    B, T = 4, 3200                     # tests/test_tp.py's: 10 frames
    return {"wav": (rng.standard_normal((B, T)) * 0.1).astype(np.float32),
            "attn_mask": np.ones((B, T), np.int32),
            "mask_pos": rng.integers(0, 6, B).astype(np.int32),
            "labels": rng.integers(0, 7, (B, 4)).astype(np.int32)}


def test_tp_forward_and_step_match_jax(tmp_path):
    """("dp", 2) × ("tp", 2) on four ranks: the sharded HuBERT's forward on
    each dp shard's rows, and three I_ea steps, against JAX's single
    device on the global batch (tests/test_tp.py's HCFG and gates)."""
    rng = np.random.default_rng(0)
    cfg = HubertConfig(**HCFG)
    tree = testing.hubert_tree(cfg, 16, rng)
    centroids = rng.standard_normal((7, 16)).astype(np.float32)
    batch = _tp_batch(rng)
    jmodel = JaxModel(JaxConfig(**HCFG), out_dim=16)
    params = jax.tree.map(jnp.asarray, tree)
    want_out = np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, batch["wav"], batch["attn_mask"]))
    jcfg = jea.EAConfig(mask_length=4)
    step = jax.jit(jea.make_train_step(jmodel, jcfg, centroids))
    js = jea.create_state(jcfg, params)
    jms = []
    for _ in range(3):
        js, m = step(js, batch)
        jms.append({k: float(v) for k, v in m.items()})

    outs = launch("tp", 4, {"hcfg": cfg, "out_dim": 16,
                            "model": trainable_hubert(
                                cfg, tree, 16, device="cpu").state_dict(),
                            "cfg": pea.EAConfig(mask_length=4),
                            "centroids": centroids, "batch": batch,
                            "steps": 3}, tmp_path)
    assert all(o["sharded"] for o in outs)
    # ranks (0, 1) hold dp shard 0, (2, 3) dp shard 1
    got = np.concatenate([outs[0]["out"].numpy(), outs[2]["out"].numpy()])
    np.testing.assert_allclose(got, want_out, rtol=2e-5, atol=1e-5)
    for o in outs:
        for i, (pm, jm) in enumerate(zip(o["metrics"], jms)):
            for k, v in jm.items():
                np.testing.assert_allclose(pm[k], v, rtol=2e-4, atol=1e-6,
                                           err_msg=f"step {i} {k}")
    model = trainable_hubert(cfg, None, 16, device="cpu")
    model.load_state_dict(outs[0]["params"])
    got_p = dict(jax.tree_util.tree_leaves_with_path(hubert_tree(model)))
    for path, a in jax.tree_util.tree_leaves_with_path(js.params):
        name = jax.tree_util.keystr(path)
        p0 = np.asarray(_leaf(tree, path))
        if "k_proj']['bias" in name:
            # zero gradient up to rounding: each side within 3 updates
            assert np.abs(got_p[path] - p0).max() <= 3 * 2.5 * 1e-4, name
            continue
        np.testing.assert_allclose(got_p[path], np.asarray(a), rtol=1e-4,
                                   atol=2e-6, err_msg=name)
    for o in outs[1:]:
        for k, v in o["params"].items():
            np.testing.assert_array_equal(v.numpy(),
                                          outs[0]["params"][k].numpy(), k)


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_mesh_inpainter_equals_one_device(tmp_path):
    """InformedInpainter(mesh=) on two ranks: batch() of B = 4 computes two
    rows a rank and gathers them, the one-utterance __call__ (B = 1) runs
    whole on each rank; both equal the one-device inpainter, and rank 1's
    codebook (drawn apart) is replaced by rank 0's."""
    from speech_inpainting_torch.infer.inpaint import (InformedInpainter,
                                                       InpainterConfig)
    from speech_inpainting_torch.models.hifigan import HiFiGANConfig
    rng = np.random.default_rng(3)
    hcfg = HubertConfig(**HCFG)
    gcfg = HiFiGANConfig(upsample_rates=(8, 8, 4),
                         upsample_kernel_sizes=(16, 16, 8),
                         upsample_initial_channel=32,
                         resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3, 5),))
    cfg = InpainterConfig(hubert=hcfg, hifigan=gcfg)
    inp = {"cfg": cfg, "hubert": testing.hubert_tree(hcfg, 80, rng),
           "generator": testing.generator_tree(gcfg, rng, carry=True),
           "centroids": rng.standard_normal((10, 80)).astype(np.float32)}
    B, sec = 4, 0.4
    inp["batch"] = {
        "wav22": (rng.standard_normal((B, int(22050 * sec))) * 0.1
                  ).astype(np.float32),
        "wav16": (rng.standard_normal((B, int(16000 * sec))) * 0.1
                  ).astype(np.float32),
        "mask_pos": np.full(B, 5, np.int64), "mask_len": np.full(B, 6,
                                                              np.int64)}
    one = InformedInpainter(cfg, inp["hubert"], inp["generator"],
                            inp["centroids"], device="cpu")
    b = inp["batch"]
    want = one.batch(b["wav22"], b["wav16"], b["mask_pos"], b["mask_len"])
    outs = launch("inpaint", 2, inp, tmp_path)
    for o in outs:
        for k, v in want.items():
            if k == "pred_labels":
                np.testing.assert_array_equal(o["batch"][k].numpy(),
                                              v.numpy())
            else:
                np.testing.assert_allclose(o["batch"][k].numpy(), v.numpy(),
                                           atol=1e-4, err_msg=k)
        np.testing.assert_allclose(o["one"]["inpainted"].numpy(),
                                   want["inpainted"][0].numpy(), atol=1e-4)
