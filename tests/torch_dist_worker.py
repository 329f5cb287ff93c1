"""One rank of a multi-process run of the port, over gloo on the CPU: the
tests start `world` of these (tests/torch_dist.py:launch) and hold what
they return against the JAX package's single-device result on the global
batch. Imports torch and the port, never JAX.

    python tests/torch_dist_worker.py CASE RANK WORLD PORT DIR

reads DIR/in.pt (torch.save of a dict: how to build the port's train
state and its start `state_dict`, configs, the global batches, ...) and
writes DIR/out{RANK}.pt. Weight-normed modules do not pickle, so states
travel as state dicts: `build_state` makes the same state on both sides.
Each case cuts the global batch to this rank's rows itself
(parallel/distributed.py:local_batches), as the runners do.
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import speech_inpainting_torch.quantize.vq as pvq  # noqa: E402
from speech_inpainting_torch.parallel import distributed as pdist  # noqa: E402,E501
from speech_inpainting_torch.parallel.mesh import make_mesh  # noqa: E402


def build_state(kind: str, kw: dict):
    """A fresh train state of `kind` on the CPU, for load_state_dict:
    "ea" (hcfg, out_dim, cfg), "gan" (gcfg, gan, periods, scales),
    "da_joint" (cfg, periods, scales, seed), "f0vq" (cfg)."""
    from speech_inpainting_torch.convert import from_jax as fj
    if kind == "ea":
        from speech_inpainting_torch.train.ea import create_state
        return create_state(kw["cfg"], fj.trainable_hubert(
            kw["hcfg"], None, kw["out_dim"], device="cpu"))
    if kind == "f0vq":
        from speech_inpainting_torch.train.f0vq import create_f0vq_state
        return create_f0vq_state(kw["cfg"], fj.trainable_fo_vqvae(
            kw["cfg"].model, device="cpu"))
    discs = (fj.mpd_from_jax(None, kw["periods"], device="cpu"),
             fj.msd_from_jax(None, None, kw["scales"], device="cpu"))
    if kind == "gan":
        from speech_inpainting_torch.train.gan import create_gan_state
        return create_gan_state(kw["gan"], fj.trainable_generator(
            kw["gcfg"], device="cpu"), *discs)
    from speech_inpainting_torch.train.da import create_da_state
    return create_da_state(kw["cfg"], fj.trainable_codegen(
        kw["cfg"].codegen, device="cpu"), *discs, seed=kw["seed"])


def _start(inp):
    state = build_state(*inp["build"])
    state.load_state_dict(inp["start"])
    return state


def _local(batch, mesh):
    return next(pdist.local_batches(iter([batch]), mesh))


def _floats(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def _steps(state, step, batches, mesh, *args):
    metrics = []
    for b in batches:
        state, m = step(state, _local(b, mesh), *args)
        metrics.append(_floats(m))
    state.mesh = None
    return state.state_dict(), metrics


def case_ea(inp, rank):
    """The I_ea step (optionally a NaN in rank 1's rows: `nan`)."""
    from speech_inpainting_torch.train.ea import make_train_step
    mesh = make_mesh(device_type="cpu")
    state = _start(inp)
    state.mesh = mesh
    step = make_train_step(inp["cfg"], inp["centroids"], "cpu")
    state, metrics = _steps(state, step, inp["batches"], mesh)
    return {"state": state, "metrics": metrics}


def case_gan(inp, rank):
    """One HiFi-GAN (V1 recipe) step: make_vanilla_step."""
    from speech_inpainting_torch.train import hifigan as phg
    mesh = make_mesh(device_type="cpu")
    state = _start(inp)
    state.mesh = mesh
    state, metrics = _steps(state, phg.make_vanilla_step(inp["cfg"]),
                            inp["batches"], mesh)
    return {"state": state, "metrics": metrics}


def case_da_joint(inp, rank):
    """The joint DA step, each step's candidates JAX's (the same on every
    rank: the gathered rows' draw); the labels of this rank's rows."""
    from speech_inpainting_torch.train import da as pda
    mesh = make_mesh(device_type="cpu")
    state = _start(inp)
    state.mesh = mesh
    step = pda.make_da_step(inp["cfg"])
    labels, metrics = [], []
    hook = state.generator.code_vq.level_0.register_forward_hook(
        lambda m, a, out: labels.append(out[0].reshape(-1).numpy().copy()))
    for b, cand in zip(inp["batches"], inp["cands"]):
        pvq._tile_candidates = lambda gen, x, k, c=cand: torch.as_tensor(
            c).to(x.device, x.dtype)
        state, m = step(state, _local(b, mesh))
        metrics.append(_floats(m))
    hook.remove()
    return {"state": state.state_dict(), "metrics": metrics,
            "labels": labels}


def case_f0vq(inp, rank):
    """The f0-VQ step: rank 0 replays JAX's candidates, the other ranks
    draw their own from generators seeded apart, which the broadcast from
    rank 0 must override."""
    from speech_inpainting_torch.train.f0vq import make_f0vq_step
    mesh = make_mesh(device_type="cpu")
    state = _start(inp)
    state.mesh = mesh
    step = make_f0vq_step(inp["cfg"], "cpu")
    gen = torch.Generator().manual_seed(100 + rank)
    metrics = []
    orig = pvq._tile_candidates
    for b, cand in zip(inp["batches"], inp["cands"]):
        if rank == 0:
            pvq._tile_candidates = lambda g, x, k, c=cand: torch.as_tensor(
                c).to(x.device, x.dtype)
        else:
            pvq._tile_candidates = orig
        state, m = step(state, _local(b, mesh), gen)
        metrics.append(_floats(m))
    return {"state": state.state_dict(), "metrics": metrics}


def case_vq(inp, rank):
    """The EMA-VQ update over the group: JAX's shard_map case (no
    restart) and, from an empty codebook, a restart case whose candidates
    each rank draws from its own generator (rank 0's must win)."""
    from speech_inpainting_torch.parallel.distributed import data_group
    mesh = make_mesh(device_type="cpu")
    group = data_group(mesh)
    q = inp["vq"]
    x = _local({"x": inp["x"]}, mesh)["x"]
    q(torch.as_tensor(x), train=True, group=group,
      generator=torch.Generator().manual_seed(rank))
    fresh = pvq.EMAVectorQuantizer(q.k_bins, q.emb_width, q.mu)
    fresh(torch.as_tensor(x[:, :, :2]), train=True, group=group,
          generator=torch.Generator().manual_seed(50 + rank))
    return {"buffers": {k: v.clone() for k, v in q.named_buffers()},
            "restart": {k: v.clone() for k, v in fresh.named_buffers()}}


def case_mesh(inp, rank):
    """Mesh shapes and each rank's place on them; two hosts simulated by
    torchrun's GROUP_RANK for the hybrid mesh."""
    import os
    from speech_inpainting_torch.parallel.mesh import data_index
    dp = make_mesh(device_type="cpu")
    dptp = make_mesh((("dp", -1), ("tp", 2)), device_type="cpu")
    os.environ["GROUP_RANK"] = str(rank)
    hybrid = pdist.make_hybrid_mesh(device_type="cpu")
    shape = lambda m: (tuple(m.mesh_dim_names), tuple(m.shape))  # noqa
    return {"dp": shape(dp), "dptp": shape(dptp), "hybrid": shape(hybrid),
            "hybrid_index": data_index(hybrid),
            "rows": _local({"x": inp["x"]}, dp)["x"],
            "coordinator": pdist.is_coordinator()}


def _full(model) -> dict:
    """The model's state dict with every DTensor gathered whole."""
    return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach().clone() for k, v in model.state_dict().items()}


def case_tp(inp, rank):
    """("dp", 2) × ("tp", 2): the sharded HuBERT's forward on this rank's
    dp rows, then `steps` I_ea steps of the sharded model."""
    from speech_inpainting_torch.parallel.tp import check_tp, shard_params
    from speech_inpainting_torch.train.ea import create_state, make_train_step
    from speech_inpainting_torch.convert.from_jax import trainable_hubert
    mesh = make_mesh((("dp", 2), ("tp", 2)), device_type="cpu")
    model = trainable_hubert(inp["hcfg"], None, inp["out_dim"], device="cpu")
    model.load_state_dict(inp["model"])
    check_tp(model.cfg, mesh)
    shard_params(mesh, model)
    q = model.hubert.layers[0].attention.q_proj.weight
    sharded = hasattr(q, "to_local") and tuple(q.to_local().shape) == (
        q.shape[0] // 2, q.shape[1])
    b = _local(inp["batch"], mesh)
    with torch.no_grad():
        out = model(torch.as_tensor(b["wav"]), torch.as_tensor(
            b["attn_mask"])).clone()
    state = create_state(inp["cfg"], model)
    state.mesh = mesh
    step = make_train_step(inp["cfg"], inp["centroids"], "cpu")
    metrics = []
    for _ in range(inp["steps"]):
        state, m = step(state, b)
        metrics.append(_floats(m))
    return {"out": out, "sharded": sharded, "metrics": metrics,
            "params": _full(model)}


def case_run_ea(inp, rank):
    """run_ea_training on a mesh, each rank with a checkpoint directory of
    its own (a filesystem that is not shared), twice: the second run
    resumes on rank 0 only, and the sync must make rank 1 equal."""
    from speech_inpainting_torch.train.ea import make_train_step
    from speech_inpainting_torch.train.run import RunConfig, run_ea_training
    mesh = make_mesh(device_type="cpu")
    ckpt = Path(inp["dir"]) / f"ckpt{rank}"
    step = make_train_step(inp["cfg"], inp["centroids"], "cpu")
    out = {}
    for phase, sd in (("first", inp["start"]), ("resumed", inp["fresh"])):
        state = build_state(*inp["build"])
        state.load_state_dict(sd)
        run = RunConfig(epochs=1, checkpoint_dir=str(ckpt),
                        validation_interval=1000, stdout_interval=1,
                        mesh=mesh)
        state = run_ea_training(step, lambda m, b: {"cos_sim_acc": 0.0},
                                state, lambda e: iter(inp["batches"]),
                                lambda e: iter(()), run)
        out[phase] = {"step": state.step,
                      "model": {k: v.clone() for k, v in
                                state.model.state_dict().items()}}
        out[f"files_{phase}"] = sorted(p.name for p in ckpt.glob("*")) \
            if ckpt.exists() else []
    return out


def case_run_gan(inp, rank):
    """run_gan_training on a mesh, as case_run_ea."""
    from speech_inpainting_torch.train import hifigan as phg
    from speech_inpainting_torch.train.run import RunConfig, run_gan_training
    mesh = make_mesh(device_type="cpu")
    ckpt = Path(inp["dir"]) / f"ckpt{rank}"
    step = phg.make_vanilla_step(inp["cfg"])
    out = {}
    for phase, sd in (("first", inp["start"]), ("resumed", inp["fresh"])):
        state = build_state(*inp["build"])
        state.load_state_dict(sd)
        run = RunConfig(epochs=1, checkpoint_dir=str(ckpt),
                        checkpoint_interval=1000, validation_interval=1000,
                        stdout_interval=1, mesh=mesh)
        state = run_gan_training(step, state, lambda e: iter(inp["batches"]),
                                 run)
        out[phase] = {"step": state.step,
                      "generator": {k: v.clone() for k, v in
                                    state.generator.state_dict().items()},
                      "mpd": {k: v.clone() for k, v in
                              state.mpd.state_dict().items()}}
        out[f"files_{phase}"] = sorted(p.name for p in ckpt.glob("*")) \
            if ckpt.exists() else []
    return out


def case_inpaint(inp, rank):
    """InformedInpainter(mesh=) on a dp mesh: batch() and the B = 1
    __call__ (computed whole on every rank)."""
    from speech_inpainting_torch.infer.inpaint import InformedInpainter
    mesh = make_mesh(device_type="cpu")
    # a rank other than 0 starts from another codebook: the inpainter
    # must replace it by rank 0's
    inp_ = InformedInpainter(inp["cfg"], inp["hubert"], inp["generator"],
                             inp["centroids"] + 0.5 * rank, device="cpu",
                             mesh=mesh)
    b = inp["batch"]
    out = inp_.batch(b["wav22"], b["wav16"], b["mask_pos"], b["mask_len"])
    one = inp_(b["wav22"][0], b["wav16"][0], int(b["mask_pos"][0]),
               int(b["mask_len"][0]))
    return {"batch": {k: v.clone() for k, v in out.items()},
            "one": {k: v.clone() for k, v in one.items()}}


def _cut_discs(cfg, device=None, seeds=(1, 2)):
    """The training CLIs' discriminators cut to MPD period 2 and one MSD
    scale (full width), drawn from default_discriminators' seeds."""
    from speech_inpainting_torch.convert.from_jax import (mpd_from_jax,
                                                          msd_from_jax)
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    return (mpd_from_jax(None, (2,), device=device, generator=gens[0]),
            msd_from_jax(None, None, 1, device=device, generator=gens[1]))


def case_cli(inp, rank, world, port):
    """A training CLI's main() as one of `world` processes, joined by its
    own --coordinator/--num-processes/--process-id flags; `hub` stands a
    tiny HuBERT in for HubertConfig.base, `cut_discs` cuts the
    discriminators. Returns the trained module's state dict."""
    import dataclasses
    import importlib
    mod = importlib.import_module(
        f"speech_inpainting_torch.cli.{inp['cli']}")
    if inp.get("hub"):
        from speech_inpainting_torch.models.hubert import HubertConfig

        class Tiny:
            base = staticmethod(lambda **o: dataclasses.replace(
                HubertConfig.base(**inp["hub"]), **o))
        mod.HubertConfig = Tiny
    if inp.get("cut_discs"):
        mod.default_discriminators = _cut_discs
    state = mod.main(inp["argv"] + [
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
        "--process-id", str(rank)])
    module = state.model if hasattr(state, "model") else state.generator
    return {"step": state.step,
            "params": {k: v.detach().clone()
                       for k, v in module.state_dict().items()}}


def main():
    case, rank, world, port, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    inp = torch.load(Path(d) / "in.pt", weights_only=False)
    np.random.seed(rank)
    if case == "cli":
        out = case_cli(inp, rank, world, port)
    else:
        assert pdist.initialize(f"127.0.0.1:{port}", world, rank,
                                device="cpu")
        out = globals()[f"case_{case}"](inp, rank)
    torch.save(out, Path(d) / f"out{rank}.pt")
    if torch.distributed.is_initialized():      # a CLI leaves its own
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
