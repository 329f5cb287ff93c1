"""I_ea encoder-adaptation training, on the card.

Counterpart of speech_inpainting_tpu/cli/train_ea.py, with its flags and
defaults: fine-tune the HuBERT encoder and head to predict the k-means mel
codewords of masked regions.

  python -m speech_inpainting_torch.cli.train_ea --wavs DIR --split F \\
      --labels-dir DIR --kmeans model.npy --checkpoint-path ckpt/ \\
      [--hubert-type base --pretrained hubert-base-ls960/]

`--pretrained` takes a local HF checkpoint directory (config.json and
pytorch_model.bin); hub names are not resolved. Without it the model starts
from flax's initialisers, drawn from `--seed`. Checkpoints go to
`--checkpoint-path` as the JAX trainer names them: `ea_{step:08d}` (model,
optimizer, guard and step; a rerun resumes from the newest), `best_00000000`
and `last_00000000` (`{"model": state_dict}`, which `predict_ea
--hubert-checkpoint` reads). Runs on the CUDA card; `--device cpu` runs on
the CPU.

Data parallel, with the JAX CLI's flags: `--mesh` trains over the ranks of
the process group this process joins (one rank per card; with no launcher
and no --coordinator a group of one, NCCL on the card), and
`--coordinator host:port --num-processes N --process-id i` (or torchrun's
environment) joins a group of N, which implies `--mesh`; each rank takes
its rows of every global batch of `--batch-size`, and rank 0 alone writes
checkpoints and logs. The group that a run joins is left when
it ends. On the CPU the ranks talk over gloo.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..convert.from_jax import hubert_tree, trainable_hubert
from ..convert.hubert_torch import load_hf_tree
from ..data.ea_dataset import EADataset, plan_buckets
from ..data.manifests import read_split_list
from ..device import resolve_device
from ..models.hubert import HubertConfig
from ..parallel.distributed import (add_cli_args, data_parallel_mesh,
                                    initialize_from_args, leaves_no_group)
from ..quantize.kmeans import KMeans
from ..train.ea import EAConfig, create_state, eval_step, make_train_step
from ..train.run import RunConfig, run_ea_training


def build_dataset(wavs, split, labels_dir, max_length, mask_length,
                  cache_dir):
    names = [l.split("|")[0] for l in read_split_list(split)]
    paths = [Path(wavs) / f"{n}.wav" for n in names]
    labels = [np.load(Path(labels_dir) / f"{n}_labels.npy") for n in names]
    return EADataset(paths, labels, max_length=max_length,
                     mask_length=mask_length, cache_dir=cache_dir)


def build_model(hcfg: HubertConfig, out_dim: int, seed: int, pretrained,
                prenet_only: bool, device):
    """The trainable model: flax's init drawn from `seed`, then, with
    `pretrained`, the HF directory's encoder, or with `prenet_only` all of
    it but the transformer (`layers_*`, `pos_conv_embed`,
    `encoder_layer_norm`), which keeps its fresh init."""
    gen = torch.Generator().manual_seed(seed)
    model = trainable_hubert(hcfg, None, out_dim, device="cpu",
                             generator=gen)
    if pretrained:
        _, hub = load_hf_tree(pretrained)
        tree = hubert_tree(model)
        if prenet_only:
            hub = {**tree["hubert"], **{
                k: v for k, v in hub.items()
                if not (k.startswith("layers_") or
                        k in ("pos_conv_embed", "encoder_layer_norm"))}}
        model = trainable_hubert(hcfg, {**tree, "hubert": hub}, out_dim,
                                 device="cpu")
    return model.to(device)


@leaves_no_group
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--wavs", required=True)
    p.add_argument("--split", required=True)
    p.add_argument("--valid-split", default=None)
    p.add_argument("--labels-dir", required=True)
    p.add_argument("--kmeans", required=True)
    p.add_argument("--checkpoint-path", required=True)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--hubert-type", default="large",
                   choices=["base", "large"])
    p.add_argument("--pretrained", default=None,
                   help="local HF checkpoint directory to initialise from")
    p.add_argument("--prenet-only", action="store_true",
                   help="load only the conv prenet from --pretrained "
                        "(random transformer; reference load_pretrained="
                        "false)")
    p.add_argument("--loss", default="cos_sim",
                   choices=["cos_sim", "mse", "softmax"])
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--mask-length", type=int, default=20)
    p.add_argument("--max-wav-seconds", type=float, default=5.0)
    p.add_argument("--base-lr", type=float, default=1e-4)
    p.add_argument("--fc-lr", type=float, default=1e-4)
    p.add_argument("--freeze-encoder", action="store_true")
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--buckets", type=int, default=0, metavar="K",
                   help="length-bucketed batching: pad each utterance to "
                        "the smallest of K quantile length buckets instead "
                        "of max length")
    p.add_argument("--grad-accum", type=int, default=1, metavar="K",
                   help="split each batch into K sequential microbatches "
                        "and sum their grads before the optimizer update; "
                        "batch size must divide by K")
    p.add_argument("--skip-nonfinite", type=int, default=0, metavar="N",
                   help="never apply nan/inf-grad updates; abort (after "
                        "checkpointing) past N consecutive skips")
    p.add_argument("--bf16", dest="bf16", action="store_true", default=True,
                   help="bf16 matmul/conv compute, f32 params/reductions "
                        "(the default)")
    p.add_argument("--f32", dest="bf16", action="store_false",
                   help="full-f32 compute (the reference's precision)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the CUDA card)")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel over the ranks of the process group, "
                        "one per card (without a launcher or "
                        "--coordinator: a group of one)")
    add_cli_args(p)
    args = p.parse_args(argv)
    # multi-host: join the process group before anything reaches the card
    if initialize_from_args(args):
        args.mesh = True
    if args.batch_size % args.grad_accum:
        p.error("--batch-size must be divisible by --grad-accum")
    device = resolve_device(args.device)

    centroids = np.asarray(KMeans.load_auto(args.kmeans).centroids)
    out_dim = 100 if args.loss == "softmax" else centroids.shape[-1]
    cfg = EAConfig(base_lr=args.base_lr, fc_lr=args.fc_lr, loss=args.loss,
                   train_encoder=not args.freeze_encoder,
                   mask_length=args.mask_length,
                   grad_accum=args.grad_accum,
                   skip_nonfinite=args.skip_nonfinite)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    hcfg = (HubertConfig.large(dtype=dtype) if args.hubert_type == "large"
            else HubertConfig.base(dtype=dtype))
    max_length = int(args.max_wav_seconds * 16000) + 3   # ref 161539 ≈ 5 s
    model = build_model(hcfg, out_dim, args.seed, args.pretrained,
                        args.prenet_only, device)
    state = create_state(cfg, model)
    step = make_train_step(cfg, centroids, device)
    ev = eval_step(cfg, centroids, device)

    train_ds = build_dataset(args.wavs, args.split, args.labels_dir,
                             max_length, args.mask_length, args.cache_dir)
    valid_ds = (build_dataset(args.wavs, args.valid_split, args.labels_dir,
                              max_length, args.mask_length, args.cache_dir)
                if args.valid_split else None)
    run = RunConfig(epochs=args.epochs, checkpoint_dir=args.checkpoint_path,
                    log_dir=args.log_dir, mesh=data_parallel_mesh(args.mesh,
                                                                  device),
                    abort_nonfinite=args.skip_nonfinite)
    buckets = (plan_buckets(np.asarray(train_ds.lengths), args.buckets,
                            max_length=max_length) if args.buckets else None)
    return run_ea_training(
        step, ev, state,
        lambda epoch: train_ds.batches(args.batch_size, epoch=epoch,
                                       seed=args.seed, buckets=buckets),
        (lambda epoch: valid_ds.batches(2, epoch=0, shuffle=False))
        if valid_ds else (lambda epoch: iter(())),
        run)


if __name__ == "__main__":
    main()
