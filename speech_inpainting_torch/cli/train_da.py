"""I_da decoder-adaptation training (the unit HiFi-GAN), on the card.

Counterpart of speech_inpainting_tpu/cli/train_da.py, with its flags and
its config keys: train the CodeGenerator against the units, f0 and speaker
embeddings of a JSON-lines manifest (`CodeDataset`), with the pitch
quantizer frozen.

  python -m speech_inpainting_torch.cli.train_da --config hubert_lut.json \\
      --train-manifest train.txt --valid-manifest val.txt \\
      --f0-quantizer ckpt_f0vq/ --checkpoint-path ckpt/

The generator starts from the JAX package's init distributions drawn from
`--seed` (models/codegen.py:WNCodeGenerator), the discriminators from seeds
1 and 2; its input width comes from one batch, as the JAX CLI's init takes
it from the batch it is shown (flax convs infer their input width; the
config's model_in_dim is not read). `--f0-quantizer` loads the frozen pitch
quantizer from a directory that `train_f0vq` wrote or from a reference
f0-VQ-VAE `g_*` file (convert/ida_torch.py:load_f0_quantizer). The loss
mel is the config's (fmax_for_loss). The real and fake batches run through
the discriminators as one forward (`batched_disc`), as the JAX CLI sets
it. Checkpoints `g_{step:08d}` ({"generator": the WNCodeGenerator's state
dict, its codebooks among the buffers}) and `do_{step:08d}` go to
`--checkpoint-path`; a rerun resumes from the newest. `--valid-manifest`
adds a validation sweep every `--validation-interval` steps over fixed
batches (epoch 0, seed + 1) through the folded generator, whose
ResBlock1s run in K2 on the card. Runs on the CUDA card; `--device cpu`
runs on the CPU.

Data parallel, with the JAX CLI's flags: `--mesh` trains over the ranks of
the process group this process joins (one rank per card; with no launcher
and no --coordinator a group of one, NCCL on the card), and
`--coordinator host:port --num-processes N --process-id i` (or torchrun's
environment) joins a group of N, which implies `--mesh`; each rank takes
its rows of every global batch of `--batch-size`, and rank 0 alone writes
checkpoints and logs. The group that a run joins is left when
it ends. On the CPU the ranks talk over gloo.

Refused: a config in the joint enc-VQ-dec regime (lambda_commit_code set): `CodeDataset`
yields integer units, an integer code dequantizes through the codebook
with no commit term, and the JAX CLI's step then computes
lambda_commit × None and raises as it traces its first step. The joint
regime trains through train/da.py:make_da_step on float inputs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from ..convert.from_jax import trainable_codegen
from ..convert.ida_torch import load_f0_quantizer
from ..data.code_dataset import CodeDataset, CodeDatasetConfig
from ..data.manifests import parse_manifest
from ..device import resolve_device
from ..models.codegen import CodeGeneratorConfig
from ..ops.mel import MelConfig
from ..parallel.distributed import (add_cli_args, data_parallel_mesh,
                                    initialize_from_args, leaves_no_group)
from ..train.da import DATrainConfig, da_gen_fwd, make_da_eval, make_da_step
from ..train.gan import GANConfig, create_gan_state, default_discriminators
from ..train.run import RunConfig, gan_valid_fn, run_gan_training


def input_width(cfg: CodeGeneratorConfig, batch: dict) -> int:
    """The generator's input channels for batches like `batch`: the unit
    stream's (the embedding, or in the joint regime the codebook's width),
    the pitch units' embedding where f0 is used, and the speaker's (the
    batch's d-vector, or the table's embedding)."""
    if cfg.content_vq:
        return cfg.code_vq_width + batch["emb"].shape[-1]
    width = cfg.embedding_dim * (2 if cfg.use_f0 else 1)
    if cfg.multispkr:
        width += (batch["emb"].shape[-1] if cfg.external_speaker_emb
                  else cfg.embedding_dim)
    return width


@leaves_no_group
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", required=True, help="reference-style json")
    p.add_argument("--train-manifest", required=True)
    p.add_argument("--valid-manifest", default=None,
                   help="held-out manifest for the periodic validation "
                        "mel-error sweep")
    p.add_argument("--checkpoint-path", required=True)
    p.add_argument("--f0-quantizer", default=None,
                   help="a train_f0vq checkpoint directory or a reference "
                        "f0-VQ-VAE g_* file")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--training-steps", type=int, default=None)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--skip-nonfinite", type=int, default=0, metavar="N",
                   help="never apply nan/inf-grad updates; abort (after "
                        "checkpointing) past N consecutive skips")
    p.add_argument("--bf16-disc", action="store_true",
                   help="discriminators compute in bf16 (parameters and "
                        "losses f32)")
    p.add_argument("--validation-interval", type=int, default=1000,
                   help="steps between validation sweeps")
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
    device = resolve_device(args.device)

    h = json.loads(Path(args.config).read_text())
    ccfg = CodeGeneratorConfig.from_dict(h)
    if ccfg.content_vq:
        p.error("the joint enc-VQ-dec regime (lambda_commit_code) over "
                "CodeDataset's integer units is refused: an integer code "
                "dequantizes with no commit term, and the JAX CLI's step "
                "then computes lambda_commit * None (it raises tracing "
                "its first step); train the joint regime on float inputs "
                "through train/da.py:make_da_step")
    mel_loss = MelConfig(sampling_rate=h.get("sampling_rate", 16000),
                         n_fft=h.get("n_fft", 1024),
                         num_mels=h.get("num_mels", 80),
                         hop_size=h.get("hop_size", 256),
                         win_size=h.get("win_size", 1024),
                         fmin=h.get("fmin", 0),
                         fmax=h.get("fmax_for_loss"))
    cfg = DATrainConfig(
        codegen=ccfg,
        gan=GANConfig(learning_rate=h.get("learning_rate", 2e-4),
                      adam_b1=h.get("adam_b1", 0.8),
                      adam_b2=h.get("adam_b2", 0.99),
                      lr_decay=h.get("lr_decay", 0.999),
                      lambda_commit=h.get("lambda_commit_code", 0) or 0,
                      frozen_g_paths=("fo_vqvae",),
                      batched_disc=True, disc_bf16=args.bf16_disc,
                      skip_nonfinite=args.skip_nonfinite),
        mel_loss=mel_loss, segment_size=h.get("segment_size", 8960),
        code_hop_size=h.get("code_hop_size", 320))

    def dataset(manifest):
        files, codes = parse_manifest(manifest)
        return CodeDataset(files, codes, CodeDatasetConfig(
            segment_size=cfg.segment_size, code_hop_size=cfg.code_hop_size,
            mel=mel_loss, multispkr=h.get("multispkr", "_")),
            cache_dir=args.cache_dir, device=device)

    ds = dataset(args.train_manifest)
    width = input_width(ccfg, next(ds.batches(1, epoch=0)))
    ccfg = dataclasses.replace(ccfg, hifigan=dataclasses.replace(
        ccfg.hifigan, in_dim=width))
    cfg = dataclasses.replace(cfg, codegen=ccfg)
    generator = trainable_codegen(ccfg, seed=args.seed, device=device)
    if args.f0_quantizer:
        load_f0_quantizer(args.f0_quantizer, generator)
        print(f"loaded frozen f0 quantizer from {args.f0_quantizer}")
    state = create_gan_state(cfg.gan, generator,
                             *default_discriminators(cfg.gan, device))
    run = RunConfig(epochs=args.epochs, checkpoint_dir=args.checkpoint_path,
                    log_dir=args.log_dir, training_steps=args.training_steps,
                    mesh=data_parallel_mesh(args.mesh, device),
                    abort_nonfinite=args.skip_nonfinite,
                    validation_interval=args.validation_interval)
    batch_size = h.get("batch_size", 16)
    valid_fn = None
    if args.valid_manifest:
        vds = dataset(args.valid_manifest)
        # a fixed epoch and seed: the same clips at every sweep
        val_batches = list(vds.batches(min(batch_size, len(vds)), epoch=0,
                                       seed=args.seed + 1))
        valid_fn = gan_valid_fn(make_da_eval(cfg), val_batches,
                                media_fwd=da_gen_fwd(cfg),
                                media_mel=cfg.mel_loss,
                                sample_rate=mel_loss.sampling_rate)
    return run_gan_training(
        make_da_step(cfg), state,
        lambda epoch: ds.batches(batch_size, epoch=epoch, seed=args.seed),
        run, valid_fn=valid_fn)


if __name__ == "__main__":
    main()
