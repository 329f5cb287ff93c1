"""f0-VQ-VAE (pitch quantizer) training CLI, on the card.

Counterpart of speech_inpainting_tpu/cli/train_f0vq.py, with its flags and
its config keys (configs/f0_vqvae.json): train the jukebox-VQ pitch
quantizer on f0 streams tracked on the device.

  python -m speech_inpainting_torch.cli.train_f0vq --config f0_vqvae.json \\
      --train-manifest train.txt --checkpoint-path ckpt_f0vq/

The model starts from the JAX package's init distributions, drawn from
`--seed`, with an uninitialised codebook (the first batch fills it). The
codebook's restart candidates come from a CPU generator seeded `--seed` +
2. Checkpoints `g_{step:08d}` ({"params", "vq", "opt", "steps"}) are
written every 5000 steps and at the end; a rerun resumes from the newest,
as the JAX CLI does: the step count is restored, while the epoch loop and
the candidates' generator start again from the beginning. `train_da
--f0-quantizer DIR` and `convert/ida_torch.py:load_f0_quantizer` read the
directory. Runs on the CUDA card; `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..convert.from_jax import trainable_fo_vqvae
from ..data.code_dataset import F0DatasetTPU
from ..data.manifests import parse_manifest
from ..data.pipeline import device_prefetch
from ..device import resolve_device
from ..models.codegen import FoVQVAEConfig
from ..train.f0vq import F0VQConfig, create_f0vq_state, make_f0vq_step
from ..utils.checkpoints import Checkpointer
from ..utils.logging import TrainLogger


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--train-manifest", required=True)
    p.add_argument("--checkpoint-path", required=True)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    h = json.loads(Path(args.config).read_text())
    mcfg = FoVQVAEConfig.from_dict(h)
    cfg = F0VQConfig(model=mcfg,
                     learning_rate=h.get("learning_rate", 2e-4),
                     adam_b1=h.get("adam_b1", 0.8),
                     adam_b2=h.get("adam_b2", 0.99),
                     lr_decay=h.get("lr_decay", 0.999),
                     lambda_commit=h.get("lambda_commit", 0.02))

    files, _ = parse_manifest(args.train_manifest)
    ds = F0DatasetTPU(files, segment_size=h.get("segment_size", 16640),
                      cache_dir=args.cache_dir, device=device)

    model = trainable_fo_vqvae(mcfg, seed=args.seed, device=device)
    state = create_f0vq_state(cfg, model)
    step = make_f0vq_step(cfg, device=device)

    ckpt = Checkpointer(args.checkpoint_path)
    restored = ckpt.restore("g_")
    if restored is not None:
        state.load_state_dict(restored)
        print(f"resumed from step {state.step}")

    logger = TrainLogger(args.log_dir)
    gen = torch.Generator().manual_seed(args.seed + 2)
    batch_size = h.get("batch_size", 16)
    for epoch in range(args.epochs):
        for batch in device_prefetch(ds.batches(batch_size, epoch=epoch,
                                                seed=args.seed),
                                     device=device):
            state, metrics = step(state, batch, gen)
            logger.step(state.step, metrics)
            if state.step % 5000 == 0:
                ckpt.save("g_", state.step, state.state_dict())
    ckpt.save("g_", state.step, state.state_dict(), wait=True)
    logger.close()
    return state


if __name__ == "__main__":
    main()
