"""The f0-VQ-VAE (pitch quantizer) trainer: MSE reconstruction plus
λ·commitment, one step per batch.

Counterpart of speech_inpainting_tpu/train/f0vq.py:
  - the FoVQVAE's training forward (jukebox encoder → EMA-VQ → jukebox
    decoder), whose codebook update and dead-code restarts run inside it
    from candidates drawn from the step's CPU `torch.Generator`;
  - loss = mean((out − f0)²) + lambda_commit·Σ commits;
  - AdamW (b1 0.8, b2 0.99, eps 1e-8, weight decay 0.01 on every
    parameter) at exponential_decay(lr, steps_per_epoch, lr_decay,
    staircase), read at the count before the update;
  - the metrics dict of the JAX step: loss, recon, commit and level 0's
    entropy, usage, used_curr and fit, as 0-dim tensors on the device.
There is no guard and no clip, as there is none in the JAX step. The step
runs in full float32 (`device.full_f32`). On a mesh (`state.mesh`) each
rank holds its rows: the mesh's data group is the model's `group` (JAX's
`axis_name`: the codebook's sums run over every rank's rows, its
candidates come from the first rank's), and the gradients and metrics are
averaged over the ranks (the losses are means over equal row counts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import full_f32, resolve_device
from ..models.codegen import FoVQVAE, FoVQVAEConfig
from ..parallel.distributed import (all_reduce_grads, data_group,
                                    reduce_metrics)
from .optim import AdamW, exponential_decay


@dataclasses.dataclass(frozen=True)
class F0VQConfig:
    model: FoVQVAEConfig = FoVQVAEConfig()
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    weight_decay: float = 0.01
    lr_decay: float = 0.999
    steps_per_epoch: int = 1000
    lambda_commit: float = 0.02


@dataclasses.dataclass
class F0VQTrainState:
    """The JAX package's F0VQTrainState: the step count, the model (its
    parameters and, as buffers, the `vq` collection) and the optimizer;
    and the mesh the step runs on (None: one device)."""
    step: int
    model: FoVQVAE
    optimizer: AdamW
    mesh: Optional[object] = None

    def state_dict(self) -> dict:
        """{"params", "vq", "opt", "steps"}: the tree the CLI's g_ holds."""
        sd = self.model.state_dict()
        vq = {k: v for k, v in sd.items() if k.startswith("vq.")}
        params = {k: v for k, v in sd.items() if k not in vq}
        return {"params": params, "vq": vq,
                "opt": self.optimizer.state_dict(), "steps": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict({**sd["params"], **sd["vq"]})
        self.optimizer.load_state_dict(sd["opt"])
        self.step = int(sd["steps"])


def make_optimizer(cfg: F0VQConfig, model: FoVQVAE) -> AdamW:
    return AdamW(model.parameters(), lr=cfg.learning_rate,
                 betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8,
                 weight_decay=cfg.weight_decay,
                 schedule=exponential_decay(cfg.learning_rate,
                                            cfg.steps_per_epoch,
                                            cfg.lr_decay))


def create_f0vq_state(cfg: F0VQConfig, model: FoVQVAE) -> F0VQTrainState:
    """A step-0 state over a trainable `model` (convert/from_jax.py:
    trainable_fo_vqvae)."""
    return F0VQTrainState(step=0, model=model,
                          optimizer=make_optimizer(cfg, model))


def make_f0vq_step(cfg: F0VQConfig, device=None):
    """step(state, batch {"f0": (B, 1, T)}, generator) → (state, metrics);
    `generator`, a CPU torch.Generator, draws the codebook's restart
    candidates."""
    device = resolve_device(device)

    def step(state: F0VQTrainState, batch, generator: torch.Generator):
        model = state.model
        f0 = torch.as_tensor(batch["f0"]).to(device, non_blocking=True)
        group = None if state.mesh is None else data_group(state.mesh)
        with full_f32():
            out, commits, metrics = model(f0, train=True,
                                          generator=generator, group=group)
            recon = torch.mean((out - f0) ** 2)
            commit = sum(commits)
            loss = recon + cfg.lambda_commit * commit
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if group is not None:
                all_reduce_grads(model.parameters(), group, average=True)
            state.optimizer.step()
        m = {"loss": loss.detach(), "recon": recon.detach(),
             "commit": commit.detach()}
        for k in ("entropy", "usage", "used_curr", "fit"):
            if metrics and k in metrics[0]:
                m[k] = metrics[0][k]
        if group is not None:
            m = reduce_metrics(m, group)
        state.step += 1
        return state, m

    return step


def make_f0vq_eval(cfg: F0VQConfig, device=None):
    """eval(model, f0 (B, 1, T)) → {"recon", "commit"} as floats, the
    codebook left as it is."""
    device = resolve_device(device)

    @torch.no_grad()
    def evaluate(model: FoVQVAE, f0) -> dict:
        f0 = torch.as_tensor(f0).to(device)
        with full_f32():
            out, commits, _ = model(f0, train=False)
        return {"recon": float(torch.mean((out - f0) ** 2)),
                "commit": float(sum(commits))}

    return evaluate
