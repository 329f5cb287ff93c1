"""I_ea encoder-adaptation training: one train step, as the JAX package
takes it.

Counterpart of speech_inpainting_tpu/train/ea.py. The model
(`convert.from_jax.trainable_hubert`: float32 parameters, weight norm's
(g, v) apart, compute in cfg.dtype) is fine-tuned to predict the k-means
mel codewords of masked frames:
  - each row's 16 kHz wave is masked on the device ([pos·320 + 80,
    (pos + len)·320 − 1), `ops/masking.py`), HuBERT runs with the
    attention mask, and the mask_length frames from mask_pos are gathered
    with the start clamped to [0, T − L] (a negative one counted from the
    end first), as `lax.dynamic_slice_in_dim` takes it;
  - the losses are `losses.CentroidLosses`' (cos_sim, mse, softmax), all
    sums over the frames, with the accuracy and the cos-sim ≥ 0.95 accuracy;
  - with grad_accum K the batch splits into K microbatches whose gradients
    add up (the summed losses make that the full batch's gradient); the
    step reports the summed loss and the mean of the accuracies;
  - the update is optax's chain: the global norm of every gradient (the
    frozen encoder's too) clipped at 10 without an epsilon (scaled by
    10/‖g‖ only when ‖g‖ ≥ 10), then AdamW per group, `head` (fc_lr) and
    `base` (base_lr; none with train_encoder off, where the encoder moves
    not at all, not even by weight decay), betas (0.9, 0.98), eps 1e-6,
    weight decay 1e-2 on every parameter;
  - with skip_nonfinite the update is skipped whole on a nan/inf gradient
    (`train/guard.py`), while the state's step still advances.
The step runs under `device.full_f32()`: float32 parts never run in TF32,
and float32 attention runs in the math backend.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..device import full_f32
from ..losses import CentroidLosses
from ..models.hubert import EncoderWithHead
from ..ops.masking import mask_wave_frames
from .guard import SkipNonFinite
from .optim import AdamW


@dataclasses.dataclass(frozen=True)
class EAConfig:
    """Optimizer and loss hyperparameters (the reference's config.yaml
    `optimizer`)."""
    base_lr: float = 1e-4
    fc_lr: float = 1e-4
    betas: tuple = (0.9, 0.98)
    eps: float = 1e-6
    weight_decay: float = 1e-2
    clip_norm: float = 10.0
    loss: str = "cos_sim"            # cos_sim | mse | softmax
    train_encoder: bool = True
    mask_length: int = 20            # frames (20 ms each)
    grad_accum: int = 1              # microbatches per optimizer update
    skip_nonfinite: int = 0          # >0: never apply a nan/inf update;
                                     # the loop aborts past this many
                                     # consecutive skips


@dataclasses.dataclass
class EATrainState:
    """What a step changes: its count, the model's parameters, the
    optimizer's moments and counts, and the guard's skip counters."""
    step: int
    model: EncoderWithHead
    optimizer: "AdamW"
    guard: Optional[SkipNonFinite] = None

    def state_dict(self) -> dict:
        sd = {"step": self.step, "model": self.model.state_dict(),
              "optimizer": self.optimizer.state_dict()}
        if self.guard is not None:
            sd["guard"] = self.guard.state_dict()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.guard is not None:
            self.guard.load_state_dict(sd["guard"])


def _group(name: str) -> str:
    return "head" if name.split(".")[0] == "head" else "base"


def make_optimizer(cfg: EAConfig, model: EncoderWithHead) -> AdamW:
    """AdamW over the `head` group (fc_lr) and, with train_encoder, the
    `base` group (base_lr), the top-level module deciding; the clip and the
    guard act in the step."""
    params = {"head": [], "base": []}
    for name, p in model.named_parameters():
        params[_group(name)].append(p)
    groups = [{"params": params["head"], "lr": cfg.fc_lr}]
    if cfg.train_encoder:
        groups.append({"params": params["base"], "lr": cfg.base_lr})
    return AdamW(groups, lr=cfg.fc_lr, betas=cfg.betas, eps=cfg.eps,
                 weight_decay=cfg.weight_decay)


def create_state(cfg: EAConfig, model: EncoderWithHead) -> EATrainState:
    return EATrainState(step=0, model=model,
                        optimizer=make_optimizer(cfg, model),
                        guard=SkipNonFinite() if cfg.skip_nonfinite else None)


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: every gradient scaled by
    max_norm/‖g‖ when the global norm ‖g‖ is not below max_norm, with no
    epsilon (torch's clip_grad_norm_ divides by ‖g‖ + 1e-6)."""
    norm = torch.nn.utils.get_total_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


def gather_masked(outputs: torch.Tensor, mask_pos: torch.Tensor,
                  length: int) -> torch.Tensor:
    """outputs[b, p_b : p_b + length] per row, as
    `lax.dynamic_slice_in_dim` takes it: a negative p_b counts from the
    end (p_b + T), then p_b is clamped to [0, T − length]."""
    T = outputs.shape[1]
    start = mask_pos.long()
    start = torch.where(start < 0, start + T, start).clamp(0, T - length)
    idx = start[:, None] + torch.arange(length, device=outputs.device)
    return torch.gather(outputs, 1, idx[:, :, None].expand(
        -1, -1, outputs.shape[-1]))


def _losses_fn(cfg: EAConfig, centroids, device) -> Callable:
    """(model, batch) → (loss, acc, cos_sim_acc), the loss carrying grad."""
    closses = CentroidLosses(centroids, device=device)
    loss_of = {"cos_sim": closses.cos_sim,
               "mse": closses.mse}.get(cfg.loss, closses.soft_ce)
    L = cfg.mask_length

    def fn(model, batch):
        wav = mask_wave_frames(batch["wav"], batch["mask_pos"], L)
        # float32 attention in IEEE float32 products, as JAX's einsums at
        # HIGHEST: the math backend (the memory-efficient kernel computes
        # float32 on the tensor cores as 3×TF32, and its softmax backward
        # by another formula, which left the card's gradients of the last
        # layers' q/k projections several times further from float64 than
        # the CPU's); bf16 keeps torch's choice
        f32 = model.cfg.dtype == torch.float32
        with sdpa_kernel(SDPBackend.MATH) if f32 else contextlib.nullcontext():
            outputs = model(wav, batch["attn_mask"])
        values = gather_masked(outputs, batch["mask_pos"], L)
        labels = batch["labels"].long()
        loss, pred = loss_of(values, labels)
        with torch.no_grad():
            acc = (pred == labels).float().mean()
            cs = closses.cos_sim_pred_target(pred, labels)
            cos_acc = (cs >= 0.95).float().mean()
        return loss, acc, cos_acc

    return fn


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: EAConfig, centroids, device) -> Callable:
    """step(state, batch) → (state, metrics), `state` updated in place.
    Batch fields (numpy arrays or tensors; moved to `device`, the model's):
      wav        (B, T) float32 raw 16 kHz waveform (unmasked)
      attn_mask  (B, T) int, 1 on real samples
      mask_pos   (B,) int, mask start frame per row
      labels     (B, mask_length) int, centroid ids of the masked frames
    Metrics are 0-dim tensors on the device (reading one waits for it):
    acc, cos_sim_acc, loss, and nonfinite_skips (an int) with the guard."""
    losses = _losses_fn(cfg, centroids, device)
    A = cfg.grad_accum

    def step(state: EATrainState, batch):
        model = state.model
        batch = _on(batch, device)
        B = batch["wav"].shape[0]
        with full_f32():
            model.zero_grad(set_to_none=True)
            parts = []
            for i in range(A):
                mb = {k: v[i * B // A:(i + 1) * B // A]
                      for k, v in batch.items()}
                loss, acc, cos_acc = losses(model, mb)
                loss.backward()
                parts.append((loss.detach(), acc, cos_acc))
            grads = [p.grad for p in model.parameters()]

            def update():
                clip_by_global_norm_(grads, cfg.clip_norm)
                state.optimizer.step()

            if state.guard is None:
                update()
            else:
                state.guard(grads, update)
        loss, acc, cos_acc = (torch.stack(v) for v in zip(*parts))
        # in the order of the JAX step's (jitted, so sorted) metrics, which
        # the logger's lines follow
        metrics = {"acc": acc.mean(), "cos_sim_acc": cos_acc.mean(),
                   "loss": loss.sum()}
        if state.guard is not None:
            metrics["nonfinite_skips"] = state.guard.notfinite_count
        state.step += 1
        return state, metrics

    return step


def eval_step(cfg: EAConfig, centroids, device) -> Callable:
    """Validation step: step(model, batch) → {loss, acc, cos_sim_acc} as
    floats, no update."""
    losses = _losses_fn(cfg, centroids, device)

    @torch.no_grad()
    def step(model, batch):
        with full_f32():
            loss, acc, cos_acc = losses(model, _on(batch, device))
        return {"loss": float(loss), "acc": float(acc),
                "cos_sim_acc": float(cos_acc)}

    return step
