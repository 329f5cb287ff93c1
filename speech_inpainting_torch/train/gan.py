"""GAN train step (HiFi-GAN): discriminators first, then the generator, as
the JAX package takes it.

Counterpart of speech_inpainting_tpu/train/gan.py (the reference's
schedule, I_ea/hifi_gan/train.py:148-186):
  1. one generator forward ŷ, whose graph is kept;
  2. the discriminators' step: LSGAN loss of MPD and MSD on (y, ŷ detached),
     AdamW over both discriminators' parameters;
  3. the generator's losses on the same ŷ against the updated
     discriminators: adversarial + feature matching + 45 × mel-L1 (+
     λ·commit), whose gradient reaches the generator alone: the
     discriminators' parameters are taken out of autograd for that
     forward, so it builds no graph of their weights and leaves their
     `.grad` as the D step left it.
AdamW (betas 0.8, 0.99, eps 1e-8, weight decay 0.01 on every parameter)
for each side, with optax's staircase exponential decay of the learning
rate over `steps_per_epoch` updates, evaluated at the count before each
update. With `skip_nonfinite` each optimizer is guarded on its own
gradients (a skipped update moves neither the parameters, nor the
moments, nor either count); the step reports the larger of the two
consecutive-skip counters. The MSD's spectral-norm u/v advance four times a
step (real and fake in each phase), guarded or not: the power iteration
reads only the weights. The step runs under `device.full_f32()`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from .. import losses
from ..device import full_f32
from ..models.hifigan import (Generator, MultiPeriodDiscriminator,
                              MultiScaleDiscriminator)
from ..models.hifigan_istft import ISTFTGenerator
from .guard import SkipNonFinite
from .optim import AdamW, exponential_decay

_ITEM_10 = "ROADMAP Queue 1 item 10 (I_da training)"


@dataclasses.dataclass(frozen=True)
class GANConfig:
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    weight_decay: float = 0.01       # torch AdamW's default
    lr_decay: float = 0.999          # per-epoch ExponentialLR gamma
    steps_per_epoch: int = 1000
    mel_weight: float = 45.0
    lambda_commit: float = 0.0       # I_da lambda_commit_code
    frozen_g_paths: tuple = ()       # not ported: ROADMAP item 10
    batched_disc: bool = False       # (real, fake) as one 2B forward through
                                     # each weight-normed discriminator
    folded_mpd: bool = False         # TPU layout knob: not ported
    skip_nonfinite: int = 0          # >0: never apply a nan/inf update; the
                                     # loop aborts past this many
                                     # consecutive skips
    disc_bf16: bool = False          # discriminators' convs compute in bf16
                                     # (parameters f32, losses reduce f32)


@dataclasses.dataclass
class GANTrainState:
    """What a step changes: its count, the three modules (the MSD's u/v in
    its buffers), both optimizers and, with skip_nonfinite, both guards."""
    step: int
    generator: nn.Module
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    g_opt: AdamW
    d_opt: AdamW
    g_guard: Optional[SkipNonFinite] = None
    d_guard: Optional[SkipNonFinite] = None

    def d_parameters(self) -> list:
        return [*self.mpd.parameters(), *self.msd.parameters()]

    def state_dict(self) -> dict:
        sd = {"step": self.step, "generator": self.generator.state_dict(),
              "mpd": self.mpd.state_dict(), "msd": self.msd.state_dict(),
              "optim_g": self.g_opt.state_dict(),
              "optim_d": self.d_opt.state_dict()}
        if self.g_guard is not None:
            sd["guards"] = {"g": self.g_guard.state_dict(),
                            "d": self.d_guard.state_dict()}
        return sd

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.generator.load_state_dict(sd["generator"])
        self.mpd.load_state_dict(sd["mpd"])
        self.msd.load_state_dict(sd["msd"])
        self.g_opt.load_state_dict(sd["optim_g"])
        self.d_opt.load_state_dict(sd["optim_d"])
        if self.g_guard is not None:
            self.g_guard.load_state_dict(sd["guards"]["g"])
            self.d_guard.load_state_dict(sd["guards"]["d"])


def _check(cfg: GANConfig, stateful_vq: bool = False) -> None:
    if stateful_vq:
        raise NotImplementedError(
            f"stateful_vq (the joint enc-VQ-dec regime) waits for {_ITEM_10}")
    if cfg.frozen_g_paths:
        raise NotImplementedError(
            f"frozen_g_paths waits for {_ITEM_10}")
    if cfg.folded_mpd:
        raise NotImplementedError(
            "folded_mpd is a TPU layout knob that is not ported (ROADMAP "
            "Queue 1 item 9, what is left)")


def _adamw(cfg: GANConfig, params) -> AdamW:
    return AdamW(params, lr=cfg.learning_rate,
                 betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8,
                 weight_decay=cfg.weight_decay,
                 schedule=exponential_decay(cfg.learning_rate,
                                            cfg.steps_per_epoch,
                                            cfg.lr_decay))


def default_discriminators(cfg: GANConfig, device=None,
                           seeds: tuple = (1, 2)) -> tuple:
    """(MPD, MSD) at the reference's periods and scales on `device`,
    computing in bf16 with disc_bf16, drawn from generators seeded with
    `seeds` (the JAX CLI inits them from PRNGKeys 1 and 2)."""
    _check(cfg)
    from ..convert.from_jax import mpd_from_jax, msd_from_jax
    dt = torch.bfloat16 if cfg.disc_bf16 else torch.float32
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    return (mpd_from_jax(dtype=dt, device=device, generator=gens[0]),
            msd_from_jax(dtype=dt, device=device, generator=gens[1]))


def _check_modules(cfg: GANConfig, generator: nn.Module,
                   mpd: nn.Module, msd: nn.Module) -> None:
    if isinstance(generator, ISTFTGenerator):
        raise NotImplementedError(
            "a trainable ISTFTGenerator (--istft) is not ported (ROADMAP "
            "Queue 1 item 9, what is left)")
    for m in (*mpd.modules(), *msd.modules()):
        dt = getattr(m, "dtype", None)
        if isinstance(dt, torch.dtype) and (
                dt == torch.bfloat16) != cfg.disc_bf16:
            raise ValueError(
                f"disc_bf16={cfg.disc_bf16} but the discriminators compute "
                f"in {dt}: build them with the config's type "
                "(default_discriminators)")


def create_gan_state(cfg: GANConfig, generator: nn.Module,
                     mpd: MultiPeriodDiscriminator,
                     msd: MultiScaleDiscriminator) -> GANTrainState:
    """A step-0 state over the three modules: one AdamW for the generator,
    one for both discriminators (as the JAX package's {"mpd", "msd"}
    tree). The step trains these modules, whatever their periods and
    scales (the JAX package's mpd/msd overrides); the config's disc_bf16
    must agree with the type they compute in, and an iSTFT generator is
    refused."""
    _check(cfg)
    _check_modules(cfg, generator, mpd, msd)
    guard = (lambda: SkipNonFinite()) if cfg.skip_nonfinite else (
        lambda: None)
    return GANTrainState(
        step=0, generator=generator, mpd=mpd, msd=msd,
        g_opt=_adamw(cfg, list(generator.parameters())),
        d_opt=_adamw(cfg, [*mpd.parameters(), *msd.parameters()]),
        g_guard=guard(), d_guard=guard())


@contextlib.contextmanager
def _frozen(params):
    """`params` out of autograd for the block (no graph of them is built,
    their .grad untouched), back in after it."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _update(guard: Optional[SkipNonFinite], opt: AdamW, params) -> None:
    if guard is None:
        opt.step()
    else:
        guard([p.grad for p in params], opt.step)


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_gan_step(generator_fwd: Callable, mel_fn: Callable, cfg: GANConfig,
                  *, stateful_vq: bool = False) -> Callable:
    """step(state, batch) → (state, metrics), `state` updated in place.

    generator_fwd(generator, batch) → ŷ (B, 1, T), or (ŷ, commit) where
    lambda_commit > 0. mel_fn(wav (B, T)) → the loss mel. batch holds
    'audio' (B, 1, T), the ground truth, and 'mel_loss' (B, n_mels, F)
    where the loss mel is precomputed (else mel_fn(audio)); numpy arrays or
    tensors, moved to the generator's device. The state's modules run (a
    module is its parameters), so the JAX package's mpd/msd overrides are
    the modules handed to create_gan_state.
    Metrics are 0-dim tensors on the device (reading one waits for it), in
    the order of the JAX step's (jitted, so sorted) metrics; with the guard
    'nonfinite_skips' is an int."""
    _check(cfg, stateful_vq)
    has_commit = cfg.lambda_commit > 0

    def step(state: GANTrainState, batch):
        device = next(state.generator.parameters()).device
        batch = _on(batch, device)
        y = batch["audio"]
        d_params = state.d_parameters()
        with full_f32():
            with torch.no_grad():
                mel_gt = (batch["mel_loss"] if "mel_loss" in batch
                          else mel_fn(y[:, 0]))
            # ---- 1. one generator forward, its graph kept -------------
            out = generator_fwd(state.generator, batch)
            y_hat, commit = out if has_commit else (out, None)

            # ---- 2. the discriminators on (y, ŷ detached) -------------
            y_hat_d = y_hat.detach()
            pr, pg, _, _ = state.mpd(y, y_hat_d, cfg.batched_disc)
            sr, sg, _, _ = state.msd(y, y_hat_d, True, cfg.batched_disc)
            d_loss = (losses.discriminator_loss(pr, pg)[0]
                      + losses.discriminator_loss(sr, sg)[0])
            state.d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            _update(state.d_guard, state.d_opt, d_params)

            # ---- 3. the generator's losses vs the updated discs -------
            with _frozen(d_params):
                mel_estim = mel_fn(y_hat[:, 0])
                _, pg, pfr, pfg = state.mpd(y, y_hat, cfg.batched_disc)
                _, sg, sfr, sfg = state.msd(y, y_hat, True, cfg.batched_disc)
                gen_f, _ = losses.generator_loss(pg)
                gen_s, _ = losses.generator_loss(sg)
                fm_f = losses.feature_loss(pfr, pfg)
                fm_s = losses.feature_loss(sfr, sfg)
                loss_mel = cfg.mel_weight * torch.mean(
                    torch.abs(mel_gt - mel_estim))
                total = gen_f + gen_s + fm_f + fm_s + loss_mel
                if has_commit:
                    total = total + cfg.lambda_commit * commit
                state.g_opt.zero_grad(set_to_none=True)
                total.backward()
            _update(state.g_guard, state.g_opt,
                    list(state.generator.parameters()))
        metrics = dict(fm_f=fm_f.detach(), fm_s=fm_s.detach(),
                       gen_f=gen_f.detach(), gen_s=gen_s.detach(),
                       loss_disc=d_loss.detach(),
                       loss_gen_all=total.detach(),
                       mel_error=(loss_mel / cfg.mel_weight).detach())
        if has_commit:
            metrics["commit"] = commit.detach()
        if state.g_guard is not None:
            metrics["nonfinite_skips"] = max(state.g_guard.notfinite_count,
                                             state.d_guard.notfinite_count)
        state.step += 1
        return state, dict(sorted(metrics.items()))

    return step


def make_gan_eval(generator_fwd: Callable, mel_fn: Callable) -> Callable:
    """Validation metric of the GAN loops: a generator-only forward without
    gradient, mel_error = mean |mel(ŷ) − loss mel|. eval_fn(generator,
    batch) → {"mel_error": float}; a trainable generator is folded first
    (`fold()`: its ResBlock1s then run in K2 on the card), so that callers
    sweeping many batches fold it once themselves (train/run.py's
    gan_valid_fn)."""
    @torch.no_grad()
    def eval_fn(generator: Any, batch) -> dict:
        if hasattr(generator, "fold"):
            generator = generator.fold(cls=Generator)
        device = next(generator.parameters()).device
        batch = _on(batch, device)
        with full_f32():
            y = batch["audio"]
            mel_gt = (batch["mel_loss"] if "mel_loss" in batch
                      else mel_fn(y[:, 0]))
            out = generator_fwd(generator, batch)
            y_hat = out[0] if isinstance(out, tuple) else out
            err = torch.mean(torch.abs(mel_gt - mel_fn(y_hat[:, 0])))
        return {"mel_error": float(err)}

    return eval_fn
