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

`frozen_g_paths` names top-level submodules of the generator (the I_da
trainer's frozen pitch quantizer, "fo_vqvae") whose parameters stay out of
the generator's optimizer and out of autograd; JAX gives them
`optax.set_to_zero`, and their gradients are exactly zero behind its
stop_gradient, so its guard reads nothing else either. `stateful_vq` is
the joint enc-VQ-dec regime: the generator's EMA codebooks (its buffers)
update inside its one forward, from restart candidates drawn from the
state's CPU `torch.Generator` (`GANTrainState.rng`; JAX splits a PRNG key
per step, which torch cannot replay), and the step adds λ·commit. The
update writes only the buffers, which no saved tensor of the graph
aliases, so the D step between that forward and the G backward leaves the
backward intact. With `skip_nonfinite` the codebooks are gated on their
own finiteness (`guard.tree_if_finite`), as JAX gates `state.vq`.

On a mesh (`state.mesh`, set by train/run.py or the caller) each rank
holds its rows of the global batch; the D gradients are averaged over the
mesh's data axes after the D backward and the G gradients after the G
backward, each before its update and guard (one coalesced all_reduce
each): every GAN loss is a mean over equal row counts, so the global
batch's gradient is the mean over ranks. A nan on one rank reaches every
rank, so all skip together, as the guard over JAX's global arrays does.
The metrics are averaged. With stateful_vq the codebook's sums run over
every rank's rows and its candidates are drawn from the gathered rows (the
same draw on every rank), as JAX's mesh-jitted step does over the global
batch. The step is written out rather than wrapped in DDP: one generator
forward feeds the D step and then, against the updated discriminators,
the G step, which DDP's one-backward-per-forward hooks do not model.

The generator is any trainable module: `WNGenerator`, the iSTFT head's
`WNISTFTGenerator` (JAX's `generator=` override), or the unit trainer's
`WNCodeGenerator`. `folded_mpd`, the JAX package's layout knob for the
TPU, is refused: the port lays the MPD's period fold out one way.
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
from ..parallel.distributed import (all_reduce_grads, data_group,
                                    reduce_metrics)
from .guard import SkipNonFinite, tree_if_finite
from .optim import AdamW, exponential_decay


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
    frozen_g_paths: tuple = ()       # generator submodules kept out of
                                     # its optimizer (I_da: "fo_vqvae")
    batched_disc: bool = False       # (real, fake) as one 2B forward through
                                     # each weight-normed discriminator
    folded_mpd: bool = False         # TPU layout knob: refused
    skip_nonfinite: int = 0          # >0: never apply a nan/inf update; the
                                     # loop aborts past this many
                                     # consecutive skips
    disc_bf16: bool = False          # discriminators' convs compute in bf16
                                     # (parameters f32, losses reduce f32)


@dataclasses.dataclass
class GANTrainState:
    """What a step changes: its count, the three modules (the MSD's u/v and
    any EMA codebooks of the generator in their buffers), both optimizers,
    with skip_nonfinite both guards, and with stateful_vq the restart
    candidates' CPU generator `rng` (JAX's `state.rng`); and the mesh the
    step runs on (None: one device), which no checkpoint holds."""
    step: int
    generator: nn.Module
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    g_opt: AdamW
    d_opt: AdamW
    g_guard: Optional[SkipNonFinite] = None
    d_guard: Optional[SkipNonFinite] = None
    rng: Optional[torch.Generator] = None
    mesh: Optional[object] = None

    def d_parameters(self) -> list:
        return [*self.mpd.parameters(), *self.msd.parameters()]

    def g_parameters(self) -> list:
        """The generator's trained parameters: those of its optimizer."""
        return [p for g in self.g_opt.param_groups for p in g["params"]]

    def state_dict(self) -> dict:
        sd = {"step": self.step, "generator": self.generator.state_dict(),
              "mpd": self.mpd.state_dict(), "msd": self.msd.state_dict(),
              "optim_g": self.g_opt.state_dict(),
              "optim_d": self.d_opt.state_dict()}
        if self.g_guard is not None:
            sd["guards"] = {"g": self.g_guard.state_dict(),
                            "d": self.d_guard.state_dict()}
        if self.rng is not None:
            sd["rng"] = self.rng.get_state()
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
        if self.rng is not None:
            self.rng.set_state(sd["rng"])


def _check(cfg: GANConfig) -> None:
    if cfg.folded_mpd:
        raise NotImplementedError(
            "folded_mpd is the JAX package's layout of the MPD's period "
            "fold for the TPU; the port keeps the one layout (the same "
            "parameters and losses): leave it off")


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
    if isinstance(generator, Generator):
        name = ("trainable_istft_generator"
                if isinstance(generator, ISTFTGenerator)
                else "trainable_generator")
        raise ValueError(
            f"{type(generator).__name__} is the inference form, with no "
            f"trainable parameters: build the generator with "
            f"convert/from_jax.py:{name}")
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
                     msd: MultiScaleDiscriminator, *,
                     rng: Optional[torch.Generator] = None) -> GANTrainState:
    """A step-0 state over the three modules: one AdamW for the generator,
    one for both discriminators (as the JAX package's {"mpd", "msd"}
    tree). The step trains these modules, whatever their periods and
    scales (the JAX package's mpd/msd overrides); the config's disc_bf16
    must agree with the type they compute in, and folded_mpd and an
    inference generator (no trainable parameters) are refused. The
    generator's submodules named in cfg.frozen_g_paths are frozen
    (requires_grad off) and left out of its optimizer; a name the
    generator lacks freezes nothing, as in the JAX package (the joint
    regime's generator has no "fo_vqvae"). `rng`, a CPU
    torch.Generator, draws a stateful_vq step's restart candidates
    (train/da.py:create_da_state seeds it)."""
    _check(cfg)
    _check_modules(cfg, generator, mpd, msd)
    for name, child in generator.named_children():
        if name in cfg.frozen_g_paths:
            child.requires_grad_(False)
    trained = [p for n, p in generator.named_parameters()
               if n.split(".")[0] not in cfg.frozen_g_paths]
    guard = (lambda: SkipNonFinite()) if cfg.skip_nonfinite else (
        lambda: None)
    return GANTrainState(
        step=0, generator=generator, mpd=mpd, msd=msd,
        g_opt=_adamw(cfg, trained),
        d_opt=_adamw(cfg, [*mpd.parameters(), *msd.parameters()]),
        g_guard=guard(), d_guard=guard(), rng=rng)


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
    lambda_commit > 0; with stateful_vq generator_fwd(generator, batch,
    rng, group) → (ŷ, commit), the generator's codebooks updated inside it
    from candidates drawn from `rng` (the state's), over the rows of
    `group`'s ranks (None on one device; JAX's generator_fwd(g_params,
    vq, rng, batch) → (ŷ, commit, new_vq), whose new_vq is the module's
    buffers here). mel_fn(wav (B, T)) → the loss mel. batch holds
    'audio' (B, 1, T), the ground truth, and 'mel_loss' (B, n_mels, F)
    where the loss mel is precomputed (else mel_fn(audio)); numpy arrays or
    tensors, moved to the generator's device. The state's modules run (a
    module is its parameters), so the JAX package's mpd/msd overrides are
    the modules handed to create_gan_state.
    Metrics are 0-dim tensors on the device (reading one waits for it), in
    the order of the JAX step's (jitted, so sorted) metrics; with the guard
    'nonfinite_skips' is an int."""
    _check(cfg)
    has_commit = cfg.lambda_commit > 0 or stateful_vq

    def step(state: GANTrainState, batch):
        device = next(state.generator.parameters()).device
        batch = _on(batch, device)
        y = batch["audio"]
        d_params = state.d_parameters()
        vq_before = None
        group = (None if state.mesh is None
                 else data_group(state.mesh))
        if stateful_vq:
            if state.rng is None:
                raise ValueError("stateful_vq draws restart candidates from "
                                 "state.rng: build the state with "
                                 "train/da.py:create_da_state")
            vq = list(state.generator.buffers())
            vq_before = ([b.clone() for b in vq] if cfg.skip_nonfinite
                         else None)
        with full_f32():
            with torch.no_grad():
                mel_gt = (batch["mel_loss"] if "mel_loss" in batch
                          else mel_fn(y[:, 0]))
            # ---- 1. one generator forward, its graph kept -------------
            if stateful_vq:
                y_hat, commit = generator_fwd(state.generator, batch,
                                              state.rng, group)
            else:
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
            if group is not None:
                all_reduce_grads(d_params, group, average=True)
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
            if group is not None:
                all_reduce_grads(state.g_parameters(), group, average=True)
            _update(state.g_guard, state.g_opt, state.g_parameters())
        if vq_before is not None:
            # the codebooks updated in the forward, out of the optimizers'
            # sight: kept only where every new value is finite
            tree_if_finite(vq, vq_before)
        metrics = dict(fm_f=fm_f.detach(), fm_s=fm_s.detach(),
                       gen_f=gen_f.detach(), gen_s=gen_s.detach(),
                       loss_disc=d_loss.detach(),
                       loss_gen_all=total.detach(),
                       mel_error=(loss_mel / cfg.mel_weight).detach())
        if has_commit:
            metrics["commit"] = commit.detach()
        if group is not None:
            metrics = reduce_metrics(metrics, group)
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
            generator = generator.fold()
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
