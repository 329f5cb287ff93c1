"""I_da decoder-adaptation training: the unit-conditioned HiFi-GAN's GAN
step.

Counterpart of speech_inpainting_tpu/train/da.py (the reference's
I_da/scripts/train.py:99-442): the generator is a `WNCodeGenerator` fed
dict batches (code, f0, emb or spkr, audio, mel_loss), the loss mel is the
16 kHz full-band mel, and the frozen pitch quantizer stays out of the
generator's optimizer (`frozen_g_paths=("fo_vqvae",)`, train/gan.py).

Regimes:
  - decoder-only (the unit-embedding lookup): the pitch codebook is the
    frozen quantizer's, constant through training;
  - joint enc-VQ-dec (cfg.codegen.code_encoder set, the reference's
    lambda_commit_code): the content codebook updates inside every
    generator forward (make_gan_step's stateful_vq), its restarts drawn
    from the state's CPU generator (`create_da_state`).

The JAX package's generator forwards take (g_params, vq) and return the
updated `vq` collection; here they take the module, which is its
parameters and, as buffers, its codebooks, updated in place:
  - JAX gen_fwd(g_params, batch), the decoder-only regime with the pitch
    tree closed over → gen_fwd(module, batch);
  - JAX gen_fwd(g_params, vq, rng, batch) → (ŷ, commit, new_vq), the joint
    regime → gen_fwd(module, batch, rng, group) → (ŷ, commit), `group` the
    mesh's data group (None on one device), over whose rows the content
    codebook updates;
  - JAX da_gen_fwd's gen_fwd((g_params, vq), batch) → gen_fwd(module,
    batch), on the folded module in the loops' sweeps.
So `make_da_step` takes no codebook: the JAX package's `vq_tree` (the
pitch quantizer's codebook, closed over in the decoder-only regime) lives
in the module (`convert/from_jax.py:trainable_codegen`,
`convert/ida_torch.py:load_f0_quantizer`), and one passed here is refused
in either regime.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from ..models.codegen import CodeGeneratorConfig
from ..ops.mel import VOCODER_MEL_16K_FULLBAND, MelConfig, mel_spectrogram
from .gan import (GANConfig, GANTrainState, create_gan_state,
                  make_gan_eval, make_gan_step)


@dataclasses.dataclass(frozen=True)
class DATrainConfig:
    codegen: CodeGeneratorConfig
    gan: GANConfig = GANConfig(frozen_g_paths=("fo_vqvae",))
    mel_loss: MelConfig = VOCODER_MEL_16K_FULLBAND
    segment_size: int = 8960
    code_hop_size: int = 320


def _mel_fn(cfg: DATrainConfig) -> Callable:
    return lambda w: mel_spectrogram(w, cfg.mel_loss)


def _conditioning(batch) -> dict:
    return dict(f0=batch.get("f0"), emb=batch.get("emb"),
                spkr=batch.get("spkr"))


def make_da_step(cfg: DATrainConfig, vq_tree=None) -> Callable:
    """step(state, batch) → (state, metrics). batch = {'code': (B, F) int
    (or (B, C, T) float in the joint regime), 'f0': (B, 1, Ff), 'emb':
    (B, E) or 'spkr': (B,), 'audio': (B, 1, S)}, 'mel_loss' optional (else
    computed on the device). The joint regime (cfg.codegen.code_encoder
    set) runs the content VQ's training forward inside the step, whose
    codebook is the state's generator's and whose candidates come from
    state.rng (`create_da_state`). A `vq_tree` is refused: the module
    carries its codebooks (module docstring); in the joint regime, as in
    the JAX package, a closed-over codebook would freeze it."""
    if vq_tree is not None:
        if cfg.codegen.content_vq:
            raise ValueError(
                "content-VQ (joint) regime: the codebook must live in the "
                "train state's generator (create_da_state), not be closed "
                "over — passing vq_tree here would silently freeze it")
        raise ValueError(
            "the port's generator carries its codebooks as buffers: load "
            "the pitch quantizer's into the module (trainable_codegen or "
            "load_f0_quantizer), not into the step")
    mel_fn = _mel_fn(cfg)
    if cfg.codegen.content_vq:
        def joint_fwd(module: nn.Module, batch, rng: torch.Generator,
                      group=None):
            wav, commit, _ = module(batch["code"], **_conditioning(batch),
                                    train=True, generator=rng, group=group)
            return wav, commit

        return make_gan_step(joint_fwd, mel_fn, cfg.gan, stateful_vq=True)
    return make_gan_step(da_gen_fwd(cfg), mel_fn, cfg.gan)


def da_gen_fwd(cfg: DATrainConfig) -> Callable:
    """The eval-mode generator forward of the decoder loops: gen_fwd(module,
    batch) → ŷ, plus (commit, metrics) in the joint regime; eval mode never
    updates a codebook (quantize/vq.py's eval forward)."""
    def gen_fwd(module: nn.Module, batch):
        return module(batch["code"], **_conditioning(batch))

    return gen_fwd


def make_da_eval(cfg: DATrainConfig) -> Callable:
    """Validation mel error of the decoder loops (the reference's sweep,
    I_da/scripts/train.py:362-385): eval_fn(module, batch) →
    {'mel_error'}, a trainable module folded first (its ResBlock1s then
    run in K2 on the card)."""
    return make_gan_eval(da_gen_fwd(cfg), _mel_fn(cfg))


def create_da_state(cfg: DATrainConfig, generator: nn.Module, mpd, msd, *,
                    seed: int = 1234) -> GANTrainState:
    """The GAN state of the joint regime: `generator` holds its codebooks
    (from trainable_codegen, its fresh init or a converted checkpoint), and
    a CPU generator seeded `seed` draws the restart candidates (JAX's
    PRNGKey(seed) in `state.rng`; the reference's torch randperm,
    vq.py:66-68)."""
    return create_gan_state(cfg.gan, generator, mpd, msd,
                            rng=torch.Generator().manual_seed(seed))


__all__ = ["DATrainConfig", "GANConfig", "create_gan_state",
           "create_da_state", "make_da_step", "make_da_eval", "da_gen_fwd"]
