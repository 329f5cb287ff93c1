"""HiFi-GAN training recipes: vanilla vocoder training and the
centroid-substitution decoder fine-tune ("modified").

Counterpart of speech_inpainting_tpu/train/hifigan.py:
  - vanilla: the generator's input is the hop-256, fmax-8000 mel of the
    audio crop, or the teacher `mel` where the batch has one; the loss mel
    is full band (fmax None);
  - modified: a hop-441 mel of the crop (pad 291) has a `mask_len`-frame
    span from `mask_start` (or, with mask_len −1, every frame) replaced by
    its nearest centroids (plain L2), and is regridded to
    `mel_input.num_frames(segment)` frames as the generator's input.
The pre-stage runs on the device inside the step, as in the JAX package:
the host ships raw audio crops and mask starts. gen_fwd(generator, batch)
runs the generator it is given: the step hands it the state's (a module
is its parameters), so the JAX package's `generator=` override is the
module handed to `create_gan_state`: a `WNISTFTGenerator` (--istft) trains
by both recipes and their evals unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.hifigan import HiFiGANConfig
from ..ops.masking import frame_mask
from ..ops.mel import (MODIFIED_MEL_22K, VOCODER_MEL_22K,
                       VOCODER_MEL_22K_FULLBAND, MelConfig, mel_spectrogram)
from ..ops.resize import regrid_mel_to
from ..quantize.kmeans import quantize_to_centroids
from .gan import (GANConfig, create_gan_state, default_discriminators,
                  make_gan_eval, make_gan_step)


@dataclasses.dataclass(frozen=True)
class HiFiGANTrainConfig:
    gan: GANConfig = GANConfig()
    hifigan: HiFiGANConfig = HiFiGANConfig()
    segment_size: int = 8192          # 44288 for the modified fine-tune
    mask_len: int = 20                # frames; -1 → quantize all frames
    mel_input: MelConfig = VOCODER_MEL_22K
    mel_441: MelConfig = MODIFIED_MEL_22K
    mel_loss: MelConfig = VOCODER_MEL_22K_FULLBAND


def vanilla_gen_fwd(cfg: HiFiGANTrainConfig) -> Callable:
    """gen_fwd(generator, batch) of the vanilla recipe: the generator's
    input is the in-graph mel of the crop, or the teacher 'mel'."""
    def gen_fwd(module, batch):
        mel = batch["mel"] if "mel" in batch else mel_spectrogram(
            batch["audio"][:, 0], cfg.mel_input)
        return module(mel)

    return gen_fwd


def modified_gen_fwd(cfg: HiFiGANTrainConfig, centroids) -> Callable:
    """gen_fwd(generator, batch) of the centroid-substitution recipe:
    hop-441 mel → nearest-centroid span replacement → regrid onto the
    hop-256 frame count."""
    host = torch.as_tensor(centroids, dtype=torch.float32)     # (K, 80)
    on = {}

    def gen_fwd(module, batch):
        audio = batch["audio"][:, 0]
        key = (audio.device, audio.dtype)
        C = on.get(key)
        if C is None:
            C = on[key] = host.to(*key)
        comp = mel_spectrogram(audio, cfg.mel_441)             # (B, 80, F)
        f441 = comp.shape[-1]
        q = quantize_to_centroids(comp.transpose(1, 2), C).transpose(1, 2)
        if cfg.mask_len < 0:
            comp = q
        else:
            m = frame_mask(f441, batch["mask_start"], cfg.mask_len,
                           device=audio.device)                # (B, F)
            comp = torch.where(m[:, None, :], q, comp)
        ext = regrid_mel_to(comp, cfg.mel_input.num_frames(audio.shape[-1]))
        return module(ext)

    return gen_fwd


def _loss_mel(cfg: HiFiGANTrainConfig) -> Callable:
    return lambda w: mel_spectrogram(w, cfg.mel_loss)


def make_vanilla_step(cfg: HiFiGANTrainConfig) -> Callable:
    """Vanilla HiFi-GAN: batch = {'audio': (B, 1, S)} (+ a teacher
    'mel')."""
    return make_gan_step(vanilla_gen_fwd(cfg), _loss_mel(cfg), cfg.gan)


def make_modified_step(cfg: HiFiGANTrainConfig, centroids) -> Callable:
    """Centroid-substitution fine-tune: batch = {'audio': (B, 1, S),
    'mask_start': (B,) int, the span's start in hop-441 frames}."""
    return make_gan_step(modified_gen_fwd(cfg, centroids), _loss_mel(cfg),
                         cfg.gan)


def make_vanilla_eval(cfg: HiFiGANTrainConfig) -> Callable:
    """Validation mel error of the vanilla recipe; eval_fn(generator,
    batch) → {'mel_error'}."""
    return make_gan_eval(vanilla_gen_fwd(cfg), _loss_mel(cfg))


def make_modified_eval(cfg: HiFiGANTrainConfig, centroids) -> Callable:
    """Validation mel error of the centroid-substitution recipe."""
    return make_gan_eval(modified_gen_fwd(cfg, centroids), _loss_mel(cfg))


__all__ = ["HiFiGANTrainConfig", "GANConfig", "create_gan_state",
           "default_discriminators", "make_vanilla_step",
           "make_modified_step", "make_vanilla_eval", "make_modified_eval",
           "vanilla_gen_fwd", "modified_gen_fwd"]
