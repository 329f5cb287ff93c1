"""Load reference HiFi-GAN checkpoints into the port.

Counterpart of speech_inpainting_tpu/convert/hifigan_torch.py's
`convert_generator`, `convert_mpd`, `convert_msd`,
`load_generator_checkpoint` and `load_discriminator_checkpoint`.
  - A `g_*` file is `{"generator": state_dict}`, each conv weight-normed
    under either key style (legacy `weight_g`/`weight_v`, or
    `parametrizations.weight.original0/1`). torch's weight norm keeps dim=0
    on every conv, so `weight_g` is (C_out, 1, 1) on a Conv1d and (C_in, 1,
    1) on the ConvTranspose1d upsamplers, whose weight is (C_in, C_out, K):
    both fold over every axis but 0 (ops/conv.py), once, at load.
    ResBlock1 configs carry `resblocks.{n}.convs1.{s}` and `convs2.{s}`,
    ResBlock2 (V3) configs `resblocks.{n}.convs.{s}`. The result is the
    port's FastGenerator (ResBlock1s in K1), or its `Generator` (in K2)
    where `cls` asks for it; `load_trainable_generator` builds the GAN
    trainer's `WNGenerator` instead (--warm-start).
  - A `do_*` file holds `mpd` and `msd` state dicts (and the reference's
    torch optimizers, `steps` and `epoch`): `convert_mpd` and `convert_msd`
    build the port's discriminators from them, the MSD's scale 0
    spectral-normed (legacy `weight_orig`/`weight_u`/`weight_v`, or the
    parametrizations API's keys). The port's modules carry the legacy key
    names, so a legacy state dict also loads by `load_state_dict` as it is.
    The reference's torch optimizer states are not read.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.hifigan import (Generator, HiFiGANConfig,
                              MultiPeriodDiscriminator,
                              MultiScaleDiscriminator, WNGenerator)
from ..models.hifigan_fast import FastGenerator
from .from_jax import (generator_from_jax, mpd_from_jax, msd_from_jax,
                       reference_generator_tree, reference_mpd_tree,
                       reference_msd_tree, trainable_generator)


def convert_generator(sd: dict, cfg: HiFiGANConfig, device=None,
                      cls: type = FastGenerator) -> Generator:
    """Generator state dict → the port's `cls` (FastGenerator or
    Generator) in cfg.dtype on `device` (the CUDA card unless "cpu" is
    asked for)."""
    device = resolve_device(device)
    return generator_from_jax(cfg, reference_generator_tree(sd, cfg),
                              device=device, cls=cls)


def _load(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_generator_checkpoint(path, cfg: HiFiGANConfig, device=None,
                              cls: type = FastGenerator) -> Generator:
    """A reference `g_*` file (torch.save of {"generator": state_dict}) →
    `cls` on `device`."""
    device = resolve_device(device)
    return convert_generator(_load(path)["generator"], cfg, device=device,
                             cls=cls)


def load_trainable_generator(path, cfg: HiFiGANConfig,
                             device=None) -> WNGenerator:
    """A reference `g_*` file → the trainable `WNGenerator` on `device`,
    (g, v) as the file holds them."""
    device = resolve_device(device)
    return trainable_generator(
        cfg, reference_generator_tree(_load(path)["generator"], cfg),
        device=device)


def convert_mpd(sd: dict, dtype: torch.dtype = torch.float32,
                device=None) -> MultiPeriodDiscriminator:
    """MultiPeriodDiscriminator state dict (the reference's five periods)
    → the port's module on `device`, computing in `dtype`."""
    return mpd_from_jax(reference_mpd_tree(sd), dtype=dtype, device=device)


def convert_msd(sd: dict, dtype: torch.dtype = torch.float32,
                device=None) -> MultiScaleDiscriminator:
    """MultiScaleDiscriminator state dict (three scales, scale 0
    spectral-normed with its u/v) → the port's module on `device`."""
    params, spectral = reference_msd_tree(sd)
    return msd_from_jax(params, spectral, dtype=dtype, device=device)


def load_discriminator_checkpoint(path, dtype: torch.dtype = torch.float32,
                                  device=None) -> tuple:
    """A reference `do_*` file → (MultiPeriodDiscriminator,
    MultiScaleDiscriminator, steps, epoch) on `device`."""
    device = resolve_device(device)
    ckpt = _load(path)
    return (convert_mpd(ckpt["mpd"], dtype, device),
            convert_msd(ckpt["msd"], dtype, device),
            int(ckpt.get("steps", 0)), int(ckpt.get("epoch", -1)))
