"""Load reference HiFi-GAN generator checkpoints into the port.

Counterpart of speech_inpainting_tpu/convert/hifigan_torch.py's
`convert_generator` and `load_generator_checkpoint`: a `g_*` file is
`{"generator": state_dict}`, each conv weight-normed under either key style
(legacy `weight_g`/`weight_v`, or `parametrizations.weight.original0/1`).
torch's weight norm keeps dim=0 on every conv, so `weight_g` is (C_out, 1, 1)
on a Conv1d and (C_in, 1, 1) on the ConvTranspose1d upsamplers, whose
weight is (C_in, C_out, K): both fold over every axis but 0 (ops/conv.py),
once, at load. ResBlock1 configs carry `resblocks.{n}.convs1.{s}` and
`convs2.{s}`, ResBlock2 (V3) configs `resblocks.{n}.convs.{s}`. The result
is the port's FastGenerator (ResBlock1s in K1), or its `Generator` (in K2)
where `cls` asks for it. Discriminators (`do_*` files) are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.hifigan import Generator, HiFiGANConfig
from ..models.hifigan_fast import FastGenerator
from .from_jax import generator_from_jax


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _wn_params(sd: dict, prefix: str) -> dict:
    """{v, g, b} of the weight-normed conv at `prefix`; g flattened to one
    magnitude per row of axis 0 (C_out, or C_in on a transposed conv)."""
    for g, v in (("weight_g", "weight_v"),
                 ("parametrizations.weight.original0",
                  "parametrizations.weight.original1")):
        if f"{prefix}.{g}" in sd:
            return {"v": _np(sd[f"{prefix}.{v}"]),
                    "g": _np(sd[f"{prefix}.{g}"]).reshape(-1),
                    "b": _np(sd[f"{prefix}.bias"])}
    raise KeyError(f"no weight-norm params under '{prefix}'")


def _generator_tree(sd: dict, cfg: HiFiGANConfig) -> dict:
    """Generator state dict → the JAX package's `Generator` tree."""
    nk = len(cfg.resblock_kernel_sizes)
    convs = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
    tree = {"conv_pre": _wn_params(sd, "conv_pre"),
            "conv_post": _wn_params(sd, "conv_post")}
    for i in range(len(cfg.upsample_rates)):
        tree[f"ups_{i}"] = _wn_params(sd, f"ups.{i}")
        for j, rd in enumerate(cfg.resblock_dilation_sizes):
            p = f"resblocks.{i * nk + j}"
            tree[f"resblocks_{i}_{j}"] = {
                f"{c}_{s}": _wn_params(sd, f"{p}.{c}.{s}")
                for c in convs for s in range(len(rd))}
    return tree


def convert_generator(sd: dict, cfg: HiFiGANConfig, device=None,
                      cls: type = FastGenerator) -> Generator:
    """Generator state dict → the port's `cls` (FastGenerator or
    Generator) in cfg.dtype on `device` (the CUDA card unless "cpu" is
    asked for)."""
    device = resolve_device(device)
    return generator_from_jax(cfg, _generator_tree(sd, cfg), device=device,
                              cls=cls)


def load_generator_checkpoint(path, cfg: HiFiGANConfig, device=None,
                              cls: type = FastGenerator) -> Generator:
    """A reference `g_*` file (torch.save of {"generator": state_dict}) →
    `cls` on `device`."""
    device = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return convert_generator(ckpt["generator"], cfg, device=device, cls=cls)
