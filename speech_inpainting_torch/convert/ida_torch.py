"""Load the reference's I_da checkpoints (f0-VQ-VAE `g_*`, CodeGenerator
`g_*`) into the port.

Counterpart of speech_inpainting_tpu/convert/ida_torch.py: the same key
maps, into the JAX package's tree names, then through convert/from_jax.py's
loaders into the port's modules (weight norm folded once, at load). The
reference's files:
  f0-VQ-VAE g_*:     {'generator': FoVQVAE sd, 'optim_g', 'steps', 'epoch'}
  CodeGenerator g_*: {'generator': sd}  (HiFi-GAN keys at top level, plus
                     emb_c (unit lookup) or code_encoder.* and code_vq.*
                     (content VQ), emb_p, emb_s and fo_vqvae.*)
Only the EMA codebook `k` is a registered buffer in the reference
(vq.py:22); it becomes the port's `k` buffer (k_sum and k_elem, training
state, are not in the reference's files). The port's own pitch quantizer,
trained by cli/train_f0vq.py, is a directory of `g_{step:08d}` files
({"params", "vq", "opt", "steps"}): `load_f0vq_training_checkpoint` reads
its newest, and `load_f0_quantizer` takes either form, as the JAX
package's `train_da --f0-quantizer` does (cli/train_da.py:103-114), into a
CodeGenerator's frozen `fo_vqvae`.

Jukebox Sequential indices map as:
  encoder level: model.{i}.0 (strided conv), model.{i}.1 (Resnet1D),
                 model.{down_t} (final conv)
  decoder level: model.0 (proj conv), model.{1+i}.0 (Resnet1D),
                 model.{1+i}.1 (ConvTranspose1d)
  ResConv1DBlock: model.1 (k3 conv), model.3 (k1 conv)
A reversed-dilation decoder stores its blocks reversed.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models.codegen import (CodeGenerator, CodeGeneratorConfig, FoVQVAE,
                              FoVQVAEConfig)
from ..models.jukebox import ConvStackConfig
from ..utils.checkpoints import Checkpointer
from .from_jax import (codegen_from_jax, fo_vqvae_from_jax,
                       reference_generator_tree)


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _conv(sd, prefix) -> dict:
    return {"w": _np(sd[f"{prefix}.weight"]), "b": _np(sd[f"{prefix}.bias"])}


def _resnet(sd, prefix, cfg: ConvStackConfig, reverse: bool) -> dict:
    out = {}
    for i in range(cfg.depth):
        j = cfg.depth - 1 - i if reverse else i
        out[f"block_{i}"] = {"conv3": _conv(sd, f"{prefix}.model.{j}.model.1"),
                             "conv1": _conv(sd, f"{prefix}.model.{j}.model.3")}
    return out


def convert_encoder(sd: dict, prefix: str, cfg: ConvStackConfig) -> dict:
    """The jukebox Encoder at `prefix` → its `Encoder` tree."""
    params = {}
    for level in range(cfg.levels):
        base, d = f"{prefix}level_blocks.{level}.model", cfg.downs_t[level]
        lp = {}
        for i in range(d):
            lp[f"down_{i}_conv"] = _conv(sd, f"{base}.{i}.0")
            lp[f"down_{i}_resnet"] = _resnet(sd, f"{base}.{i}.1", cfg, False)
        lp["proj"] = _conv(sd, f"{base}.{d}")
        params[f"level_{level}"] = lp
    return params


def convert_decoder(sd: dict, prefix: str, cfg: ConvStackConfig) -> dict:
    """The jukebox Decoder at `prefix` → its `Decoder` tree."""
    params = {}
    for level in range(cfg.levels):
        base = f"{prefix}level_blocks.{level}.model"
        lp = {"proj": _conv(sd, f"{base}.0")}
        for i in range(cfg.downs_t[level]):
            lp[f"up_{i}_resnet"] = _resnet(sd, f"{base}.{1 + i}.0", cfg,
                                           cfg.reverse_decoder_dilation)
            lp[f"up_{i}_convt"] = _conv(sd, f"{base}.{1 + i}.1")
        params[f"level_{level}"] = lp
    params["out"] = _conv(sd, f"{prefix}out")
    return params


def convert_bottleneck_vars(sd: dict, prefix: str, levels: int) -> dict:
    """The VQ buffers at `prefix` → {level_{i}: {"k": codebook}}."""
    return {f"level_{level}": {"k": _np(sd[f"{prefix}level_blocks.{level}.k"])}
            for level in range(levels)}


def _fo_vqvae_trees(sd: dict, cfg: FoVQVAEConfig, prefix: str):
    params = {"encoder": convert_encoder(sd, f"{prefix}encoder.",
                                         cfg.encoder),
              "decoder": convert_decoder(sd, f"{prefix}decoder.",
                                         cfg.decoder)}
    return params, {"vq": convert_bottleneck_vars(sd, f"{prefix}vq.",
                                                  cfg.levels)}


def convert_fo_vqvae(sd: dict, cfg: FoVQVAEConfig, prefix: str = "",
                     device=None) -> FoVQVAE:
    """FoVQVAE state dict → the port's FoVQVAE on `device` (the CUDA card
    unless "cpu" is asked for)."""
    device = resolve_device(device)
    return fo_vqvae_from_jax(cfg, *_fo_vqvae_trees(sd, cfg, prefix),
                             device=device)


def convert_code_generator(sd: dict, cfg: CodeGeneratorConfig,
                           device=None) -> CodeGenerator:
    """CodeGenerator state dict, either regime → the port's CodeGenerator
    on `device` (its generator in cfg.hifigan.dtype, the ResBlock1s in
    K2)."""
    device = resolve_device(device)
    params = {"generator": reference_generator_tree(sd, cfg.hifigan)}
    vq_tree = {}
    if cfg.content_vq:
        params["code_encoder"] = convert_encoder(sd, "code_encoder.",
                                                 cfg.code_encoder)
        vq_tree["code_vq"] = convert_bottleneck_vars(sd, "code_vq.", 1)
    else:
        params["emb_c"] = {"weight": _np(sd["emb_c.weight"])}
    if cfg.f0_quantizer is not None:
        params["emb_p"] = {"weight": _np(sd["emb_p.weight"])}
        params["fo_vqvae"], vq_tree["fo_vqvae"] = _fo_vqvae_trees(
            sd, cfg.f0_quantizer, "fo_vqvae.")
    if cfg.multispkr and not cfg.external_speaker_emb:
        params["emb_s"] = {"weight": _np(sd["emb_s.weight"])}
    return codegen_from_jax(cfg, params, vq_tree, device=device)


def load_fo_vqvae_checkpoint(path, cfg: FoVQVAEConfig,
                             device=None) -> FoVQVAE:
    """A reference f0-VQ-VAE `g_*` file → FoVQVAE on `device`."""
    device = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return convert_fo_vqvae(ckpt["generator"], cfg, device=device)


def load_f0vq_training_checkpoint(directory, cfg: FoVQVAEConfig,
                                  device=None) -> FoVQVAE:
    """The newest `g_*` that train_f0vq wrote under `directory` →
    FoVQVAE (parameters and every codebook buffer) on `device`, frozen."""
    device = resolve_device(device)
    got = Checkpointer(directory).restore("g_")
    if got is None:
        raise FileNotFoundError(f"no g_ checkpoint under {directory}")
    model = FoVQVAE(cfg)
    model.load_state_dict({**got["params"], **got["vq"]})
    return model.requires_grad_(False).to(device)


def load_f0_quantizer(path, codegen: CodeGenerator) -> CodeGenerator:
    """`codegen`'s pitch quantizer from `path`: a reference f0-VQ-VAE
    `g_*` file, or a directory that train_f0vq wrote (its newest `g_`),
    the JAX package's `train_da --f0-quantizer` branches. The quantizer
    stays frozen, on `codegen`'s device."""
    cfg = codegen.cfg.f0_quantizer
    device = next(codegen.fo_vqvae.parameters()).device
    fo = (load_fo_vqvae_checkpoint(path, cfg, device=device)
          if Path(path).is_file()
          else load_f0vq_training_checkpoint(path, cfg, device=device))
    codegen.fo_vqvae.load_state_dict(fo.state_dict())
    return codegen


def load_code_generator_checkpoint(path, cfg: CodeGeneratorConfig,
                                   device=None) -> CodeGenerator:
    """A reference CodeGenerator `g_*` file → CodeGenerator on
    `device`."""
    device = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return convert_code_generator(ckpt["generator"], cfg, device=device)
