"""Load the JAX package's parameter trees into the port's modules.

A tree is a nested dict of numpy arrays under the flax module names, as the
JAX package's `init` makes it or as its pickles store it (those load with
plain `pickle`, without JAX). Two conventions change on the way:
  - flax Dense kernels are (in, out); torch Linear weights are (out, in);
  - weight norm is folded here, once: w = g·v/‖v‖ over every axis but 0 for
    the generator's convs (dim=0, also on the transposed convs, whose axis 0
    is C_in), over axes (0, 1) for HuBERT's positional conv (dim=2).
Plain torch-layout convs ({w, b}) and embedding tables ({weight}) copy across
as they are. Entry points build on the CUDA card unless `device="cpu"` is
passed.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.codegen import (CodeGenerator, CodeGeneratorConfig, FoVQVAE,
                              FoVQVAEConfig)
from ..models.hifigan import Generator, HiFiGANConfig
from ..models.hifigan_fast import FastGenerator
from ..models.hifigan_istft import ISTFTGenerator, ISTFTGeneratorConfig
from ..models.hubert import EncoderWithHead, HubertConfig, HubertModel
from ..ops.conv import weight_norm_kernel


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _fold(p: dict) -> torch.Tensor:
    return weight_norm_kernel(_t(p["v"]), _t(p["g"]))


def _load_conv(conv: nn.Module, p: dict) -> None:
    conv.weight.copy_(_fold(p))
    conv.bias.copy_(_t(p["b"]))


def _load_generator(gen: Generator, params: dict) -> None:
    """`Generator` tree (conv_pre, ups_{i}, resblocks_{i}_{j}/convs{1,2}_{s}
    for ResBlock1 or convs_{s} for ResBlock2, conv_post, each {v, g, b}) →
    `gen`, weight norm folded."""
    cfg = gen.cfg
    _load_conv(gen.conv_pre, params["conv_pre"])
    _load_conv(gen.conv_post, params["conv_post"])
    nk = len(cfg.resblock_kernel_sizes)
    names = ("1", "2") if cfg.resblock == "1" else ("",)
    for i, up in enumerate(gen.ups):
        _load_conv(up, params[f"ups_{i}"])
        for j, rd in enumerate(cfg.resblock_dilation_sizes):
            blk = params[f"resblocks_{i}_{j}"]
            dst = gen.resblocks[i * nk + j]
            for n in names:
                convs = [blk[f"convs{n}_{s}"] for s in range(len(rd))]
                dst["w" + n].copy_(torch.stack([_fold(c) for c in convs]))
                dst["b" + n].copy_(torch.stack([_t(c["b"]) for c in convs]))


@torch.no_grad()
def generator_from_jax(cfg: HiFiGANConfig, params: dict, device=None,
                       cls: type = FastGenerator) -> Generator:
    """`Generator` tree → `cls` in cfg.dtype on `device`: FastGenerator
    (ResBlock1s in K1), or `Generator` (in K2, one launch pair per step)."""
    device = resolve_device(device)
    gen = cls(cfg)
    _load_generator(gen, params)
    return gen.to(device=device, dtype=cfg.dtype)


@torch.no_grad()
def istft_generator_from_jax(cfg: ISTFTGeneratorConfig, params: dict,
                             device=None) -> ISTFTGenerator:
    """`ISTFTGenerator` tree (the `Generator` names over the trunk's stages,
    conv_post with n_fft + 2 outputs) → ISTFTGenerator (trunk ResBlock1s in
    K1) in cfg.dtype on `device`."""
    device = resolve_device(device)
    gen = ISTFTGenerator(cfg)
    _load_generator(gen, params)
    return gen.to(device=device, dtype=cfg.dtype)


def _load_dense(dense: nn.Linear, p: dict) -> None:
    dense.weight.copy_(_t(p["kernel"]).t())
    dense.bias.copy_(_t(p["bias"]))


def _load_norm(norm: nn.Module, p: dict) -> None:
    norm.weight.copy_(_t(p["scale"]))
    norm.bias.copy_(_t(p["bias"]))


def _load_hubert(enc: HubertModel, hp: dict, dtype: torch.dtype) -> None:
    """`HubertModel` tree (base or large) → `enc`; its convs and dense
    layers then in `dtype`, its norms in float32."""
    fe = hp["feature_extractor"]
    for i, conv in enumerate(enc.feature_extractor.convs):
        conv.weight.copy_(_t(fe[f"conv_{i}_w"]))
        if conv.bias is not None:
            conv.bias.copy_(_t(fe[f"conv_{i}_b"]))
    for name, norm in enc.feature_extractor.norms.items():
        _load_norm(norm, fe[name])
    if "fp_layer_norm" in hp:
        _load_norm(enc.fp_layer_norm, hp["fp_layer_norm"])
    _load_dense(enc.fp_projection, hp["fp_projection"])
    pc = hp["pos_conv_embed"]
    v = _t(pc["conv_v"])
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
    enc.pos_conv_embed.conv.weight.copy_(_t(pc["conv_g"])[None, None] * v
                                         / norm)
    enc.pos_conv_embed.conv.bias.copy_(_t(pc["conv_b"]))
    _load_norm(enc.encoder_layer_norm, hp["encoder_layer_norm"])
    for i, layer in enumerate(enc.layers):
        lp = hp[f"layers_{i}"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _load_dense(getattr(layer.attention, name), lp["attention"][name])
        _load_dense(layer.feed_forward.intermediate_dense,
                    lp["feed_forward"]["intermediate_dense"])
        _load_dense(layer.feed_forward.output_dense,
                    lp["feed_forward"]["output_dense"])
        _load_norm(layer.layer_norm, lp["layer_norm"])
        _load_norm(layer.final_layer_norm, lp["final_layer_norm"])
    for m in enc.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            m.to(dtype)


@torch.no_grad()
def hubert_from_jax(cfg: HubertConfig, params: dict, out_dim: int = 80,
                    device=None) -> EncoderWithHead:
    """`EncoderWithHead` tree (hubert/…, head/…) → EncoderWithHead on
    `device`; the encoder's convs and dense layers in cfg.dtype, its norms
    and the head in float32."""
    device = resolve_device(device)
    model = EncoderWithHead(cfg, out_dim)
    _load_hubert(model.hubert, params["hubert"], cfg.dtype)
    _load_norm(model.head.layer_norm, params["head"]["layer_norm"])
    _load_dense(model.head.linear, params["head"]["linear"])
    return model.to(device)


@torch.no_grad()
def hubert_model_from_jax(cfg: HubertConfig, params: dict,
                          device=None) -> HubertModel:
    """Headless `HubertModel` tree (feature_extractor, …, layers_{i}), as
    I_da taps it → HubertModel on `device`, with cfg.num_hidden_layers
    layers; convs and dense layers in cfg.dtype, norms in float32."""
    device = resolve_device(device)
    model = HubertModel(cfg)
    _load_hubert(model, params, cfg.dtype)
    return model.requires_grad_(False).to(device)


def _load_plain(module: nn.Module, tree: dict) -> None:
    """A tree of torch-layout convs ({w, b}) and tables ({weight}) → the
    submodules of `module` of the same names."""
    for name, sub in tree.items():
        dst = getattr(module, name)
        if "w" in sub:
            dst.weight.copy_(_t(sub["w"]))
            dst.bias.copy_(_t(sub["b"]))
        elif "weight" in sub:
            dst.weight.copy_(_t(sub["weight"]))
        else:
            _load_plain(dst, sub)


def _load_codebooks(bottleneck: nn.Module, vq_tree: dict) -> None:
    """A `vq` collection's levels (level_{i}/k) → the Bottleneck's `k`."""
    for name, level in vq_tree.items():
        getattr(bottleneck, name).k.copy_(_t(level["k"]))


@torch.no_grad()
def fo_vqvae_from_jax(cfg: FoVQVAEConfig, params: dict, vq_tree: dict,
                      device=None) -> FoVQVAE:
    """`FoVQVAE` params (encoder, decoder) and its `vq` collection
    (vq/level_{i}/k) → FoVQVAE in float32 on `device`."""
    device = resolve_device(device)
    model = FoVQVAE(cfg)
    _load_plain(model, params)
    _load_codebooks(model.vq, vq_tree["vq"])
    return model.requires_grad_(False).to(device)


@torch.no_grad()
def codegen_from_jax(cfg: CodeGeneratorConfig, params: dict, vq_tree: dict,
                     device=None) -> CodeGenerator:
    """`CodeGenerator` params (emb_c or code_encoder, emb_p, emb_s,
    fo_vqvae/encoder (and decoder, where the tree has it), generator) and
    its `vq` collection (code_vq/level_0/k, fo_vqvae/vq/level_{i}/k) →
    CodeGenerator on `device`: the generator in cfg.hifigan.dtype with
    weight norm folded, the rest in float32."""
    device = resolve_device(device)
    model = CodeGenerator(cfg)
    _load_plain(model, {k: v for k, v in params.items() if k != "generator"})
    if cfg.content_vq:
        _load_codebooks(model.code_vq, vq_tree["code_vq"])
    if cfg.use_f0:
        _load_codebooks(model.fo_vqvae.vq, vq_tree["fo_vqvae"]["vq"])
    _load_generator(model.generator, params["generator"])
    model.to(device)
    model.generator.to(cfg.hifigan.dtype)
    return model
