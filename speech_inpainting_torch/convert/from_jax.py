"""Load the JAX package's parameter trees into the port's modules.

A tree is a nested dict of numpy arrays under the flax module names, as the
JAX package's `init` makes it or as its pickles store it (those load with
plain `pickle`, without JAX). Two conventions change on the way:
  - flax Dense kernels are (in, out); torch Linear weights are (out, in);
  - weight norm is folded here, once: w = g·v/‖v‖ over every axis but 0 for
    the generator's convs (dim=0, also on the transposed convs, whose axis 0
    is C_in), over axes (0, 1) for HuBERT's positional conv (dim=2).
Entry points build on the CUDA card unless `device="cpu"` is passed.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.hifigan import HiFiGANConfig
from ..models.hifigan_fast import FastGenerator
from ..models.hubert import EncoderWithHead, HubertConfig
from ..ops.conv import weight_norm_kernel


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _fold(p: dict) -> torch.Tensor:
    return weight_norm_kernel(_t(p["v"]), _t(p["g"]))


def _load_conv(conv: nn.Module, p: dict) -> None:
    conv.weight.copy_(_fold(p))
    conv.bias.copy_(_t(p["b"]))


@torch.no_grad()
def generator_from_jax(cfg: HiFiGANConfig, params: dict,
                       device=None) -> FastGenerator:
    """`Generator` tree (conv_pre, ups_{i}, resblocks_{i}_{j}/convs{1,2}_{s},
    conv_post, each {v, g, b}) → FastGenerator in cfg.dtype on `device`."""
    device = resolve_device(device)
    gen = FastGenerator(cfg)
    _load_conv(gen.conv_pre, params["conv_pre"])
    _load_conv(gen.conv_post, params["conv_post"])
    nk = len(cfg.resblock_kernel_sizes)
    for i, up in enumerate(gen.ups):
        _load_conv(up, params[f"ups_{i}"])
        for j, rd in enumerate(cfg.resblock_dilation_sizes):
            blk = params[f"resblocks_{i}_{j}"]
            dst = gen.resblocks[i * nk + j]
            for n in ("1", "2"):
                convs = [blk[f"convs{n}_{s}"] for s in range(len(rd))]
                dst["w" + n].copy_(torch.stack([_fold(c) for c in convs]))
                dst["b" + n].copy_(torch.stack([_t(c["b"]) for c in convs]))
    return gen.to(device=device, dtype=cfg.dtype)


def _load_dense(dense: nn.Linear, p: dict) -> None:
    dense.weight.copy_(_t(p["kernel"]).t())
    dense.bias.copy_(_t(p["bias"]))


def _load_norm(norm: nn.Module, p: dict) -> None:
    norm.weight.copy_(_t(p["scale"]))
    norm.bias.copy_(_t(p["bias"]))


@torch.no_grad()
def hubert_from_jax(cfg: HubertConfig, params: dict, out_dim: int = 80,
                    device=None) -> EncoderWithHead:
    """`EncoderWithHead` tree (hubert/…, head/…) → EncoderWithHead on
    `device`; the encoder's convs and dense layers in cfg.dtype, its norms
    and the head in float32."""
    device = resolve_device(device)
    model = EncoderWithHead(cfg, out_dim)
    hp, enc = params["hubert"], model.hubert
    fe = hp["feature_extractor"]
    for i, conv in enumerate(enc.feature_extractor.convs):
        conv.weight.copy_(_t(fe[f"conv_{i}_w"]))
    _load_norm(enc.feature_extractor.norm_0, fe["norm_0"])
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
    _load_norm(model.head.layer_norm, params["head"]["layer_norm"])
    _load_dense(model.head.linear, params["head"]["linear"])
    model.to(device)
    for m in enc.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            m.to(cfg.dtype)
    return model
