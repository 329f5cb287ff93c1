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

The HuBERT trainer takes another form (`trainable_hubert`): float32
parameters that require grad, the positional conv's (g, v) kept apart;
`hubert_tree` reads such a model (or its gradients, or an optimizer's
moments) back into the JAX package's tree, and `inference_hubert` folds it
into the inference form the loaders above build.
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
from ..models.hubert import (EncoderWithHead, HubertConfig, HubertModel,
                             init_flax_)
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


def _load_hubert(enc: HubertModel, hp: dict, dtype: torch.dtype | None
                 ) -> None:
    """`HubertModel` tree (base or large) → `enc`; its convs and dense
    layers then in `dtype` (float32 where None), its norms in float32. A
    weight-normed positional conv takes (g, v) as they are; a plain one
    takes the folded weight."""
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
    pc, conv = hp["pos_conv_embed"], enc.pos_conv_embed.conv
    v, g = _t(pc["conv_v"]), _t(pc["conv_g"])[None, None]
    if nn.utils.parametrize.is_parametrized(conv, "weight"):
        conv.parametrizations.weight.original0.copy_(g)
        conv.parametrizations.weight.original1.copy_(v)
    else:
        norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
        conv.weight.copy_(g * v / norm)
    conv.bias.copy_(_t(pc["conv_b"]))
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
    if dtype is not None:
        _store_in(enc, dtype)


def _store_in(enc: HubertModel, dtype: torch.dtype) -> None:
    """Convs and dense layers stored in `dtype` (their compute type), so
    that inference pays no cast per call."""
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
    return model.requires_grad_(False).to(device)


def trainable_hubert(cfg: HubertConfig, params: dict | None = None,
                     out_dim: int = 80, device=None,
                     generator: torch.Generator | None = None
                     ) -> EncoderWithHead:
    """The trainer's EncoderWithHead on `device`: every parameter float32
    and requiring grad, the positional conv's weight norm kept as (g, v),
    each weight cast to cfg.dtype per call (flax's param_dtype/dtype
    split). Its values come from `params` (an `EncoderWithHead` tree), or,
    where None, from flax's initialisers drawn with `generator`
    (`models.hubert.init_flax_`)."""
    device = resolve_device(device)
    model = EncoderWithHead(cfg, out_dim, weight_norm=True)
    with torch.no_grad():
        if params is None:
            init_flax_(model, generator or torch.Generator())
        else:
            _load_hubert(model.hubert, params["hubert"], None)
            _load_norm(model.head.layer_norm, params["head"]["layer_norm"])
            _load_dense(model.head.linear, params["head"]["linear"])
    return model.to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def hubert_tree(model: EncoderWithHead, of=lambda p: p) -> dict:
    """`model`'s `EncoderWithHead` tree under the JAX package's names and
    layouts (dense kernels (in, out), the positional conv's conv_g (K,)
    and conv_v), numpy float32: of its parameters, or of `of(p)` for each
    parameter p (its `.grad`, an optimizer's moment of it). A folded
    positional conv has no (g, v) and no tree."""
    enc = model.hubert
    dense = lambda m: {"kernel": _np(of(m.weight)).T,  # noqa: E731
                       "bias": _np(of(m.bias))}
    norm = lambda m: {"scale": _np(of(m.weight)),  # noqa: E731
                      "bias": _np(of(m.bias))}
    fe = {}
    for i, conv in enumerate(enc.feature_extractor.convs):
        fe[f"conv_{i}_w"] = _np(of(conv.weight))
        if conv.bias is not None:
            fe[f"conv_{i}_b"] = _np(of(conv.bias))
    for name, n in enc.feature_extractor.norms.items():
        fe[name] = norm(n)
    pc = enc.pos_conv_embed.conv
    wn = pc.parametrizations.weight
    hub = {"feature_extractor": fe, "fp_projection": dense(enc.fp_projection),
           "pos_conv_embed": {"conv_g": _np(of(wn.original0)).reshape(-1),
                              "conv_v": _np(of(wn.original1)),
                              "conv_b": _np(of(pc.bias))},
           "encoder_layer_norm": norm(enc.encoder_layer_norm)}
    if isinstance(enc.fp_layer_norm, nn.LayerNorm):
        hub["fp_layer_norm"] = norm(enc.fp_layer_norm)
    for i, layer in enumerate(enc.layers):
        att, ff = layer.attention, layer.feed_forward
        hub[f"layers_{i}"] = {
            "attention": {n: dense(getattr(att, n)) for n in
                          ("q_proj", "k_proj", "v_proj", "out_proj")},
            "feed_forward": {
                "intermediate_dense": dense(ff.intermediate_dense),
                "output_dense": dense(ff.output_dense)},
            "layer_norm": norm(layer.layer_norm),
            "final_layer_norm": norm(layer.final_layer_norm)}
    return {"hubert": hub, "head": {"layer_norm": norm(model.head.layer_norm),
                                    "linear": dense(model.head.linear)}}


@torch.no_grad()
def inference_hubert(model: EncoderWithHead) -> EncoderWithHead:
    """A trainable EncoderWithHead → the inference form that
    `hubert_from_jax` builds, on the same device: weight norm folded, convs
    and dense layers stored in cfg.dtype, nothing requiring grad. `model`
    is left as it is."""
    cfg = model.cfg
    out = EncoderWithHead(cfg, model.head.linear.out_features).to(
        next(model.parameters()).device)
    sd = dict(model.state_dict())
    p = "hubert.pos_conv_embed.conv."
    sd[p + "weight"] = model.hubert.pos_conv_embed.conv.weight
    for k in ("parametrizations.weight.original0",
              "parametrizations.weight.original1"):
        sd.pop(p + k)
    out.load_state_dict(sd)
    _store_in(out.hubert, cfg.dtype)
    return out.requires_grad_(False)


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
