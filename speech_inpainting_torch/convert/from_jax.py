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

The trainers take another form: float32 parameters that require grad,
weight norm's (g, v) kept apart. `trainable_hubert` builds the HuBERT
trainer's model; `hubert_tree` reads such a model (or its gradients, or an
optimizer's moments) back into the JAX package's tree, and
`inference_hubert` folds it into the inference form the loaders above
build. For the GAN trainer, `trainable_generator`, `mpd_from_jax` and
`msd_from_jax` build the weight-normed generator and the discriminators
(the MSD's `spectral` collection in its u/v buffers) from flax trees, and
`generator_tree`, `mpd_tree`, `msd_tree` and `spectral_tree` read them
back. Those modules carry the reference checkpoints' names, so each tree
maps to and from a reference state dict (`reference_*_tree`,
`_state_dict_of`), which convert/hifigan_torch.py's loaders read too.
For the unit HiFi-GAN trainer, `trainable_codegen` builds a
`WNCodeGenerator` from a JAX CodeGenerator's `params` and `vq` collection
(or its fresh init), and `codegen_tree` reads one back into those trees.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.codegen import (CodeGenerator, CodeGeneratorConfig, FoVQVAE,
                              FoVQVAEConfig, WNCodeGenerator)
from ..models.hifigan import (Generator, HiFiGANConfig,
                              MultiPeriodDiscriminator,
                              MultiScaleDiscriminator, WNGenerator)
from ..models.hifigan_fast import FastGenerator
from ..models.jukebox import init_conv_stack_
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
    """A `vq` collection's levels (level_{i}/k, and where the collection
    has them the training buffers k_sum, k_elem, initted) → the
    Bottleneck's buffers of those names."""
    for name, level in vq_tree.items():
        block = getattr(bottleneck, name)
        for key, value in level.items():
            buf = getattr(block, key)
            buf.copy_(torch.as_tensor(np.asarray(value)).to(buf.dtype))


@torch.no_grad()
def fo_vqvae_from_jax(cfg: FoVQVAEConfig, params: dict, vq_tree: dict,
                      device=None) -> FoVQVAE:
    """`FoVQVAE` params (encoder, decoder) and its `vq` collection
    (vq/level_{i}/k, …) → FoVQVAE in float32 on `device`, frozen."""
    device = resolve_device(device)
    model = FoVQVAE(cfg)
    _load_plain(model, params)
    _load_codebooks(model.vq, vq_tree["vq"])
    return model.requires_grad_(False).to(device)


def trainable_fo_vqvae(cfg: FoVQVAEConfig, params: dict | None = None,
                       vq_tree: dict | None = None, *, seed: int = 0,
                       device=None) -> FoVQVAE:
    """A FoVQVAE to train on `device`: from the JAX package's params and
    `vq` collection where given, else freshly drawn from `seed` as the
    JAX package's `model.init` draws it (models/jukebox.py:init_conv_stack_)
    with an uninitialised codebook."""
    device = resolve_device(device)
    if params is None:
        model = FoVQVAE(cfg)
        gen = torch.Generator().manual_seed(seed)
        init_conv_stack_(model.encoder, cfg.encoder, gen)
        init_conv_stack_(model.decoder, cfg.decoder, gen)
        return model.to(device)
    return fo_vqvae_from_jax(cfg, params, vq_tree,
                             device=device).requires_grad_(True)


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


# ------------------------------------- the GAN trainer's modules and trees

def _np_copy(t) -> np.ndarray:
    """float32 numpy copy (never a view of a tensor a later update moves)."""
    if hasattr(t, "detach"):
        t = t.detach().float().cpu()
    return np.array(t, dtype=np.float32, copy=True)


def _wn_params(sd: dict, prefix: str) -> dict:
    """{v, g, b} of the weight-normed conv at `prefix` of a reference state
    dict, under either key style (legacy `weight_g`/`weight_v`, or
    `parametrizations.weight.original0/1`); g flattened to one magnitude
    per row of axis 0 (C_out, or C_in on a transposed conv)."""
    for g, v in (("weight_g", "weight_v"),
                 ("parametrizations.weight.original0",
                  "parametrizations.weight.original1")):
        if f"{prefix}.{g}" in sd:
            return {"v": _np_copy(sd[f"{prefix}.{v}"]),
                    "g": _np_copy(sd[f"{prefix}.{g}"]).reshape(-1),
                    "b": _np_copy(sd[f"{prefix}.bias"])}
    raise KeyError(f"no weight-norm params under '{prefix}'")


def _sn_params(sd: dict, prefix: str) -> tuple:
    """({w, b}, {u, v}) of the spectral-normed conv at `prefix` (legacy
    `weight_orig`/`weight_u`/`weight_v`, or the parametrizations API's
    `original`/`_u`/`_v`); the u/v dict is empty where `sd` has none (a
    tree of gradients)."""
    for w, u, v in (("weight_orig", "weight_u", "weight_v"),
                    ("parametrizations.weight.original",
                     "parametrizations.weight._u",
                     "parametrizations.weight._v")):
        if f"{prefix}.{w}" in sd:
            uv = ({"u": _np_copy(sd[f"{prefix}.{u}"]),
                   "v": _np_copy(sd[f"{prefix}.{v}"])}
                  if f"{prefix}.{u}" in sd else {})
            return ({"w": _np_copy(sd[f"{prefix}.{w}"]),
                     "b": _np_copy(sd[f"{prefix}.bias"])}, uv)
    raise KeyError(f"no spectral-norm params under '{prefix}'")


def _generator_convs(cfg: HiFiGANConfig):
    """(flax path, reference prefix) of every conv of the generator."""
    nk = len(cfg.resblock_kernel_sizes)
    convs = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
    out = [(("conv_pre",), "conv_pre"), (("conv_post",), "conv_post")]
    for i in range(len(cfg.upsample_rates)):
        out.append(((f"ups_{i}",), f"ups.{i}"))
        for j, rd in enumerate(cfg.resblock_dilation_sizes):
            out += [((f"resblocks_{i}_{j}", f"{c}_{s}"),
                     f"resblocks.{i * nk + j}.{c}.{s}")
                    for c in convs for s in range(len(rd))]
    return out


def _disc_convs(n: int, n_convs: int):
    """(flax path, reference prefix, discriminator index) of every conv of
    an MPD (n periods, 5 convs each) or an MSD (n scales, 7)."""
    return [((f"discriminators_{i}", name), f"discriminators.{i}.{ref}", i)
            for i in range(n)
            for name, ref in [(f"convs_{j}", f"convs.{j}")
                              for j in range(n_convs)]
            + [("conv_post", "conv_post")]]


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def reference_generator_tree(sd: dict, cfg: HiFiGANConfig) -> dict:
    """Generator state dict (reference layout) → the JAX `Generator` tree."""
    tree = {}
    for path, prefix in _generator_convs(cfg):
        _put(tree, path, _wn_params(sd, prefix))
    return tree


def _n_discs(sd: dict) -> int:
    return len({k.split(".")[1] for k in sd if k.startswith("discriminators.")})


def reference_mpd_tree(sd: dict) -> dict:
    """MultiPeriodDiscriminator state dict → the flax params tree."""
    tree = {}
    for path, prefix, _ in _disc_convs(_n_discs(sd), 5):
        _put(tree, path, _wn_params(sd, prefix))
    return tree


def reference_msd_tree(sd: dict) -> tuple:
    """MultiScaleDiscriminator state dict → (params, spectral) trees, the
    spectral-normed scale 0's u/v under `spectral` (empty where `sd` holds
    no u/v)."""
    tree, spectral = {}, {}
    for path, prefix, i in _disc_convs(_n_discs(sd), 7):
        if i == 0:
            p, uv = _sn_params(sd, prefix)
            if uv:
                _put(spectral, path, uv)
        else:
            p = _wn_params(sd, prefix)
        _put(tree, path, p)
    return tree, spectral


def _wn_entries(prefix: str, p: dict) -> dict:
    v = _t(p["v"])
    return {f"{prefix}.weight_g": _t(p["g"]).reshape(
                (-1,) + (1,) * (v.ndim - 1)),
            f"{prefix}.weight_v": v, f"{prefix}.bias": _t(p["b"])}


def _state_dict_of(module: nn.Module, params: dict,
                   spectral: dict | None = None) -> dict:
    """A flax tree (and a `spectral` collection) → `module`'s state dict:
    the module's own names say where each leaf goes."""
    if isinstance(module, WNGenerator):
        convs = [(p, r, None) for p, r in _generator_convs(module.cfg)]
    else:
        n_convs = 5 if isinstance(module, MultiPeriodDiscriminator) else 7
        convs = _disc_convs(len(module.discriminators), n_convs)
    sd = {}
    for path, prefix, i in convs:
        p = _get(params, path)
        if "w" in p:                                # spectral norm
            uv = _get(spectral, path)
            sd.update({f"{prefix}.weight_orig": _t(p["w"]),
                       f"{prefix}.bias": _t(p["b"]),
                       f"{prefix}.weight_u": _t(uv["u"]),
                       f"{prefix}.weight_v": _t(uv["v"])})
        else:
            sd.update(_wn_entries(prefix, p))
    return sd


def _loaded(module: nn.Module, params: dict, spectral=None, device=None
            ) -> nn.Module:
    module.load_state_dict(_state_dict_of(module, params, spectral))
    return module.to(device)


def trainable_generator(cfg: HiFiGANConfig, params: dict | None = None,
                        device=None,
                        generator: torch.Generator | None = None
                        ) -> WNGenerator:
    """The GAN trainer's `WNGenerator` on `device`: float32 parameters
    requiring grad, (g, v) apart, compute in cfg.dtype. Its values come
    from `params` (a JAX `Generator` tree) or, where None, from the JAX
    package's inits drawn with `generator`."""
    device = resolve_device(device)
    module = WNGenerator(cfg, generator=generator)
    if params is None:
        return module.to(device)
    return _loaded(module, params, device=device)


def mpd_from_jax(params: dict | None = None, periods=(2, 3, 5, 7, 11),
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None
                 ) -> MultiPeriodDiscriminator:
    """`MultiPeriodDiscriminator` tree (discriminators_{i}/convs_{j},
    conv_post, each {v, g, b}) → the module on `device`, computing in
    `dtype`; a fresh init from `generator` where `params` is None."""
    device = resolve_device(device)
    module = MultiPeriodDiscriminator(periods, dtype=dtype,
                                      generator=generator)
    if params is None:
        return module.to(device)
    return _loaded(module, params, device=device)


def msd_from_jax(params: dict | None = None, spectral: dict | None = None,
                 scales: int = 3, dtype: torch.dtype = torch.float32,
                 device=None, generator: torch.Generator | None = None
                 ) -> MultiScaleDiscriminator:
    """`MultiScaleDiscriminator` params (scale 0's convs {w, b}, the others
    {v, g, b}) and its `spectral` collection (scale 0's {u, v}) → the
    module on `device`, computing in `dtype`."""
    device = resolve_device(device)
    module = MultiScaleDiscriminator(scales, dtype=dtype, generator=generator)
    if params is None:
        return module.to(device)
    return _loaded(module, params, spectral, device=device)


def _named(module: nn.Module, of) -> dict:
    return {n: of(p) for n, p in module.named_parameters()}


def generator_tree(module: WNGenerator, of=lambda p: p) -> dict:
    """`module`'s JAX `Generator` tree, numpy float32 (g flattened): of its
    parameters, or of `of(p)` for each parameter p (its `.grad`, an
    optimizer's moment of it)."""
    return reference_generator_tree(_named(module, of), module.cfg)


def mpd_tree(module: MultiPeriodDiscriminator, of=lambda p: p) -> dict:
    """`module`'s flax params tree, as `generator_tree`."""
    return reference_mpd_tree(_named(module, of))


def msd_tree(module: MultiScaleDiscriminator, of=lambda p: p) -> dict:
    """`module`'s flax params tree (without the spectral state)."""
    return reference_msd_tree(_named(module, of))[0]


def spectral_tree(module: MultiScaleDiscriminator) -> dict:
    """The `spectral` collection: scale 0's stored u and v."""
    return reference_msd_tree(module.state_dict())[1]


# ------------------------------------ the unit HiFi-GAN trainer's module

@torch.no_grad()
def trainable_codegen(cfg: CodeGeneratorConfig, params: dict | None = None,
                      vq_tree: dict | None = None, *, seed: int = 0,
                      device=None) -> WNCodeGenerator:
    """The unit HiFi-GAN trainer's `WNCodeGenerator` on `device`, as
    `trainable_generator` and `trainable_fo_vqvae` build theirs: a JAX
    CodeGenerator's `params` (emb_c or code_encoder, emb_p, emb_s,
    fo_vqvae, generator) and `vq` collection (code_vq/level_0,
    fo_vqvae/vq/level_{i}: k and, where the collection has them, k_sum,
    k_elem, initted) where given, else the fresh init drawn from `seed`
    (models/codegen.py); the pitch quantizer frozen either way."""
    device = resolve_device(device)
    model = WNCodeGenerator(cfg, torch.Generator().manual_seed(seed))
    if params is not None:
        _load_plain(model, {k: v for k, v in params.items()
                            if k != "generator"})
        model.generator.load_state_dict(
            _state_dict_of(model.generator, params["generator"]))
    if vq_tree is not None:
        if cfg.content_vq:
            _load_codebooks(model.code_vq, vq_tree["code_vq"])
        if cfg.use_f0:
            _load_codebooks(model.fo_vqvae.vq, vq_tree["fo_vqvae"]["vq"])
    return model.to(device)


def _plain_tree(module: nn.Module, of) -> dict:
    """`module`'s torch-layout convs ({w, b}) and tables ({weight}) as a
    tree under their module names, of `of(p)` for each parameter p; a leaf
    whose `of` is None is left out."""
    tree = {}
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            leaf = {"w": of(m.weight), "b": of(m.bias)}
        elif isinstance(m, nn.Embedding):
            leaf = {"weight": of(m.weight)}
        else:
            continue
        leaf = {k: _np_copy(v) for k, v in leaf.items() if v is not None}
        if leaf and name:
            _put(tree, tuple(name.split(".")), leaf)
        elif leaf:                          # `module` is the leaf itself
            tree.update(leaf)
    return tree


def _codebook_tree(bottleneck: nn.Module) -> dict:
    return {name: {k: np.array(b.detach().cpu().numpy(), copy=True)
                   for k, b in block.named_buffers()}
            for name, block in bottleneck.named_children()}


def codegen_tree(module: WNCodeGenerator, of=lambda p: p) -> tuple:
    """(params, vq) of `module` as the JAX CodeGenerator's trees, numpy:
    the parameters, or `of(p)` for each parameter p (its `.grad`, an
    optimizer's moment; None leaves a leaf out, as for the frozen pitch
    quantizer's moments), and the `vq` collection of its codebook buffers.
    The pitch quantizer appears with its encoder only: the CodeGenerator
    never calls its decoder, so JAX's `init` makes none."""
    params = {name: _plain_tree(child, of)
              for name, child in module.named_children()
              if name not in ("generator", "fo_vqvae", "code_vq")}
    vq = {}
    if module.cfg.content_vq:
        vq["code_vq"] = _codebook_tree(module.code_vq)
    if module.cfg.use_f0:
        enc = _plain_tree(module.fo_vqvae.encoder, of)
        if enc:
            params["fo_vqvae"] = {"encoder": enc}
        vq["fo_vqvae"] = {"vq": _codebook_tree(module.fo_vqvae.vq)}
    params = {k: v for k, v in params.items() if v}
    params["generator"] = generator_tree(module.generator, of)
    return params, vq
