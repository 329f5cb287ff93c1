"""HuBERT encoder with the I_ea prediction head, base and large.

Counterpart of speech_inpainting_tpu/models/hubert.py: a 7-layer strided
conv feature encoder (exact GELU), LayerNorm and projection, a grouped conv
positional embedding and a transformer; the head is LayerNorm + Linear to
the codebook width. Two arrangements, as the JAX package has them:
  - base (`feat_extract_norm="group"`): bias-free convs with GroupNorm(C, C)
    after conv 0 only, a LayerNorm before the post-LN layers;
  - large (`feat_extract_norm="layer"`, `do_stable_layer_norm`): conv
    biases and a LayerNorm over channels after every conv, pre-LN layers,
    and the LayerNorm after the last layer (not after a tapped one).
Inputs and outputs keep the JAX layout: wav (B, T) → (B, frames, D).

`cfg.dtype` plays flax's `dtype`: the convs and the transformer's dense
layers compute in it, while the norms, the softmax and the head stay in
float32. The residual stream is float32 in base, which normalises it
before the layers, and `cfg.dtype` in large, as flax leaves it there.
Parameters and compute have separate types, as flax's `param_dtype` and
`dtype`: each conv and dense weight is cast to `cfg.dtype` per call. The
inference loaders store them in `cfg.dtype` already (the casts are then
no-ops); a trainable model keeps float32 parameters, and its positional
conv keeps weight norm's (g, v) apart (`weight_norm=True`), the weight
computed from them per call.

`cfg.int8` (serving only) runs the transformer's dense layers through
int8 codes (ops/int8.py), with the same parameters.
`extract_features_chunked` runs a long recording in pieces.

`attention_mask` (B, samples), 1 on real samples, masks as flax does: the
projected features past each utterance's frame count are zeroed before
the positional conv, and padded keys are left out of every softmax.
`init_flax_` draws a fresh model from flax's initialisers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import cast, full_f32, resolve_device, stage


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"      # "group" (base) | "layer" (large)
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    do_stable_layer_norm: bool = False   # pre-LN layers (large)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    feat_proj_layer_norm: bool = True
    dtype: torch.dtype = torch.float32
    # serving only: the transformer's dense layers (q/k/v/out, the MLP) as
    # ops/int8.py's dynamic W8A8 `Int8Linear`, with the same parameters
    # (dataclasses.replace(cfg, int8=True) on an existing config)
    int8: bool = False

    @staticmethod
    def base(**over) -> "HubertConfig":
        return HubertConfig(**over)

    @staticmethod
    def large(**over) -> "HubertConfig":
        d = dict(conv_bias=True, feat_extract_norm="layer", hidden_size=1024,
                 num_hidden_layers=24, num_attention_heads=16,
                 intermediate_size=4096, do_stable_layer_norm=True)
        d.update(over)
        return HubertConfig(**d)

    @staticmethod
    def from_hf(c: dict) -> "HubertConfig":
        """The fields of an HF `config.json` (transformers' HubertConfig
        as a dict), `feat_proj_layer_norm` true where it is absent."""
        return HubertConfig(
            conv_dim=tuple(c["conv_dim"]), conv_stride=tuple(c["conv_stride"]),
            conv_kernel=tuple(c["conv_kernel"]), conv_bias=c["conv_bias"],
            feat_extract_norm=c["feat_extract_norm"],
            hidden_size=c["hidden_size"],
            num_hidden_layers=c["num_hidden_layers"],
            num_attention_heads=c["num_attention_heads"],
            intermediate_size=c["intermediate_size"],
            do_stable_layer_norm=c["do_stable_layer_norm"],
            num_conv_pos_embeddings=c["num_conv_pos_embeddings"],
            num_conv_pos_embedding_groups=c["num_conv_pos_embedding_groups"],
            layer_norm_eps=c["layer_norm_eps"],
            feat_proj_layer_norm=c.get("feat_proj_layer_norm", True))

    def feature_lengths(self, sample_lengths):
        """Conv-stack output lengths for waveform lengths (HF's formula)."""
        n = sample_lengths
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


def _f32(dtype: torch.dtype) -> torch.dtype:
    """The type of the float32 parts: float32, or float64 for a float64
    model (a reference computed wholly in float64). Decided in Python:
    `torch.promote_types` would be a node of an exported program."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in float32 whatever the input's type (float64 for
    a float64 input)."""

    def forward(self, x):
        dt = _f32(x.dtype)
        return F.layer_norm(cast(x, dt), self.normalized_shape,
                            cast(self.weight, dt), cast(self.bias, dt),
                            self.eps)


class Dense(nn.Linear):
    """Linear that computes in `dtype` whatever its weights' type, as
    flax's Dense(dtype, param_dtype)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype):
        super().__init__(n_in, n_out)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight, dt),
                        cast(self.bias, dt))


def _dense(cfg: HubertConfig, n_in: int, n_out: int) -> Dense:
    """A transformer dense layer: `Dense`, or its int8 form where cfg.int8
    (the same parameters)."""
    if cfg.int8:
        from ..ops.int8 import Int8Linear
        return Int8Linear(n_in, n_out, cfg.dtype)
    return Dense(n_in, n_out, cfg.dtype)


class FeatureEncoder(nn.Module):
    """Strided conv stack over the waveform: (B, T) → (B, frames, C).
    `norms` holds the flax names: `norm_0`, a GroupNorm, for "group";
    `norm_0` … `norm_6`, LayerNorms over channels, for "layer"."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.compute_dtype = cfg.dtype
        chans = (1,) + tuple(cfg.conv_dim)
        self.convs = nn.ModuleList(
            nn.Conv1d(chans[i], chans[i + 1], k, stride=s, bias=cfg.conv_bias)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))
        self.layer_norms = cfg.feat_extract_norm == "layer"
        if self.layer_norms:
            self.norms = nn.ModuleDict({
                f"norm_{i}": LayerNorm32(c, eps=cfg.layer_norm_eps)
                for i, c in enumerate(cfg.conv_dim)})
        else:
            self.norms = nn.ModuleDict({"norm_0": nn.GroupNorm(
                cfg.conv_dim[0], cfg.conv_dim[0], eps=cfg.layer_norm_eps)})

    def forward(self, wav):
        dt = self.compute_dtype
        x = cast(wav[:, None, :], dt)
        for i, conv in enumerate(self.convs):
            x = F.conv1d(x, cast(conv.weight, dt),
                         None if conv.bias is None else cast(conv.bias, dt),
                         stride=conv.stride)
            n = self.norms[f"norm_{i}"] if f"norm_{i}" in self.norms else None
            if self.layer_norms:  # over channels, in f32
                x = cast(n(x.transpose(1, 2)).transpose(1, 2), x.dtype)
            elif n is not None:  # GroupNorm(C, C): per channel over time
                f = _f32(x.dtype)
                x = cast(F.group_norm(cast(x, f), n.num_groups,
                                      cast(n.weight, f), cast(n.bias, f),
                                      n.eps), x.dtype)
            x = F.gelu(x)
        return x.transpose(1, 2)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv relative positional embedding with weight norm (dim=2,
    one magnitude per tap). The inference loaders fold it into
    `conv.weight`; with `weight_norm` the conv keeps (g, v) as torch's
    weight-norm parametrization (`parametrizations.weight.original0` g,
    (1, 1, K), and `original1` v) and computes the weight per call."""

    def __init__(self, cfg: HubertConfig, weight_norm: bool = False):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.compute_dtype = cfg.dtype
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                              padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        if weight_norm:
            nn.utils.parametrizations.weight_norm(self.conv, dim=2)
        self.drop_last = k % 2 == 0  # HF's SamePadLayer

    def forward(self, x):  # (B, T, H)
        dt, conv = self.compute_dtype, self.conv
        out = F.conv1d(cast(x.transpose(1, 2), dt), cast(conv.weight, dt),
                       cast(conv.bias, dt), padding=conv.padding,
                       groups=conv.groups)
        if self.drop_last:
            out = out[:, :, :-1]
        return F.gelu(out).transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = h // cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            _dense(cfg, h, h) for _ in range(4))

    def forward(self, x, key_mask=None):
        """`key_mask` (B, 1, 1, T) bool, True on the keys to attend. The
        heads are counted from the projections' width: under tensor
        parallelism (parallel/tp.py) a rank's q/k/v hold num_heads / tp
        whole heads, and out_proj takes that rank's share of the width."""
        B, T, _ = x.shape
        heads = lambda t: t.reshape(B, T, -1, self.head_dim).transpose(1, 2)
        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(
            self.v_proj(x))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, -1))


class FeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.intermediate_dense = _dense(cfg, cfg.hidden_size,
                                         cfg.intermediate_size)
        self.output_dense = _dense(cfg, cfg.intermediate_size,
                                   cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Transformer layer: post-LN (base) or pre-LN (large, `pre_ln`)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.pre_ln = cfg.do_stable_layer_norm
        self.attention = SelfAttention(cfg)
        self.layer_norm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = LayerNorm32(cfg.hidden_size,
                                            eps=cfg.layer_norm_eps)

    def forward(self, x, key_mask=None):
        if self.pre_ln:
            x = x + self.attention(self.layer_norm(x), key_mask)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, key_mask))
        return self.final_layer_norm(x + self.feed_forward(x))


class HubertModel(nn.Module):
    """Waveform (B, T) → frame embeddings (B, frames, hidden).

    `tap_layer` N returns the hidden states after N transformer layers (the
    fairseq `output_layer=N` convention), None the output of them all.
    `encoder_layer_norm` runs before the layers in base (post-LN) and after
    the last one in large (pre-LN), there only when `tap_layer` is None: a
    tapped large model applies no LayerNorm at the tap.
    """

    def __init__(self, cfg: HubertConfig, weight_norm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.pre_ln = cfg.do_stable_layer_norm
        self.feature_extractor = FeatureEncoder(cfg)
        self.fp_layer_norm = (LayerNorm32(cfg.conv_dim[-1],
                                          eps=cfg.layer_norm_eps)
                              if cfg.feat_proj_layer_norm else nn.Identity())
        self.fp_projection = Dense(cfg.conv_dim[-1], cfg.hidden_size,
                                   cfg.dtype)
        self.pos_conv_embed = PositionalConvEmbedding(cfg, weight_norm)
        self.encoder_layer_norm = LayerNorm32(cfg.hidden_size,
                                              eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, wav, attention_mask=None, tap_layer: int | None = None):
        x = self.fp_projection(self.fp_layer_norm(self.feature_extractor(wav)))
        key_mask = None
        if attention_mask is not None:
            frames = self.cfg.feature_lengths(attention_mask.sum(-1))
            valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                     < frames[:, None])
            x = x.masked_fill(~valid[:, :, None], 0.0)
            # a boolean mask: the same softmax as flax's finfo.min bias on
            # padded keys, since every row keeps its valid keys
            key_mask = valid[:, None, None, :]
        x = x + self.pos_conv_embed(x)
        if not self.pre_ln:
            x = self.encoder_layer_norm(x)
        for layer in self.layers[:tap_layer]:
            x = layer(x, key_mask)
        if self.pre_ln and tap_layer is None:
            x = self.encoder_layer_norm(x)
        return x


def extract_features_chunked(model: HubertModel, wav, *,
                             tap_layer: int | None = None,
                             chunk: int = 1_600_000, device=None):
    """Frame features of audio of any length: `chunk`-sample pieces run
    through `model` one at a time and concatenated, the reference feature
    reader's long-audio strategy (I_da/src/hubert_feature_reader.py, 100 s
    chunks; the joins are not smoothed there either). A piece too short
    for one frame ends the loop.

    wav (T,) array or tensor → (frames, hidden) float32 numpy array;
    (0, hidden) where no piece makes a frame. Runs on `device` (the card
    unless "cpu" is passed), where the model must lie, in full float32.
    """
    device = resolve_device(device)
    with torch.inference_mode(), full_f32():
        wav = torch.as_tensor(wav, dtype=torch.float32).reshape(-1)
        outs = []
        for start in range(0, wav.shape[0], chunk):
            piece = wav[start:start + chunk]
            if model.cfg.feature_lengths(piece.shape[0]) < 1:
                break
            feats = model(stage(piece[None], torch.float32, device),
                          tap_layer=tap_layer)
            outs.append(feats[0].float().cpu().numpy())
    if not outs:
        return np.zeros((0, model.cfg.hidden_size), np.float32)
    return np.concatenate(outs, axis=0)


class PredictionHead(nn.Module):
    """I_ea head: LayerNorm + Linear → codebook width, in float32 (`dtype`
    float64 for a float64 model)."""

    def __init__(self, hidden: int, out_dim: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_norm = LayerNorm32(hidden, eps=eps)
        self.linear = Dense(hidden, out_dim, dtype)

    def forward(self, x):
        return self.linear(self.layer_norm(x))


class EncoderWithHead(nn.Module):
    """I_ea CustomModel: HuBERT encoder + LayerNorm/Linear head.
    `weight_norm` keeps the positional conv's (g, v) apart (the trainable
    form, `convert.from_jax.trainable_hubert`)."""

    def __init__(self, cfg: HubertConfig, out_dim: int = 80,
                 weight_norm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.hubert = HubertModel(cfg, weight_norm)
        self.head = PredictionHead(cfg.hidden_size, out_dim,
                                   cfg.layer_norm_eps, _f32(cfg.dtype))

    def forward(self, wav, attention_mask=None):
        return self.head(self.hubert(wav, attention_mask))


def _flax_normal_(w: torch.Tensor, shape, scale: float,
                  gen: torch.Generator) -> None:
    """flax's variance_scaling(scale, "fan_in", "truncated_normal") for a
    weight of flax's `shape` (the axis before the last is the input, those
    before it the receptive field, as flax counts them), written into `w`
    of the same size in the port's layout: a normal truncated at ±2 and
    scaled so that its std is √(scale / fan_in)."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(scale / fan_in) / .87962566103423978
    with torch.no_grad():
        t = torch.empty(shape)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t *= std
        w.copy_(t.T if len(shape) == 2 else t)


@torch.no_grad()
def init_flax_(model: EncoderWithHead, gen: torch.Generator
               ) -> EncoderWithHead:
    """Draw `model`'s parameters from flax's initialisers, as the JAX
    package's `EncoderWithHead.init` does (the values differ: the stream is
    `gen`'s, not jax.random's): dense kernels lecun_normal, convs
    he_normal over flax's (C_out, C_in, K) shapes, the positional conv's
    v he_normal and g = ‖v‖ per tap, biases zero, norms one and zero."""
    hub = model.hubert
    for conv in hub.feature_extractor.convs:
        _flax_normal_(conv.weight, tuple(conv.weight.shape), 2.0, gen)
        if conv.bias is not None:
            conv.bias.zero_()
    pc = hub.pos_conv_embed.conv
    v = torch.empty(pc.weight.shape)
    _flax_normal_(v, tuple(v.shape), 2.0, gen)
    if nn.utils.parametrize.is_parametrized(pc, "weight"):
        pc.parametrizations.weight.original0.copy_(
            torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True)))
        pc.parametrizations.weight.original1.copy_(v)
    else:  # g = ‖v‖ folds to w = v
        pc.weight.copy_(v)
    pc.bias.zero_()
    for m in model.modules():
        if isinstance(m, Dense):
            _flax_normal_(m.weight, (m.in_features, m.out_features), 1.0,
                          gen)
            m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model
