"""Load reference HuBERT checkpoints (HF transformers and fairseq layouts)
into the port.

Counterpart of speech_inpainting_tpu/convert/hubert_torch.py's
`convert_hf_hubert`, `convert_custom_model`, `convert_fairseq_hubert` and
`load_hf_pretrained`: the same key maps, but the result is the port's
module, loaded through convert/from_jax.py's tree loaders, not a flax tree.
The state dict is taken as it is (torch tensors or numpy arrays), so the
port never imports `transformers`:
  - HF `HubertModel` keys (feature_extractor.conv_layers.{i}.conv/.layer_norm,
    feature_projection, encoder.pos_conv_embed.conv, encoder.layer_norm,
    encoder.layers.{i}.…), base or large;
  - the reference's I_ea `CustomModel`: the same keys under `base_model.`
    and the head as `final_layers.0` (LayerNorm) and `final_layers.1`
    (Linear);
  - a local HF checkpoint directory (`config.json` and
    `pytorch_model.bin`), read with `torch.load`, its keys under `hubert.`
    where a `HubertForCTC` checkpoint stores them, as a module or as the
    JAX package's parameter tree (`load_hf_tree`, for the trainer);
  - fairseq `HubertModel` keys (`ckpt['model']`, I_da's feature reader).
Dense weights are (out, in) in all of them; the positional conv's weight
norm (dim=2, either key style) is folded at load.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models.hubert import EncoderWithHead, HubertConfig, HubertModel
from .from_jax import hubert_from_jax, hubert_model_from_jax


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _ln(sd, prefix) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _dense(sd, prefix) -> dict:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T,
            "bias": _np(sd[f"{prefix}.bias"])}


def _pos_conv(sd, prefix) -> dict:
    """Weight-normed (dim=2) grouped conv → (conv_v, conv_g, conv_b)."""
    for g, v in (("weight_g", "weight_v"),
                 ("parametrizations.weight.original0",
                  "parametrizations.weight.original1")):
        if f"{prefix}.{g}" in sd:
            return {"conv_v": _np(sd[f"{prefix}.{v}"]),
                    "conv_g": _np(sd[f"{prefix}.{g}"]).reshape(-1),
                    "conv_b": _np(sd[f"{prefix}.bias"])}
    raise KeyError(f"no weight-norm params under '{prefix}'")


def _hf_tree(sd: dict, cfg: HubertConfig) -> dict:
    """HF `HubertModel` state dict → the JAX package's `HubertModel` tree."""
    fe = {}
    for i in range(len(cfg.conv_dim)):
        p = f"feature_extractor.conv_layers.{i}"
        fe[f"conv_{i}_w"] = _np(sd[f"{p}.conv.weight"])
        if cfg.conv_bias:
            fe[f"conv_{i}_b"] = _np(sd[f"{p}.conv.bias"])
        if f"{p}.layer_norm.weight" in sd:  # GroupNorm at 0, or every LN
            fe[f"norm_{i}"] = _ln(sd, f"{p}.layer_norm")
    tree = {"feature_extractor": fe,
            "fp_projection": _dense(sd, "feature_projection.projection"),
            "pos_conv_embed": _pos_conv(sd, "encoder.pos_conv_embed.conv"),
            "encoder_layer_norm": _ln(sd, "encoder.layer_norm")}
    if cfg.feat_proj_layer_norm:
        tree["fp_layer_norm"] = _ln(sd, "feature_projection.layer_norm")
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layers.{i}"
        tree[f"layers_{i}"] = {
            "attention": {n: _dense(sd, f"{p}.attention.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm": _ln(sd, f"{p}.layer_norm"),
            "final_layer_norm": _ln(sd, f"{p}.final_layer_norm"),
            "feed_forward": {
                n: _dense(sd, f"{p}.feed_forward.{n}")
                for n in ("intermediate_dense", "output_dense")}}
    return tree


def convert_hf_hubert(sd: dict, cfg: HubertConfig,
                      device=None) -> HubertModel:
    """HF `HubertModel` state dict → the port's HubertModel on `device`
    (the CUDA card unless "cpu" is asked for)."""
    device = resolve_device(device)
    return hubert_model_from_jax(cfg, _hf_tree(sd, cfg), device=device)


def convert_custom_model(sd: dict, cfg: HubertConfig,
                         device=None) -> EncoderWithHead:
    """I_ea `CustomModel` state dict (base_model.* + final_layers.{0,1}) →
    the port's EncoderWithHead on `device`, its head as wide as
    `final_layers.1`."""
    device = resolve_device(device)
    base = {k[len("base_model."):]: v for k, v in sd.items()
            if k.startswith("base_model.")}
    head = {"layer_norm": _ln(sd, "final_layers.0"),
            "linear": _dense(sd, "final_layers.1")}
    tree = {"hubert": _hf_tree(base, cfg), "head": head}
    return hubert_from_jax(cfg, tree, out_dim=head["linear"]["bias"].shape[0],
                           device=device)


def _fairseq_tree(sd: dict, cfg: HubertConfig) -> dict:
    """fairseq `HubertModel` state dict → the JAX package's `HubertModel`
    tree: feature_extractor.conv_layers.{i}.0 (conv), .2 (GroupNorm at 0)
    or .2.1 (a "layer"-mode LayerNorm after a TransposeLast), layer_norm
    (before the projection), post_extract_proj, encoder.pos_conv.0,
    encoder.layers.{i}.self_attn.{q,k,v,out}_proj / self_attn_layer_norm /
    fc1 / fc2 / final_layer_norm, encoder.layer_norm."""
    fe = {}
    for i in range(len(cfg.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        fe[f"conv_{i}_w"] = _np(sd[f"{base}.0.weight"])
        if cfg.conv_bias and f"{base}.0.bias" in sd:
            fe[f"conv_{i}_b"] = _np(sd[f"{base}.0.bias"])
        for norm in (f"{base}.2", f"{base}.2.1"):
            if f"{norm}.weight" in sd:
                fe[f"norm_{i}"] = _ln(sd, norm)
                break
    tree = {"feature_extractor": fe,
            "fp_projection": _dense(sd, "post_extract_proj"),
            "pos_conv_embed": _pos_conv(sd, "encoder.pos_conv.0"),
            "encoder_layer_norm": _ln(sd, "encoder.layer_norm")}
    if cfg.feat_proj_layer_norm:
        tree["fp_layer_norm"] = _ln(sd, "layer_norm")
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layers.{i}"
        tree[f"layers_{i}"] = {
            "attention": {n: _dense(sd, f"{p}.self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm": _ln(sd, f"{p}.self_attn_layer_norm"),
            "final_layer_norm": _ln(sd, f"{p}.final_layer_norm"),
            "feed_forward": {"intermediate_dense": _dense(sd, f"{p}.fc1"),
                             "output_dense": _dense(sd, f"{p}.fc2")}}
    return tree


def convert_fairseq_hubert(sd: dict, cfg: HubertConfig,
                           device=None) -> HubertModel:
    """fairseq `HubertModel` state dict (`ckpt['model']`) → the port's
    HubertModel on `device`."""
    device = resolve_device(device)
    return hubert_model_from_jax(cfg, _fairseq_tree(sd, cfg), device=device)


def load_hf_tree(path) -> tuple[HubertConfig, dict]:
    """A local HF HuBERT checkpoint directory → (HubertConfig, the JAX
    package's `HubertModel` tree, numpy float32), as the JAX package's
    `load_hf_pretrained` returns it (the trainer's `--pretrained`). Reads
    `config.json` and `pytorch_model.bin` (torch.load, weights only); keys
    under a leading `hubert.` (a `HubertForCTC` checkpoint, e.g.
    hubert-large-ls960-ft) are taken from there, and keys the model has no
    use for (`masked_spec_embed`, a CTC head) are ignored. Hub names are
    not resolved: there is no download."""
    path = Path(path)
    weights = path / "pytorch_model.bin"
    if not weights.is_file():
        if (path / "model.safetensors").is_file():
            raise ValueError(
                f"{path} holds model.safetensors only: the PyTorch port "
                "reads pytorch_model.bin (safetensors is not read)")
        raise FileNotFoundError(f"no pytorch_model.bin in {path}")
    cfg = HubertConfig.from_hf(json.loads((path / "config.json").read_text()))
    sd = torch.load(weights, map_location="cpu", weights_only=True)
    if any(k.startswith("hubert.") for k in sd):
        sd = {k[len("hubert."):]: v for k, v in sd.items()
              if k.startswith("hubert.")}
    return cfg, _hf_tree(sd, cfg)


def load_hf_pretrained(path, device=None):
    """A local HF HuBERT checkpoint directory (`load_hf_tree`) →
    (HubertConfig, the port's HubertModel in float32 on `device`)."""
    device = resolve_device(device)
    cfg, tree = load_hf_tree(path)
    return cfg, hubert_model_from_jax(cfg, tree, device=device)
