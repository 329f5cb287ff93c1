"""Load reference HuBERT checkpoints (HF transformers layout) into the port.

Counterpart of speech_inpainting_tpu/convert/hubert_torch.py's
`convert_hf_hubert` and `convert_custom_model`: the same key maps, but the
result is the port's module, loaded through convert/from_jax.py's tree
loaders, not a flax tree. The state dict is taken as it is (torch tensors or
numpy arrays), so the port never imports `transformers`:
  - HF `HubertModel` keys (feature_extractor.conv_layers.{i}.conv/.layer_norm,
    feature_projection, encoder.pos_conv_embed.conv, encoder.layer_norm,
    encoder.layers.{i}.…), base or large;
  - the reference's I_ea `CustomModel`: the same keys under `base_model.`
    and the head as `final_layers.0` (LayerNorm) and `final_layers.1`
    (Linear).
Dense weights are (out, in) in both layouts; the positional conv's weight
norm (dim=2, either key style) is folded at load.
"""
from __future__ import annotations

import numpy as np

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
            "fp_layer_norm": _ln(sd, "feature_projection.layer_norm"),
            "fp_projection": _dense(sd, "feature_projection.projection"),
            "pos_conv_embed": _pos_conv(sd, "encoder.pos_conv_embed.conv"),
            "encoder_layer_norm": _ln(sd, "encoder.layer_norm")}
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
