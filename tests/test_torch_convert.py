"""The port's loaders of reference checkpoints against the JAX package's
converters, on the CPU in float32, at tiny shapes.

A reference-layout state dict (speech_inpainting_torch/testing.py's
generators, random, built in memory) goes through the JAX converter into
flax and through the port's loader into torch, and the two forwards are
compared:
  - the I_ea `CustomModel` (HF `HubertModel` keys under `base_model.`, the
    head as `final_layers.{0,1}`), base and large, at the shapes of a tiny
    `transformers.HubertConfig` (hidden 64, 2 layers, conv_dim 32,
    positional conv 16 wide in 4 groups), both key styles of the
    positional conv's weight norm: atol 1e-4 on outputs of LayerNorm
    scale;
  - a V1-shaped `g_*` generator state dict (legacy `weight_g`/`weight_v`,
    and the parametrizations key style), straight and through a `g_*`
    file on disk, and a V3 (ResBlock2) one: atol 1e-4 on the waveform,
    the generator tests' tolerance;
  - fairseq `HubertModel` state dicts (base and large) and local HF
    checkpoint directories (config.json + pytorch_model.bin, also with a
    `HubertForCTC` file's `hubert.` prefix, and without the projection's
    LayerNorm), the config read as JAX's `HubertConfig.from_hf` reads
    transformers' config object: atol 1e-4 at a tap.
Norms and biases are drawn at random (test_torch_hubert.py's `jitter`),
so a tensor loaded into the wrong place moves the output. The codebook
loaders (`KMeans.load_auto` of a .npy and of a joblib model) are held
against the JAX package's exactly.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.convert import hifigan_torch as jhifi
from speech_inpainting_tpu.convert import hubert_torch as jhub
from speech_inpainting_tpu.models.hifigan import Generator
from speech_inpainting_tpu.models.hifigan import HiFiGANConfig as JaxGen
from speech_inpainting_tpu.models.hubert import EncoderWithHead
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_tpu.models.hubert import HubertModel as JaxModel
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert import hifigan_torch, hubert_torch
from speech_inpainting_torch.models.hifigan import Generator as GeneratorK2
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.models.hubert import HubertConfig
from test_torch_hifigan import V3_NARROW
from test_torch_hubert import LARGE, jitter

NARROW = dict(upsample_initial_channel=32)
WN = ("weight_g", "weight_v")
PARAM = ("parametrizations.weight.original0",
         "parametrizations.weight.original1")


def _renamed(sd, old, new):
    """`sd` with the weight-norm key style `old` replaced by `new`."""
    out = {}
    for k, v in sd.items():
        for a, b in zip(old, new):
            if k.endswith("." + a):
                k = k[:-len(a)] + b
        out[k] = v
    return out


def _custom_state_dict(arrangement, rng):
    cfg = getattr(HubertConfig, arrangement)(**LARGE)
    tree = jitter(testing.hubert_tree(cfg, 80, rng), rng)
    return cfg, testing.custom_model_state_dict(tree, cfg)


def test_custom_model_state_dict_layout():
    """The keys and shapes of the reference's checkpoints: HF's
    `HubertModel` names (which the JAX converter, held against transformers
    in tests/test_hubert.py, reads) and the `final_layers` head."""
    cfg = HubertConfig.large(**LARGE)
    sd = testing.custom_model_state_dict(
        testing.hubert_tree(cfg, 80, np.random.default_rng(0)), cfg)
    p = "base_model.feature_extractor.conv_layers"
    assert sd[f"{p}.6.layer_norm.weight"].shape == (32,)
    assert sd[f"{p}.0.conv.bias"].shape == (32,)
    p = "base_model.encoder.pos_conv_embed.conv"
    assert sd[f"{p}.weight_g"].shape == (1, 1, 16)
    assert sd[f"{p}.weight_v"].shape == (64, 16, 16)
    assert sd["base_model.encoder.layers.1.feed_forward.intermediate_dense"
              ".weight"].shape == (128, 64)
    assert sd["final_layers.1.weight"].shape == (80, 64)
    assert len(sd) == 7 * 4 + 4 + 3 + 2 + 2 * 16 + 4
    base = HubertConfig.base(**LARGE)
    sd = testing.custom_model_state_dict(
        testing.hubert_tree(base, 80, np.random.default_rng(0)), base)
    assert "base_model.feature_extractor.conv_layers.1.layer_norm.weight" \
        not in sd and len(sd) == 7 + 2 + 4 + 3 + 2 + 2 * 16 + 4


@pytest.mark.parametrize("arrangement", ["base", "large"])
def test_custom_model_loader_matches_jax_converter(rng, arrangement):
    cfg, sd = _custom_state_dict(arrangement, rng)
    jcfg = getattr(JaxHub, arrangement)(**LARGE)
    wav = rng.standard_normal((2, 4000)).astype(np.float32) * 0.3
    params = jhub.convert_custom_model(sd, jcfg)
    want = np.asarray(jax.jit(EncoderWithHead(jcfg, out_dim=80).apply)(
        {"params": params}, jnp.asarray(wav)))
    port = hubert_torch.convert_custom_model(sd, cfg, device="cpu")
    with torch.no_grad():
        got = port(torch.tensor(wav)).numpy()
    assert got.shape == want.shape == (2, 12, 80)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_hf_hubert_loader_matches_jax_converter_at_a_tap(rng):
    cfg, sd = _custom_state_dict("large", rng)
    base = _renamed({k[len("base_model."):]: v for k, v in sd.items()
                     if k.startswith("base_model.")}, WN, PARAM)
    jcfg = JaxHub.large(**LARGE)
    wav = rng.standard_normal((1, 4000)).astype(np.float32) * 0.3
    want = np.asarray(jax.jit(functools.partial(
        JaxModel(jcfg).apply, tap_layer=1))(
        {"params": jhub.convert_hf_hubert(base, jcfg)}, jnp.asarray(wav)))
    port = hubert_torch.convert_hf_hubert(base, cfg, device="cpu")
    with torch.no_grad():
        got = port(torch.tensor(wav), tap_layer=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _generator_state_dict(rng):
    cfg = HiFiGANConfig(**NARROW)
    # `carry` draws zero biases: draw them at random
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if p[-1].key == "b" else a,
        testing.generator_tree(cfg, rng, carry=True))
    return testing.generator_state_dict(tree, cfg)


@pytest.mark.parametrize("style", ["legacy", "parametrizations", "file"])
def test_generator_loader_matches_jax_converter(rng, tmp_path, style):
    sd = _generator_state_dict(rng)
    assert sd["ups.0.weight_g"].shape == (32, 1, 1)      # C_in of ups.0
    assert sd["ups.0.weight_v"].shape == (32, 16, 16)
    mel = rng.standard_normal((2, 80, 9)).astype(np.float32)
    want = np.asarray(jax.jit(Generator(JaxGen(**NARROW)).apply)(
        {"params": jhifi.convert_generator(sd, JaxGen(**NARROW))},
        jnp.asarray(mel)))
    cfg = HiFiGANConfig(**NARROW)
    if style == "file":
        path = tmp_path / "g_00000001"
        torch.save({"generator": sd}, path)
        np.testing.assert_array_equal(np.asarray(jax.jit(
            Generator(JaxGen(**NARROW)).apply)(
            {"params": jhifi.load_generator_checkpoint(
                str(path), JaxGen(**NARROW))}, jnp.asarray(mel))), want)
        gen = hifigan_torch.load_generator_checkpoint(path, cfg,
                                                      device="cpu")
    else:
        if style == "parametrizations":
            sd = _renamed(sd, WN, PARAM)
        gen = hifigan_torch.convert_generator(sd, cfg, device="cpu")
    with torch.no_grad():
        got = gen(torch.tensor(mel)).numpy()
    assert got.shape == want.shape == (2, 1, 9 * 256)
    assert np.abs(want).std() > 0.05      # not a silent waveform
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_loaders_refuse_what_they_cannot_read(rng):
    sd = _generator_state_dict(rng)
    del sd["conv_pre.weight_g"]
    with pytest.raises(KeyError, match="conv_pre"):
        hifigan_torch.convert_generator(sd, HiFiGANConfig(**NARROW),
                                        device="cpu")
    # a ResBlock1 file read as V3 lacks ResBlock2's keys; a V3 file
    # converts as the JAX converter does (the K2 `Generator`, atol 1e-4)
    with pytest.raises(KeyError, match=r"resblocks\.0\.convs\.0"):
        hifigan_torch.convert_generator(_generator_state_dict(rng),
                                        HiFiGANConfig(**V3_NARROW),
                                        device="cpu")
    v3 = HiFiGANConfig(**V3_NARROW)
    sd = testing.generator_state_dict(
        testing.generator_tree(v3, rng, carry=True), v3)
    assert "resblocks.8.convs.1.weight_v" in sd and not any(
        ".convs1." in k for k in sd)
    mel = rng.standard_normal((1, 80, 5)).astype(np.float32)
    want = np.asarray(jax.jit(Generator(JaxGen(**V3_NARROW)).apply)(
        {"params": jhifi.convert_generator(sd, JaxGen(**V3_NARROW))},
        jnp.asarray(mel)))
    gen = hifigan_torch.convert_generator(sd, v3, device="cpu",
                                          cls=GeneratorK2)
    assert type(gen) is GeneratorK2
    with torch.no_grad():
        np.testing.assert_allclose(gen(torch.tensor(mel)).numpy(), want,
                                   atol=1e-4)


def test_kmeans_loaders_match_jax(tmp_path, monkeypatch):
    import types

    import joblib

    from speech_inpainting_tpu.quantize.kmeans import KMeans as JaxKMeans
    from speech_inpainting_torch.quantize.kmeans import KMeans
    C = np.random.default_rng(0).standard_normal((5, 80)).astype(np.float32)
    np.save(tmp_path / "km.npy", C)
    # a reference sklearn model is read through its `cluster_centers_`
    joblib.dump(types.SimpleNamespace(cluster_centers_=C.astype(np.float64)),
                tmp_path / "model.km")
    for name in ("km.npy", "model.km"):
        got = KMeans.load_auto(tmp_path / name)
        want = JaxKMeans.load_auto(str(tmp_path / name))
        assert isinstance(got.centroids, np.ndarray) and got.k == 5
        np.testing.assert_array_equal(got.centroids,
                                      np.asarray(want.centroids))
    monkeypatch.setitem(__import__("sys").modules, "joblib", None)
    with pytest.raises(ImportError):
        KMeans.load_auto(tmp_path / "model.km")


_FAIRSEQ = [(r"^(feature_extractor\.conv_layers\.\d+)\.conv\.", r"\1.0."),
            (r"^feature_projection\.layer_norm\.", "layer_norm."),
            (r"^feature_projection\.projection\.", "post_extract_proj."),
            (r"^encoder\.pos_conv_embed\.conv\.", "encoder.pos_conv.0."),
            (r"\.attention\.", ".self_attn."),
            (r"(layers\.\d+)\.layer_norm\.", r"\1.self_attn_layer_norm."),
            (r"\.feed_forward\.intermediate_dense\.", ".fc1."),
            (r"\.feed_forward\.output_dense\.", ".fc2.")]


def _fairseq_state_dict(hub, cfg):
    """fairseq's `HubertModel` keys for an HF state dict: the conv stack's
    norm at `.2` (GroupNorm, "group" mode) or `.2.1` (a LayerNorm between
    two TransposeLast, "layer" mode)."""
    import re
    norm = ".2.1." if cfg.feat_extract_norm == "layer" else ".2."
    out = {}
    for k, v in testing.hubert_state_dict(hub, cfg).items():
        k = re.sub(r"^(feature_extractor\.conv_layers\.\d+)\.layer_norm\.",
                   lambda m: m.group(1) + norm, k)
        for pat, rep in _FAIRSEQ:
            k = re.sub(pat, rep, k)
        out[k] = v
    return out


@pytest.mark.parametrize("arrangement", ["base", "large"])
def test_fairseq_hubert_loader_matches_jax_converter(rng, arrangement):
    cfg = getattr(HubertConfig, arrangement)(**LARGE)
    jcfg = getattr(JaxHub, arrangement)(**LARGE)
    hub = jitter(testing.hubert_model_tree(cfg, rng), rng)
    sd = _fairseq_state_dict(hub, cfg)
    assert "post_extract_proj.weight" in sd and "layer_norm.bias" in sd
    assert ("feature_extractor.conv_layers.6.2.1.weight" in sd) == (
        arrangement == "large")
    assert "encoder.layers.1.self_attn_layer_norm.weight" in sd
    wav = rng.standard_normal((1, 4000)).astype(np.float32) * 0.3
    want = np.asarray(jax.jit(functools.partial(
        JaxModel(jcfg).apply, tap_layer=1))(
        {"params": jhub.convert_fairseq_hubert(sd, jcfg)}, jnp.asarray(wav)))
    port = hubert_torch.convert_fairseq_hubert(sd, cfg, device="cpu")
    with torch.no_grad():
        got = port(torch.tensor(wav), tap_layer=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("layout", ["HubertModel", "HubertForCTC",
                                    "no_feat_proj_layer_norm"])
def test_hf_directory_loader_matches_jax(rng, tmp_path, layout):
    """A local HF checkpoint directory (config.json + pytorch_model.bin),
    read without transformers: the config as JAX's `HubertConfig.from_hf`
    reads transformers' config object, the weights as JAX's
    `convert_hf_hubert`; a `HubertForCTC` file's `hubert.` prefix is
    stripped and its other keys ignored."""
    import json
    import types
    over = dict(feat_proj_layer_norm=layout != "no_feat_proj_layer_norm")
    cfg = HubertConfig.large(**LARGE, **over)
    hub = jitter(testing.hubert_model_tree(cfg, rng), rng)
    prefix = "hubert." if layout == "HubertForCTC" else ""
    testing.write_hf_hubert(tmp_path, hub, cfg, prefix=prefix)
    conf = json.loads((tmp_path / "config.json").read_text())
    if layout == "HubertForCTC":
        sd = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
        sd["hubert.masked_spec_embed"] = torch.zeros(64)
        sd["lm_head.weight"] = torch.zeros(32, 64)
        torch.save(sd, tmp_path / "pytorch_model.bin")
    if layout == "HubertModel":        # older files lack the field
        del conf["feat_proj_layer_norm"]
        (tmp_path / "config.json").write_text(json.dumps(conf))
    got_cfg, port = hubert_torch.load_hf_pretrained(tmp_path, device="cpu")
    jcfg = JaxHub.from_hf(types.SimpleNamespace(**conf))
    for field in HubertConfig.__dataclass_fields__:
        if field != "dtype":
            assert getattr(got_cfg, field) == getattr(jcfg, field), field
    assert got_cfg == cfg
    wav = rng.standard_normal((1, 4000)).astype(np.float32) * 0.3
    want = np.asarray(jax.jit(functools.partial(
        JaxModel(jcfg).apply, tap_layer=2))(
        {"params": jhub.convert_hf_hubert(
            testing.hubert_state_dict(hub, cfg), jcfg)}, jnp.asarray(wav)))
    with torch.no_grad():
        got = port(torch.tensor(wav), tap_layer=2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_hf_directory_loader_refuses_safetensors_only(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    (tmp_path / "model.safetensors").write_bytes(b"")
    with pytest.raises(ValueError, match="safetensors"):
        hubert_torch.load_hf_pretrained(tmp_path, device="cpu")
    (tmp_path / "model.safetensors").unlink()
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        hubert_torch.load_hf_pretrained(tmp_path, device="cpu")
