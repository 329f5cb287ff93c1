"""Random weights and synthetic audio for driving the port at any width.

Parameter trees with the JAX package's flax names and shapes, made with numpy
so that nothing here needs JAX: the scales follow the flax initialisers
(he/lecun normal, HiFi-GAN's N(0, 0.01), torch's default for the jukebox
convs), and weight-norm magnitudes g = ‖v‖. `chip_smoke.py` drives the
full-width paths with them on the card, and the parity tests hand the same
trees to the JAX package and to the port. The same weights also come in
the reference's checkpoint layouts, for the loaders of
convert/hubert_torch.py, convert/hifigan_torch.py and convert/ida_torch.py:
`hubert_state_dict` and `write_hf_hubert` (an HF directory),
`custom_model_state_dict`, `generator_state_dict`, `fo_vqvae_state_dict`
and `code_generator_state_dict`.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch


def _wn(rng, shape, std=None):
    v = rng.standard_normal(shape).astype(np.float32)
    fan_in = int(np.prod(shape[1:]))
    v *= std if std is not None else 1.0 / math.sqrt(fan_in)
    return v, np.sqrt((v * v).sum(axis=tuple(range(1, v.ndim))))


def generator_tree(cfg, rng, carry: bool = False) -> dict:
    """HiFi-GAN's init: N(0, 0.01) convs, which pass on only 3-12% of each
    stage's input, so that the biases set the waveform. `carry=True` draws
    every conv with std 1/√(inputs per output) and zero biases instead: each
    stage then passes its input on at a gain near 1, and the waveform moves
    with the features (a test that holds the conditioning needs this)."""
    def conv(shape, n_out, std=0.01, fan_in=None):
        n_in = int(np.prod(shape[1:]))
        if carry:
            v, g = _wn(rng, shape, 1.0 / math.sqrt(fan_in or n_in))
            return {"v": v, "g": g, "b": np.zeros(n_out, np.float32)}
        v, g = _wn(rng, shape, std)
        b = rng.uniform(-1, 1, n_out).astype(np.float32) / math.sqrt(n_in)
        return {"v": v, "g": g, "b": b}

    c0 = cfg.upsample_initial_channel
    tree = {"conv_pre": conv((c0, cfg.in_dim, 7), c0, std=None)}
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        ch = c0 // 2 ** (i + 1)
        # a transposed conv's output sums 2·ch·k/u products
        tree[f"ups_{i}"] = conv((2 * ch, ch, k), ch, fan_in=2 * ch * k // u)
        convs = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            tree[f"resblocks_{i}_{j}"] = {
                f"{c}_{s}": conv((ch, ch, rk), ch)
                for c in convs for s in range(len(rd))}
    # one waveform channel, or the iSTFT head's n_fft + 2 (magnitude and
    # phase) for models/hifigan_istft.py's configuration
    n_post = cfg.istft_n_fft + 2 if hasattr(cfg, "istft_n_fft") else 1
    tree["conv_post"] = conv(
        (n_post, c0 // 2 ** len(cfg.upsample_rates), 7), n_post)
    return tree


def _normal(rng, shape, fan_in, gain=1.0):
    return (rng.standard_normal(shape) * gain / math.sqrt(fan_in)
            ).astype(np.float32)


def _dense(rng, n_in, n_out):
    return {"kernel": _normal(rng, (n_in, n_out), n_in),
            "bias": np.zeros(n_out, np.float32)}


def _norm(n):
    return {"scale": np.ones(n, np.float32), "bias": np.zeros(n, np.float32)}


def hubert_model_tree(cfg, rng) -> dict:
    """The headless `HubertModel` tree (I_da taps it), base or large."""
    h = cfg.hidden_size
    fe, c_in = {}, 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        fe[f"conv_{i}_w"] = _normal(rng, (c, c_in, k), c_in * k,
                                    math.sqrt(2.0))
        if cfg.conv_bias:
            fe[f"conv_{i}_b"] = np.zeros(c, np.float32)
        if i == 0 or cfg.feat_extract_norm == "layer":
            fe[f"norm_{i}"] = _norm(c)
        c_in = c
    k, g = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    v = _normal(rng, (h, h // g, k), h // g * k, math.sqrt(2.0))
    hub = {"feature_extractor": fe,
           "fp_projection": _dense(rng, cfg.conv_dim[-1], h),
           "pos_conv_embed": {
               "conv_v": v, "conv_g": np.sqrt((v * v).sum(axis=(0, 1))),
               "conv_b": np.zeros(h, np.float32)},
           "encoder_layer_norm": _norm(h)}
    if cfg.feat_proj_layer_norm:
        hub["fp_layer_norm"] = _norm(cfg.conv_dim[-1])
    for i in range(cfg.num_hidden_layers):
        hub[f"layers_{i}"] = {
            "attention": {n: _dense(rng, h, h) for n in
                          ("q_proj", "k_proj", "v_proj", "out_proj")},
            "feed_forward": {
                "intermediate_dense": _dense(rng, h, cfg.intermediate_size),
                "output_dense": _dense(rng, cfg.intermediate_size, h)},
            "layer_norm": _norm(h), "final_layer_norm": _norm(h)}
    return hub


def hubert_tree(cfg, out_dim, rng) -> dict:
    """The I_ea `EncoderWithHead` tree: HuBERT and a LayerNorm/Linear head."""
    hub = hubert_model_tree(cfg, rng)
    h = cfg.hidden_size
    return {"hubert": hub,
            "head": {"layer_norm": _norm(h),
                     "linear": _dense(rng, h, out_dim)}}


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _ln_sd(prefix, p) -> dict:
    return {f"{prefix}.weight": _pt(p["scale"]), f"{prefix}.bias": _pt(p["bias"])}


def _dense_sd(prefix, p) -> dict:
    return {f"{prefix}.weight": _pt(p["kernel"].T),
            f"{prefix}.bias": _pt(p["bias"])}


def hubert_state_dict(hub: dict, cfg) -> dict:
    """The HF `HubertModel` state dict, in transformers' layout, of the
    weights of a `HubertModel` tree (`hubert_model_tree`): the positional
    conv's weight norm as the legacy `weight_g` (1, 1, K) and `weight_v`,
    torch tensors."""
    fe = hub["feature_extractor"]
    sd = {}
    for i in range(len(cfg.conv_dim)):
        p = f"feature_extractor.conv_layers.{i}"
        sd[f"{p}.conv.weight"] = _pt(fe[f"conv_{i}_w"])
        if f"conv_{i}_b" in fe:
            sd[f"{p}.conv.bias"] = _pt(fe[f"conv_{i}_b"])
        if f"norm_{i}" in fe:
            sd.update(_ln_sd(f"{p}.layer_norm", fe[f"norm_{i}"]))
    if "fp_layer_norm" in hub:
        sd.update(_ln_sd("feature_projection.layer_norm",
                         hub["fp_layer_norm"]))
    sd.update(_dense_sd("feature_projection.projection",
                        hub["fp_projection"]))
    pc, p = hub["pos_conv_embed"], "encoder.pos_conv_embed.conv"
    sd[f"{p}.weight_g"] = _pt(pc["conv_g"].reshape(1, 1, -1))
    sd[f"{p}.weight_v"] = _pt(pc["conv_v"])
    sd[f"{p}.bias"] = _pt(pc["conv_b"])
    sd.update(_ln_sd("encoder.layer_norm", hub["encoder_layer_norm"]))
    for i in range(cfg.num_hidden_layers):
        lp, p = hub[f"layers_{i}"], f"encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.update(_dense_sd(f"{p}.attention.{n}", lp["attention"][n]))
        for n in ("intermediate_dense", "output_dense"):
            sd.update(_dense_sd(f"{p}.feed_forward.{n}",
                                lp["feed_forward"][n]))
        sd.update(_ln_sd(f"{p}.layer_norm", lp["layer_norm"]))
        sd.update(_ln_sd(f"{p}.final_layer_norm", lp["final_layer_norm"]))
    return sd


def custom_model_state_dict(tree: dict, cfg) -> dict:
    """The I_ea `CustomModel` state dict, in the reference's layout, of the
    weights of an `EncoderWithHead` tree (`hubert_tree`): HF `HubertModel`
    keys (`hubert_state_dict`) under `base_model.` and the head as
    `final_layers.0` (LayerNorm) and `final_layers.1` (Linear), torch
    tensors."""
    sd = {f"base_model.{k}": v
          for k, v in hubert_state_dict(tree["hubert"], cfg).items()}
    sd.update(_ln_sd("final_layers.0", tree["head"]["layer_norm"]))
    sd.update(_dense_sd("final_layers.1", tree["head"]["linear"]))
    return sd


def write_hf_hubert(path, hub: dict, cfg, prefix: str = "") -> None:
    """A local HF checkpoint directory of a `HubertModel` tree:
    `config.json` (transformers' HubertConfig fields) and
    `pytorch_model.bin` (`hubert_state_dict`, keys under `prefix`, e.g.
    "hubert." as a `HubertForCTC` checkpoint stores them)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    fields = ("conv_dim", "conv_stride", "conv_kernel", "conv_bias",
              "feat_extract_norm", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "intermediate_size",
              "do_stable_layer_norm", "num_conv_pos_embeddings",
              "num_conv_pos_embedding_groups", "layer_norm_eps",
              "feat_proj_layer_norm")
    conf = {"architectures": ["HubertModel"], "model_type": "hubert",
            **{f: getattr(cfg, f) for f in fields}}
    (path / "config.json").write_text(json.dumps(conf, indent=2))
    torch.save({prefix + k: v for k, v in hubert_state_dict(hub, cfg).items()},
               path / "pytorch_model.bin")


def generator_state_dict(tree: dict, cfg) -> dict:
    """The HiFi-GAN generator state dict, in the reference's layout (the
    `generator` entry of a `g_*` file), of the weights of a `Generator`
    tree (`generator_tree`): legacy weight norm, `weight_g` (C_out, 1, 1) —
    (C_in, 1, 1) on the transposed upsamplers, whose weight is
    (C_in, C_out, K) — `weight_v` and `bias`, torch tensors."""
    nk = len(cfg.resblock_kernel_sizes)

    def wn(prefix, p):
        return {f"{prefix}.weight_g": _pt(p["g"].reshape(-1, 1, 1)),
                f"{prefix}.weight_v": _pt(p["v"]),
                f"{prefix}.bias": _pt(p["b"])}

    sd = {**wn("conv_pre", tree["conv_pre"]),
          **wn("conv_post", tree["conv_post"])}
    for i in range(len(cfg.upsample_rates)):
        sd.update(wn(f"ups.{i}", tree[f"ups_{i}"]))
        for j in range(nk):
            for name, p in tree[f"resblocks_{i}_{j}"].items():
                conv, s = name.split("_")
                sd.update(wn(f"resblocks.{i * nk + j}.{conv}.{s}", p))
    return sd


def _torch_conv(rng, c_out, c_in, k, transposed=False):
    """torch's default init (uniform ±1/√fan_in) for a Conv1d (w (O, I,
    K)) or a ConvTranspose1d (w (I, O, K), fan_in O·K)."""
    bound = 1.0 / math.sqrt((c_out if transposed else c_in) * k)
    shape = (c_in, c_out, k) if transposed else (c_out, c_in, k)
    return {"w": rng.uniform(-bound, bound, shape).astype(np.float32),
            "b": rng.uniform(-bound, bound, c_out).astype(np.float32)}


def _resnet_tree(rng, cfg) -> dict:
    n_state = int(cfg.m_conv * cfg.width)
    return {f"block_{j}": {"conv3": _torch_conv(rng, n_state, cfg.width, 3),
                           "conv1": _torch_conv(rng, cfg.width, n_state, 1)}
            for j in range(cfg.depth)}


def jukebox_tree(cfg, rng, decoder: bool = False) -> dict:
    """A jukebox `Encoder` tree (level_{l}/down_{i}_conv, down_{i}_resnet,
    proj), or with `decoder` a `Decoder` tree (level_{l}/proj,
    up_{i}_resnet, up_{i}_convt; out), at torch's default init."""
    tree, c_in = {}, cfg.input_emb_width
    for level in range(cfg.levels):
        stride = cfg.strides_t[level]
        filt = stride * 2 + (stride % 2)
        blk = {}
        if decoder:
            blk["proj"] = _torch_conv(rng, cfg.width, cfg.output_emb_width, 3)
        for i in range(cfg.downs_t[level]):
            if decoder:
                last = i == cfg.downs_t[level] - 1
                blk[f"up_{i}_resnet"] = _resnet_tree(rng, cfg)
                blk[f"up_{i}_convt"] = _torch_conv(
                    rng, cfg.output_emb_width if last else cfg.width,
                    cfg.width, filt, transposed=True)
            else:
                blk[f"down_{i}_conv"] = _torch_conv(
                    rng, cfg.width, c_in if i == 0 else cfg.width, filt)
                blk[f"down_{i}_resnet"] = _resnet_tree(rng, cfg)
        if not decoder:
            blk["proj"] = _torch_conv(rng, cfg.output_emb_width, cfg.width, 3)
        tree[f"level_{level}"] = blk
        c_in = cfg.output_emb_width
    if decoder:
        tree["out"] = _torch_conv(rng, cfg.input_emb_width,
                                  cfg.output_emb_width, 3)
    return tree


def vq_collection(rng, levels, bins, width) -> dict:
    """A `vq` collection drawn N(0, 1) (training would have filled it; a
    zero codebook sends every frame to code 0)."""
    return {f"level_{i}": {
        "k": rng.standard_normal((bins, width)).astype(np.float32),
        "k_sum": np.zeros((bins, width), np.float32),
        "k_elem": np.zeros(bins, np.float32),
        "initted": np.ones((), bool)} for i in range(levels)}


def fo_vqvae_tree(cfg, rng) -> tuple[dict, dict]:
    """The `FoVQVAE` params (encoder, decoder) and `vq` collection."""
    params = {"encoder": jukebox_tree(cfg.encoder, rng),
              "decoder": jukebox_tree(cfg.decoder, rng, decoder=True)}
    return params, {"vq": vq_collection(rng, cfg.levels, cfg.l_bins,
                                    cfg.emb_width)}


def codegen_tree(cfg, rng) -> tuple[dict, dict]:
    """The `CodeGenerator` params and `vq` collection, as the JAX package's
    init makes them (so the f0-VQ-VAE without its decoder, which the
    CodeGenerator never calls): N(0, 1) embedding tables, torch-default-
    scale jukebox convs, N(0, 1) codebooks, and the generator of
    `generator_tree(carry=True)` (the parity tests and `chip_smoke.py` hold
    the features that reach it through the waveform). In the content-VQ
    regime a content encoder and its codebook take emb_c's place."""
    def table(n, d):
        return {"weight": rng.standard_normal((n, d)).astype(np.float32)}

    vq = {}
    if cfg.content_vq:
        params = {"code_encoder": jukebox_tree(cfg.code_encoder, rng)}
        vq["code_vq"] = vq_collection(rng, 1, cfg.code_vq_bins,
                                      cfg.code_vq_width)
    else:
        params = {"emb_c": table(cfg.num_embeddings, cfg.embedding_dim)}
    if cfg.use_f0:
        q = cfg.f0_quantizer
        params["fo_vqvae"] = {"encoder": jukebox_tree(q.encoder, rng)}
        params["emb_p"] = table(q.l_bins, cfg.embedding_dim)
        vq["fo_vqvae"] = {"vq": vq_collection(rng, q.levels, q.l_bins,
                                          q.emb_width)}
    if cfg.multispkr and not cfg.external_speaker_emb:
        params["emb_s"] = table(cfg.spk_embeddings, cfg.embedding_dim)
    params["generator"] = generator_tree(cfg.hifigan, rng, carry=True)
    return params, vq


def _conv_sd(prefix, p) -> dict:
    return {f"{prefix}.weight": _pt(p["w"]), f"{prefix}.bias": _pt(p["b"])}


def _resnet_sd(prefix, tree, depth, reverse) -> dict:
    """Resnet1D's `model.{j}.model.1` (k3) and `.3` (k1) convs; a
    reversed-dilation decoder stores its blocks last to first."""
    sd = {}
    for i in range(depth):
        j = depth - 1 - i if reverse else i
        sd.update(_conv_sd(f"{prefix}.model.{j}.model.1",
                           tree[f"block_{i}"]["conv3"]))
        sd.update(_conv_sd(f"{prefix}.model.{j}.model.3",
                           tree[f"block_{i}"]["conv1"]))
    return sd


def jukebox_state_dict(prefix: str, tree: dict, cfg,
                       decoder: bool = False) -> dict:
    """The reference's jukebox Sequential layout of a `jukebox_tree`:
    encoder level `level_blocks.{l}.model.{i}.0` (strided conv), `.{i}.1`
    (Resnet1D), `.{down_t}` (proj); decoder level `model.0` (proj),
    `model.{1+i}.0` (Resnet1D), `model.{1+i}.1` (transposed conv), and
    `out`."""
    sd = {}
    for level in range(cfg.levels):
        base = f"{prefix}level_blocks.{level}.model"
        lt, d = tree[f"level_{level}"], cfg.downs_t[level]
        if decoder:
            sd.update(_conv_sd(f"{base}.0", lt["proj"]))
            for i in range(d):
                sd.update(_resnet_sd(f"{base}.{1 + i}.0", lt[f"up_{i}_resnet"],
                                     cfg.depth, cfg.reverse_decoder_dilation))
                sd.update(_conv_sd(f"{base}.{1 + i}.1", lt[f"up_{i}_convt"]))
        else:
            for i in range(d):
                sd.update(_conv_sd(f"{base}.{i}.0", lt[f"down_{i}_conv"]))
                sd.update(_resnet_sd(f"{base}.{i}.1", lt[f"down_{i}_resnet"],
                                     cfg.depth, False))
            sd.update(_conv_sd(f"{base}.{d}", lt["proj"]))
    if decoder:
        sd.update(_conv_sd(f"{prefix}out", tree["out"]))
    return sd


def fo_vqvae_state_dict(params: dict, vq: dict, cfg,
                        prefix: str = "") -> dict:
    """The reference's f0-VQ-VAE state dict (the `generator` entry of its
    `g_*` file) of `fo_vqvae_tree`'s weights: `encoder.*`, `decoder.*` and
    each level's EMA codebook `vq.level_blocks.{l}.k`, torch tensors."""
    sd = {**jukebox_state_dict(f"{prefix}encoder.", params["encoder"],
                               cfg.encoder),
          **jukebox_state_dict(f"{prefix}decoder.", params["decoder"],
                               cfg.decoder, decoder=True)}
    for name, level in vq["vq"].items():
        sd[f"{prefix}vq.level_blocks.{name.split('_')[1]}.k"] = _pt(level["k"])
    return sd


def code_generator_state_dict(params: dict, vq: dict, cfg) -> dict:
    """The reference's CodeGenerator state dict (the `generator` entry of
    its `g_*` file) of `codegen_tree`'s weights: the HiFi-GAN keys at top
    level (`generator_state_dict`), `emb_c`/`emb_p`/`emb_s.weight`,
    `fo_vqvae.*` (`fo_vqvae_state_dict`; `params["fo_vqvae"]` must then
    hold a decoder, as the reference's files do) and, in the content-VQ
    regime, `code_encoder.*` and `code_vq.level_blocks.0.k`."""
    sd = generator_state_dict(params["generator"], cfg.hifigan)
    for name in ("emb_c", "emb_p", "emb_s"):
        if name in params:
            sd[f"{name}.weight"] = _pt(params[name]["weight"])
    if cfg.content_vq:
        sd.update(jukebox_state_dict("code_encoder.", params["code_encoder"],
                                     cfg.code_encoder))
        sd["code_vq.level_blocks.0.k"] = _pt(vq["code_vq"]["level_0"]["k"])
    if cfg.use_f0:
        sd.update(fo_vqvae_state_dict(params["fo_vqvae"], vq["fo_vqvae"],
                                      cfg.f0_quantizer, prefix="fo_vqvae."))
    return sd


def synthetic_batch(rng, batch: int, seconds: float, mask_frames: int = 10):
    """Voiced-speech-like audio sampled at 22.05 and 16 kHz from one
    continuous signal per row (a few harmonics of a gliding pitch under a
    syllable-rate envelope, plus noise), and 200 ms masks at seeded 20 ms
    frame positions."""
    def render(sr, f0, glide, amps, env_hz, noise_seed):
        t = np.arange(int(round(sr * seconds))) / sr
        phase = 2 * np.pi * (f0 * t + 0.5 * glide * t * t)
        x = sum(a * np.sin((n + 1) * phase) for n, a in enumerate(amps))
        x *= 0.55 + 0.45 * np.sin(2 * np.pi * env_hz * t)
        x += 0.02 * np.random.default_rng(noise_seed).standard_normal(t.size)
        return (0.5 * x / np.abs(x).max()).astype(np.float32)

    w22, w16 = [], []
    for _ in range(batch):
        f0, glide = rng.uniform(90, 220), rng.uniform(-20, 20)
        amps = rng.uniform(0.1, 1.0, 6) / np.arange(1, 7)
        env, ns = rng.uniform(2, 6), int(rng.integers(1 << 31))
        w22.append(render(22050, f0, glide, amps, env, ns))
        w16.append(render(16000, f0, glide, amps, env, ns))
    n_frames = int(16000 * seconds) // 320
    pos = rng.integers(1, n_frames - mask_frames - 1, batch)
    return (np.stack(w22), np.stack(w16), pos.astype(np.int64),
            np.full(batch, mask_frames, np.int64))


def synthetic_utterance(rng, seconds: float, sr: int = 16000) -> np.ndarray:
    """One speech-like utterance: voiced stretches (a few harmonics of a
    gliding pitch between 100 and 220 Hz, peak 0.5) separated by silence
    with a faint noise floor, so that an f0 track has clearly voiced and
    clearly unvoiced frames."""
    n = int(round(sr * seconds))
    x = 1e-4 * rng.standard_normal(n)
    t0 = 0
    while t0 < n:
        voiced = int(sr * rng.uniform(0.25, 0.6))
        t = np.arange(min(voiced, n - t0)) / sr
        if t.size < sr // 100:   # no room left for a 10 ms stretch
            break
        f0, glide = rng.uniform(100, 220), rng.uniform(-30, 30)
        phase = 2 * np.pi * (f0 * t + 0.5 * glide * t * t)
        amps = rng.uniform(0.3, 1.0, 4) / np.arange(1, 5)
        seg = sum(a * np.sin((k + 1) * phase) for k, a in enumerate(amps))
        ramp = np.minimum(1.0, np.minimum(t, t[-1] - t) / 0.01)
        x[t0:t0 + t.size] += 0.5 * seg / np.abs(seg).max() * ramp
        t0 += t.size + int(sr * rng.uniform(0.1, 0.25))
    return x.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class NoiseLimits:
    """How many of a tensor's elements a float32 GAN step may leave
    outside both of parity_gate's gates, and how far (× its float64
    tolerance) each may lie from float64: a leaky ReLU or |·| input within
    rounding of its kink takes its slope by the rounding's sign and moves
    every gradient behind it, the whole of a narrow layer's bias. A tensor
    of more than NOISE_SMALL elements may hold max(least, floor(share ×
    its size)) of them, each within `excess`; a smaller one (a narrow
    conv's bias or gains, whose noise moves it whole) may hold all of
    them, each within `small_excess`."""
    share: float
    excess: float
    small_excess: float
    least: int = 0


# Set from the readings of that noise (PERF.md §6): the largest share of a
# tensor of more than 16 elements outside was 0.1% on the CPU's full-width
# steps and 7.0% on the card; the largest excess 46.1 (an MSD conv's v in
# the modified recipe's span step) on the CPU and 13.9 on the card. Planted
# faults (tests/test_torch_gan_gate.py) read 100% or an excess of 99 to ∞.
# A tensor of at most 16 elements read an excess of at most 5.5 in the
# gate test's reduced generator and 5.8 in tests/test_torch_istft_train.py's
# modified step, and none was outside on the card; a 0.5% error in a
# one-element bias reads ~50-58, which passed the 100 that held such a
# tensor before.
NOISE = NoiseLimits(share=0.1, excess=100.0, small_excess=20.0)
NOISE_SMALL = 16
# Tensors whose readings lie above NOISE.share, held by name and size to
# their own share: the gate test's reduced generator (4 channels in its
# second stage) read up to 9 and 5 of their 48 elements outside (first
# moments; 8 and 4 in the second), each within 5.5 × its tolerance.
NOISE_HELD = {("['generator']['resblocks_1_0']['convs1_0']['v']", 48): 0.25,
              ("['generator']['resblocks_1_0']['convs2_0']['v']", 48): 0.25}
# One AdamW update (b1 0.8, b2 0.99) moves an element by at most 1.005·lr
# over its first two steps, so two runs that part in a gradient's sign part
# by at most ADAMW_NOISE·lr
ADAMW_NOISE = 2.01


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().double().cpu()
    return np.asarray(a, dtype=np.float64)


def noise_tolerance(want, ref) -> float:
    """What float32 leaves of a tensor's agreement with float64: 1e-4 of
    its largest magnitude in `ref`, or 4 × `want`'s own largest gap to
    `ref` (`want` a float32 run, `ref` the same computation in float64),
    whichever is larger."""
    want, ref = _f64(want), _f64(ref)
    return max(1e-4 * np.abs(ref).max(), 4 * np.abs(want - ref).max())


def parity_gate(got: dict, want: dict, ref: dict,
                exempt: dict | None = None,
                bound: float | None = None,
                limits: NoiseLimits = NOISE) -> dict:
    """Elementwise parity of the tensors `got` against `want` (the same
    names; arrays or tensors), with `ref` the computation of `want` in
    float64. An element passes within rtol 2e-5, atol 2e-6 of `want`, or
    within its tensor's `noise_tolerance(want, ref)` of `ref`; one that
    passes neither is outside. A tensor of more than NOISE_SMALL elements
    may hold max(limits.least, floor(share × its size)) outside elements,
    the share limits.share or, for a (name, size) in NOISE_HELD, its own;
    every outside element must lie within limits.excess × that tolerance
    of `ref` (limits.small_excess × in a tensor of at most NOISE_SMALL
    elements, which may hold any number). Outside elements that
    `exempt[name]` (a boolean mask) marks are held instead to `bound`,
    their largest gap to `want`.

    Returns {"f64": the tensors that needed the float64 gate, "outside":
    {name: elements outside, the exempt ones apart}, "exempt": {name:
    exempt elements outside}, "share_max": the largest share outside of a
    tensor of more than NOISE_SMALL elements, "excess_max": the largest
    gap to `ref` of a (not exempt) outside element over its tensor's
    tolerance, "small_excess_max": the same over the tensors of at most
    NOISE_SMALL elements, "failed": the tensors past the share, the excess
    or the bound, "ok"}."""
    assert got.keys() == want.keys() == ref.keys()
    out = {"f64": [], "outside": {}, "exempt": {}, "share_max": 0.0,
           "excess_max": 0.0, "small_excess_max": 0.0, "failed": []}
    for name in want:
        g, w, r = _f64(got[name]), _f64(want[name]), _f64(ref[name])
        gap = np.abs(g - w)
        strict = gap > 2e-6 + 2e-5 * np.abs(w)
        if not strict.any():
            continue
        out["f64"].append(name)
        tol = noise_tolerance(w, r)
        far = np.abs(g - r)
        outside = strict & (far > tol)
        free = outside
        if exempt is not None and name in exempt:
            held = outside & np.asarray(exempt[name]).reshape(w.shape)
            free = outside & ~held
            if held.any():
                out["exempt"][name] = int(held.sum())
                if bound is not None and gap[held].max() > bound:
                    out["failed"].append(name)
                    continue
        n = int(free.sum())
        if not n:
            continue
        out["outside"][name] = n
        worst = float(far[free].max() / tol) if tol else math.inf
        out["excess_max"] = max(out["excess_max"], worst)
        allowed, limit = w.size, limits.small_excess
        if w.size > NOISE_SMALL:
            out["share_max"] = max(out["share_max"], n / w.size)
            share = NOISE_HELD.get((name, w.size), limits.share)
            allowed = max(limits.least, math.floor(share * w.size))
            limit = limits.excess
        else:
            out["small_excess_max"] = max(out["small_excess_max"], worst)
        if n > allowed or worst > limit:
            out["failed"].append(name)
    out["ok"] = not out["failed"]
    return out


def zero_up_to_rounding(want: dict, ref: dict) -> dict:
    """{name: mask of the elements whose float64 value `ref` lies within
    the tensor's `noise_tolerance` of zero}: for AdamW's first moments,
    the parameters whose gradient is zero up to rounding, which float32
    may move by ±lr either way."""
    return {k: np.abs(_f64(ref[k])) <= noise_tolerance(want[k], ref[k])
            for k in want}
