"""Random weights and synthetic audio for driving the port at any width.

Parameter trees with the JAX package's flax names and shapes, made with numpy
so that nothing here needs JAX: the scales follow the flax initialisers
(he/lecun normal, HiFi-GAN's N(0, 0.01)), and weight-norm magnitudes g = ‖v‖.
`chip_smoke.py` drives the full-width path with them on the card, and the
parity tests hand the same trees to the JAX package and to the port.
"""
from __future__ import annotations

import math

import numpy as np


def _wn(rng, shape, std=None):
    v = rng.standard_normal(shape).astype(np.float32)
    fan_in = int(np.prod(shape[1:]))
    v *= std if std is not None else 1.0 / math.sqrt(fan_in)
    return v, np.sqrt((v * v).sum(axis=tuple(range(1, v.ndim))))


def generator_tree(cfg, rng) -> dict:
    def conv(shape, n_out, std=0.01):
        v, g = _wn(rng, shape, std)
        b = rng.uniform(-1, 1, n_out).astype(np.float32) / math.sqrt(
            int(np.prod(shape[1:])))
        return {"v": v, "g": g, "b": b}

    c0 = cfg.upsample_initial_channel
    tree = {"conv_pre": conv((c0, cfg.in_dim, 7), c0, std=None)}
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        ch = c0 // 2 ** (i + 1)
        tree[f"ups_{i}"] = conv((2 * ch, ch, k), ch)
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            tree[f"resblocks_{i}_{j}"] = {
                f"convs{n}_{s}": conv((ch, ch, rk), ch)
                for n in (1, 2) for s in range(len(rd))}
    tree["conv_post"] = conv((1, c0 // 2 ** len(cfg.upsample_rates), 7), 1)
    return tree


def hubert_tree(cfg, out_dim, rng) -> dict:
    def normal(shape, fan_in, gain=1.0):
        return (rng.standard_normal(shape) * gain / math.sqrt(fan_in)
                ).astype(np.float32)

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out), n_in),
                "bias": np.zeros(n_out, np.float32)}

    def norm(n):
        return {"scale": np.ones(n, np.float32), "bias": np.zeros(n, np.float32)}

    h = cfg.hidden_size
    fe, c_in = {}, 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        fe[f"conv_{i}_w"] = normal((c, c_in, k), c_in * k, math.sqrt(2.0))
        c_in = c
    fe["norm_0"] = norm(cfg.conv_dim[0])
    k, g = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    v = normal((h, h // g, k), h // g * k, math.sqrt(2.0))
    hub = {"feature_extractor": fe, "fp_layer_norm": norm(cfg.conv_dim[-1]),
           "fp_projection": dense(cfg.conv_dim[-1], h),
           "pos_conv_embed": {
               "conv_v": v, "conv_g": np.sqrt((v * v).sum(axis=(0, 1))),
               "conv_b": np.zeros(h, np.float32)},
           "encoder_layer_norm": norm(h)}
    for i in range(cfg.num_hidden_layers):
        hub[f"layers_{i}"] = {
            "attention": {n: dense(h, h) for n in
                          ("q_proj", "k_proj", "v_proj", "out_proj")},
            "feed_forward": {
                "intermediate_dense": dense(h, cfg.intermediate_size),
                "output_dense": dense(cfg.intermediate_size, h)},
            "layer_norm": norm(h), "final_layer_norm": norm(h)}
    return {"hubert": hub,
            "head": {"layer_norm": norm(h), "linear": dense(h, out_dim)}}


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
