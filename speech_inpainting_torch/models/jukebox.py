"""Jukebox-style strided conv Encoder with dilated Resnet1D blocks.

Counterpart of speech_inpainting_tpu/models/jukebox.py, encoder side (the
f0-VQ-VAE's Decoder is not ported yet):
  Encoder level: [Conv1d(k=2s|2s+1, stride s) + Resnet1D]×down_t
                 + Conv1d(3,1,1)
  Resnet1D block: x + scale·[ReLU → Conv1d(k3, dilation d) → ReLU → Conv1d(k1)]
with dilation d = growth_rate^depth (optionally cycled). Submodules keep the
flax names (level_{l}, down_{i}_conv, down_{i}_resnet, block_{j}, conv3,
conv1, proj) so that convert/from_jax.py maps a tree onto them by name.
The flax `TorchConv1d` there keeps torch's layout, so it is `nn.Conv1d` here
(w (O, I, K) → weight, b → bias, copied unchanged).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ConvStackConfig:
    """One Encoder/Decoder parameterization (reference **block_kwargs)."""
    input_emb_width: int = 1
    output_emb_width: int = 128
    levels: int = 1
    downs_t: Tuple[int, ...] = (4,)
    strides_t: Tuple[int, ...] = (2,)
    width: int = 32
    depth: int = 4
    m_conv: float = 1.0
    dilation_growth_rate: int = 3
    dilation_cycle: Optional[int] = None
    zero_out: bool = False
    res_scale: bool = False
    reverse_decoder_dilation: bool = False

    @staticmethod
    def from_dict(d: dict) -> "ConvStackConfig":
        d = dict(d)
        d["downs_t"] = tuple(d.get("downs_t", (4,)))
        d["strides_t"] = tuple(d.get("strides_t", (2,)))
        fields = ConvStackConfig.__dataclass_fields__
        return ConvStackConfig(**{k: v for k, v in d.items() if k in fields})

    @property
    def total_stride(self) -> int:
        out = 1
        for s, d in zip(self.strides_t, self.downs_t):
            out *= s ** d
        return out


class ResConv1DBlock(nn.Module):
    def __init__(self, n_in: int, n_state: int, dilation: int = 1,
                 res_scale: float = 1.0):
        super().__init__()
        self.conv3 = nn.Conv1d(n_in, n_state, 3, padding=dilation,
                                 dilation=dilation)
        self.conv1 = nn.Conv1d(n_state, n_in, 1)
        self.res_scale = res_scale

    def forward(self, x):
        h = self.conv1(F.relu(self.conv3(F.relu(x))))
        return x + self.res_scale * h


class Resnet1D(nn.Module):
    """`block_{i}` has dilation growth_rate^(i, or i mod cycle)."""

    def __init__(self, n_in: int, n_depth: int, m_conv: float = 1.0,
                 dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None,
                 res_scale: bool = False):
        super().__init__()
        scale = 1.0 / math.sqrt(n_depth) if res_scale else 1.0
        for i in range(n_depth):
            depth = i if dilation_cycle is None else i % dilation_cycle
            self.add_module(f"block_{i}", ResConv1DBlock(
                n_in, int(m_conv * n_in), dilation_growth_rate ** depth,
                scale))

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


def _filter_pad(stride: int) -> Tuple[int, int]:
    if stride % 2 == 0:
        return stride * 2, stride // 2
    return stride * 2 + 1, stride // 2 + 1


class EncoderConvBlock(nn.Module):
    """[strided Conv1d + Resnet1D]×down_t + Conv1d(3,1,1), one level."""

    def __init__(self, cfg: ConvStackConfig, in_width: int, down_t: int,
                 stride_t: int):
        super().__init__()
        filt, pad = _filter_pad(stride_t)
        self.down_t = down_t
        for i in range(down_t):
            self.add_module(f"down_{i}_conv", nn.Conv1d(
                in_width if i == 0 else cfg.width, cfg.width, filt,
                stride=stride_t, padding=pad))
            self.add_module(f"down_{i}_resnet", Resnet1D(
                cfg.width, cfg.depth, cfg.m_conv, cfg.dilation_growth_rate,
                cfg.dilation_cycle, cfg.res_scale))
        self.proj = nn.Conv1d(cfg.width, cfg.output_emb_width, 3, padding=1)

    def forward(self, x):
        for i in range(self.down_t):
            x = getattr(self, f"down_{i}_conv")(x)
            x = getattr(self, f"down_{i}_resnet")(x)
        return self.proj(x)


class Encoder(nn.Module):
    """(B, input_emb_width, T) → list of per-level (B, output_emb_width,
    T/total_stride)."""

    def __init__(self, cfg: ConvStackConfig):
        super().__init__()
        for level in range(cfg.levels):
            self.add_module(f"level_{level}", EncoderConvBlock(
                cfg, cfg.input_emb_width if level == 0
                else cfg.output_emb_width, cfg.downs_t[level],
                cfg.strides_t[level]))

    def forward(self, x: torch.Tensor) -> list:
        xs = []
        for level in self.children():
            x = level(x)
            xs.append(x)
        return xs
