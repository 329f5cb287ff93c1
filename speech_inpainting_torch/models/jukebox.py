"""Jukebox-style strided conv Encoder/Decoder with dilated Resnet1D blocks.

Counterpart of speech_inpainting_tpu/models/jukebox.py:
  Encoder level: [Conv1d(k=2s|2s+1, stride s) + Resnet1D]×down_t
                 + Conv1d(3,1,1)
  Decoder level: Conv1d(3,1,1) + [Resnet1D + ConvTranspose1d(k=2s|2s+1,
                 stride s)]×down_t, levels added to the next one's latent
  Resnet1D block: x + scale·[ReLU → Conv1d(k3, dilation d) → ReLU → Conv1d(k1)]
with dilation d = growth_rate^depth (optionally cycled; the decoder's order
optionally reversed). Submodules keep the flax names (level_{l},
down_{i}_conv, down_{i}_resnet, up_{i}_resnet, up_{i}_convt, block_{j},
conv3, conv1, proj, out) so that convert/from_jax.py maps a tree onto them
by name. The flax `TorchConv1d` and `TorchConvTranspose1d` there keep
torch's layouts, so they are `nn.Conv1d` and `nn.ConvTranspose1d` here
(w → weight, b → bias, copied unchanged).
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
    """`block_{i}` has dilation growth_rate^(i, or i mod cycle); with
    `reverse_dilation` the blocks run last to first."""

    def __init__(self, n_in: int, n_depth: int, m_conv: float = 1.0,
                 dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None,
                 res_scale: bool = False, reverse_dilation: bool = False):
        super().__init__()
        scale = 1.0 / math.sqrt(n_depth) if res_scale else 1.0
        for i in range(n_depth):
            depth = i if dilation_cycle is None else i % dilation_cycle
            self.add_module(f"block_{i}", ResConv1DBlock(
                n_in, int(m_conv * n_in), dilation_growth_rate ** depth,
                scale))
        self.reverse_dilation = reverse_dilation

    def forward(self, x):
        blocks = list(self.children())
        for block in blocks[::-1] if self.reverse_dilation else blocks:
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


class DecoderConvBlock(nn.Module):
    """Conv1d(3,1,1) + [Resnet1D + ConvTranspose1d]×down_t, one level: the
    transposed convs (k = 2s or 2s+1, padding from `_filter_pad`) multiply
    the length by stride_t each."""

    def __init__(self, cfg: ConvStackConfig, in_width: int, out_width: int,
                 down_t: int, stride_t: int):
        super().__init__()
        filt, pad = _filter_pad(stride_t)
        self.down_t = down_t
        self.proj = nn.Conv1d(in_width, cfg.width, 3, padding=1)
        for i in range(down_t):
            self.add_module(f"up_{i}_resnet", Resnet1D(
                cfg.width, cfg.depth, cfg.m_conv, cfg.dilation_growth_rate,
                cfg.dilation_cycle, cfg.res_scale,
                cfg.reverse_decoder_dilation))
            self.add_module(f"up_{i}_convt", nn.ConvTranspose1d(
                cfg.width, out_width if i == down_t - 1 else cfg.width, filt,
                stride=stride_t, padding=pad))

    def forward(self, x):
        x = self.proj(x)
        for i in range(self.down_t):
            x = getattr(self, f"up_{i}_resnet")(x)
            x = getattr(self, f"up_{i}_convt")(x)
        return x


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


@torch.no_grad()
def init_conv_stack_(stack: nn.Module, cfg: ConvStackConfig,
                     gen: torch.Generator) -> nn.Module:
    """Redraw an Encoder's or Decoder's convs as the JAX package's
    `TorchConv1d`/`TorchConvTranspose1d` init them, torch's default
    distributions: weight and bias U(±1/√fan_in), fan_in = C_in·K for a
    conv and C_out·K for a transposed conv; with cfg.zero_out each residual
    block's closing k1 conv is zero. Drawn on the CPU from `gen`, in
    module order, then copied to the stack's device."""
    for name, m in stack.named_modules():
        if not isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            continue
        w = m.weight
        fan_in = w.shape[1] * w.shape[2]
        bound = 1.0 / math.sqrt(fan_in)
        for p in (w, m.bias):
            if cfg.zero_out and name.endswith(".conv1"):
                p.zero_()
            else:
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    return stack


class Decoder(nn.Module):
    """List of per-level latents (B, output_emb_width, T_l) → (B,
    input_emb_width, T): from the last level down, each level's block, then
    (below the last) the next level's latent added, then Conv1d `out`."""

    def __init__(self, cfg: ConvStackConfig):
        super().__init__()
        self.levels = cfg.levels
        for level in range(cfg.levels):
            self.add_module(f"level_{level}", DecoderConvBlock(
                cfg, cfg.output_emb_width, cfg.output_emb_width,
                cfg.downs_t[level], cfg.strides_t[level]))
        self.out = nn.Conv1d(cfg.output_emb_width, cfg.input_emb_width, 3,
                             padding=1)

    def forward(self, xs) -> torch.Tensor:
        if len(xs) != self.levels:
            raise ValueError(f"{len(xs)} latents for {self.levels} levels")
        x = xs[-1]
        for level in reversed(range(self.levels)):
            x = getattr(self, f"level_{level}")(x)
            if level != 0:
                x = x + xs[level - 1]
        return self.out(x)
