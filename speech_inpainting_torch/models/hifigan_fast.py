"""Inference HiFi-GAN generator over folded weights.

Weight norm is folded once, when the weights are loaded
(convert/from_jax.py), as the reference's remove_weight_norm does. Every
ResBlock1 of the multi-receptive-field fusion runs through the fused CUDA
kernel (ops/resblock.py) when the generator lies on the card; the other convs
are torch's. Only ResBlock1 generators (V1, V2) are ported so far.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resblock import fused_resblock1, resblock1_reference
from .hifigan import HiFiGANConfig

LRELU_SLOPE = 0.1


class FastGenerator(nn.Module):
    """mel/features (B, in_dim, F) → waveform (B, 1, F·∏upsample_rates).

    Parameters hold the folded kernels in the torch layouts: `conv_pre`,
    `ups[i]`, `conv_post` as Conv1d/ConvTranspose1d modules and, per
    ResBlock1, `resblocks[i·nk + j]` with w1, w2 (S, C, C, K) and b1, b2
    (S, C). `use_kernel = False` routes the ResBlock1s through the plain
    version instead, for holding the kernel path against it.
    """

    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        if cfg.resblock != "1":
            raise NotImplementedError("only ResBlock1 generators are ported")
        self.cfg = cfg
        self.use_kernel = True
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.in_dim, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch * 2, ch, k, stride=u,
                                               padding=(k - u) // 2))
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                s = len(rd)
                self.resblocks.append(nn.ParameterDict({
                    "w1": nn.Parameter(torch.empty(s, ch, ch, rk)),
                    "b1": nn.Parameter(torch.empty(s, ch)),
                    "w2": nn.Parameter(torch.empty(s, ch, ch, rk)),
                    "b2": nn.Parameter(torch.empty(s, ch)),
                }))
        self.conv_post = nn.Conv1d(c0 // 2 ** len(cfg.upsample_rates), 1, 7,
                                   padding=3)
        self.requires_grad_(False)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        resblock = fused_resblock1 if self.use_kernel else resblock1_reference
        nk = len(cfg.resblock_kernel_sizes)
        x = self.conv_pre(mel.to(self.conv_pre.weight.dtype))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = None
            for j, rd in enumerate(cfg.resblock_dilation_sizes):
                p = self.resblocks[i * nk + j]
                out = resblock(x, p["w1"], p["b1"], p["w2"], p["b2"],
                               tuple(rd))
                xs = out if xs is None else xs + out
            x = xs / nk
        x = F.leaky_relu(x, 0.01)  # torch's default slope before conv_post
        return torch.tanh(self.conv_post(x))
