"""HiFi-GAN generator over folded weights, and its configuration (the
reference's config_v1.json keys).

Counterpart of speech_inpainting_tpu/models/hifigan.py:Generator. There the
convs are weight-normed (v, g) flax modules folded on every call; here weight
norm is folded once, when the weights are loaded (convert/from_jax.py), as
the reference's remove_weight_norm does. `Generator` sends each ResBlock1
through `ops.resblock.resblock1_forward`, one K2 kernel launch per residual
step when the generator lies on the card; models/hifigan_fast.py's
`FastGenerator` overrides only that call, for K1. ResBlock2 (config V3: two
steps of lrelu → dilated conv → residual) has no Pallas kernel in the JAX
package, so its convs are torch's, as are the others.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import get_padding
from ..ops.resblock import resblock1_forward, resblock1_reference

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    in_dim: int = 80          # 80 mels (I_ea) or model_in_dim=384 (I_da)
    sampling_rate: int = 22050
    dtype: torch.dtype = torch.float32

    @property
    def total_upsample(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out

    @staticmethod
    def from_dict(h: dict) -> "HiFiGANConfig":
        return HiFiGANConfig(
            resblock=str(h["resblock"]),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=h["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in h["resblock_dilation_sizes"]),
            in_dim=h.get("model_in_dim", h.get("num_mels", 80)) or 80,
            sampling_rate=h.get("sampling_rate", 22050),
        )


def resblock2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              dilations=(1, 3)) -> torch.Tensor:
    """ResBlock2 over folded weights w (S, C, C, K), b (S, C): for each
    dilation d, x ← x + conv_d(lrelu(x)), "same" padding, slope 0.1."""
    K = w.shape[-1]
    for s, d in enumerate(dilations):
        xt = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), w[s], b[s],
                      padding=get_padding(K, d), dilation=d)
        x = xt + x
    return x


class Generator(nn.Module):
    """mel/features (B, in_dim, F) → waveform (B, 1, F·∏upsample_rates).

    Parameters hold the folded kernels in the torch layouts: `conv_pre`,
    `ups[i]`, `conv_post` as Conv1d/ConvTranspose1d modules and, per
    ResBlock1, `resblocks[i·nk + j]` with w1, w2 (S, C, C, K) and b1, b2
    (S, C); per ResBlock2, w (S, C, C, K) and b (S, C). `use_kernel =
    False` routes the ResBlock1s through the plain version instead, for
    holding the kernel path against it.
    """

    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        if cfg.resblock not in ("1", "2"):
            raise ValueError(f"resblock {cfg.resblock!r} is neither 1 nor 2")
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
                names = ("1", "2") if cfg.resblock == "1" else ("",)
                self.resblocks.append(nn.ParameterDict({
                    k + n: nn.Parameter(torch.empty(*shape))
                    for n in names for k, shape in (
                        ("w", (s, ch, ch, rk)), ("b", (s, ch)))}))
        self.conv_post = nn.Conv1d(c0 // 2 ** len(cfg.upsample_rates), 1, 7,
                                   padding=3)
        self.requires_grad_(False)

    def resblock(self, x, p, dilations):
        """One ResBlock1: K2 once per step (on the card), or the plain
        version."""
        if self.use_kernel:
            return resblock1_forward(x, p, dilations)
        return resblock1_reference(x, p["w1"], p["b1"], p["w2"], p["b2"],
                                   dilations)

    def trunk(self, mel: torch.Tensor) -> torch.Tensor:
        """conv_pre, then each upsampler and its multi-receptive-field
        fusion, then the leaky ReLU before conv_post."""
        cfg = self.cfg
        nk = len(cfg.resblock_kernel_sizes)
        x = self.conv_pre(mel.to(self.conv_pre.weight.dtype))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = None
            for j, rd in enumerate(cfg.resblock_dilation_sizes):
                p = self.resblocks[i * nk + j]
                out = (self.resblock(x, p, tuple(rd)) if cfg.resblock == "1"
                       else resblock2(x, p["w"], p["b"], tuple(rd)))
                xs = out if xs is None else xs + out
            x = xs / nk
        return F.leaky_relu(x, 0.01)  # torch's default slope

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv_post(self.trunk(mel)))
