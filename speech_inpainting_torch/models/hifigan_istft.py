"""iSTFT-head HiFi-GAN (iSTFTNet's C8C8I geometry), the second vocoder
engine of the JAX package's serving benchmark.

Counterpart of speech_inpainting_tpu/models/hifigan_istft.py: the first two
upsample + multi-receptive-field stages of a HiFi-GAN (the trunk, whose six
ResBlock1s run in K1 on the card, as in models/hifigan_fast.py), then
conv_post to n_fft + 2 channels: magnitude exp(first n_fft/2 + 1, clipped at
±20) and phase π·sin(rest), in float32, turned into the waveform by the
inverse STFT of ops/stft.py (n_fft 16, hop 4; total upsample 8·8·4 = 256,
V1's mel hop), padded back to T·total_upsample samples.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import istft_overlap_add
from .hifigan import HiFiGANConfig
from .hifigan_fast import FastGenerator


@dataclasses.dataclass(frozen=True)
class ISTFTGeneratorConfig:
    """Trunk (the first stages of a HiFi-GAN) + iSTFT head. The defaults
    give the C8C8I geometry at V1's width."""
    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    in_dim: int = 80
    sampling_rate: int = 22050
    istft_n_fft: int = 16
    istft_hop: int = 4
    dtype: torch.dtype = torch.float32

    @property
    def total_upsample(self) -> int:
        return self.istft_hop * math.prod(self.upsample_rates)

    def trunk(self) -> HiFiGANConfig:
        return HiFiGANConfig(
            resblock=self.resblock, upsample_rates=self.upsample_rates,
            upsample_kernel_sizes=self.upsample_kernel_sizes,
            upsample_initial_channel=self.upsample_initial_channel,
            resblock_kernel_sizes=self.resblock_kernel_sizes,
            resblock_dilation_sizes=self.resblock_dilation_sizes,
            in_dim=self.in_dim, sampling_rate=self.sampling_rate,
            dtype=self.dtype)


class ISTFTGenerator(FastGenerator):
    """mel/features (B, in_dim, T) → waveform (B, 1, T·total_upsample).

    The trunk is FastGenerator's over `cfg.trunk()` (`self.cfg`), with the
    same folded parameters and `use_kernel` switch; `conv_post` is the
    head's n_fft + 2-channel conv and `istft` the head's configuration.
    """

    def __init__(self, cfg: ISTFTGeneratorConfig):
        super().__init__(cfg.trunk())
        self.istft = cfg
        c_last = cfg.upsample_initial_channel // 2 ** len(cfg.upsample_rates)
        self.conv_post = nn.Conv1d(c_last, cfg.istft_n_fft + 2, 7, padding=3)
        self.requires_grad_(False)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.istft
        n_freq = cfg.istft_n_fft // 2 + 1
        x = self.conv_post(self.trunk(mel)).float()
        mag = torch.exp(x[:, :n_freq].clamp(-20.0, 20.0))
        phase = math.pi * torch.sin(x[:, n_freq:])
        wav = istft_overlap_add(mag * torch.cos(phase), mag * torch.sin(phase),
                                n_fft=cfg.istft_n_fft, hop=cfg.istft_hop)
        # the centre trim costs n_fft//2 per side: pad back to the
        # T·total_upsample grid
        want = x.shape[-1] * cfg.istft_hop
        half = (want - wav.shape[-1]) // 2
        return F.pad(wav, (half, want - wav.shape[-1] - half))[:, None, :]
