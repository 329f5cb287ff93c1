"""The EMA vector-quantization bottleneck, evaluation side.

Counterpart of speech_inpainting_tpu/quantize/vq.py: nearest-code encoding,
decoding and the eval forward over a codebook `k` (k_bins, emb_width), a
buffer filled from the JAX package's `vq` collection (convert/from_jax.py)
or a reference checkpoint's `k` (convert/ida_torch.py). The EMA codebook
update, the dead-code restart and their cross-device sums belong to
training and are not ported yet: `forward(train=True)` raises.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .kmeans import pairwise_sqdist


def _prenorm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x - x.mean()) / x.numel() ** 0.5


class EMAVectorQuantizer(nn.Module):
    """One BottleneckBlock: (N, C, T) ↔ labels (N, T)."""

    def __init__(self, k_bins: int, emb_width: int):
        super().__init__()
        self.emb_width = emb_width
        self.register_buffer("k", torch.zeros(k_bins, emb_width))

    def _preprocess(self, x: torch.Tensor):
        """NCT → ((N·T, C), prenorm); a 2·emb_width input is the sum of its
        halves, its prenorm the sum of theirs (reference vq.py:99-106)."""
        x = x.transpose(1, 2).reshape(-1, x.shape[1])
        if x.shape[-1] == 2 * self.emb_width:
            x1, x2 = x[:, :self.emb_width], x[:, self.emb_width:]
            return x1 + x2, _prenorm(x1) + _prenorm(x2)
        if x.shape[-1] != self.emb_width:
            raise ValueError(f"width {x.shape[-1]} != (1 or 2)*"
                             f"{self.emb_width}")
        return x, _prenorm(x)

    def quantise(self, x_flat: torch.Tensor):
        """Nearest codes (first of equal distances) and the mean distance."""
        d = pairwise_sqdist(x_flat, self.k)
        labels = d.argmin(dim=-1)
        return labels, d.gather(-1, labels[:, None]).mean()

    def dequantise(self, labels: torch.Tensor) -> torch.Tensor:
        return self.k[labels]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        n, _, t = x.shape
        labels, _ = self.quantise(self._preprocess(x)[0])
        return labels.reshape(n, t)

    def decode(self, labels: torch.Tensor) -> torch.Tensor:
        return self.dequantise(labels).transpose(1, 2)

    def forward(self, x: torch.Tensor, *, train: bool = False):
        """x (N, C, T) → (labels (N, T), quantized (N, emb_width, T),
        commit ‖x_d − x‖² / x.numel() over the preprocessed x, metrics
        {fit: mean nearest distance, pn: prenorm}). In eval the
        straight-through output is the codebook rows themselves."""
        if train:
            raise NotImplementedError(
                "the VQ's training forward (EMA update, dead-code restart) "
                "is not ported")
        n, _, t = x.shape
        flat, prenorm = self._preprocess(x)
        labels, fit = self.quantise(flat)
        x_d = self.dequantise(labels)
        commit = ((x_d - flat) ** 2).sum() / flat.numel()
        x_out = x_d.reshape(n, t, -1).transpose(1, 2)
        return labels.reshape(n, t), x_out, commit, {"fit": fit,
                                                     "pn": prenorm}


class Bottleneck(nn.Module):
    """Multi-level bottleneck; level i's codebook is `level_{i}`."""

    def __init__(self, levels: int, l_bins: int, emb_width: int):
        super().__init__()
        for i in range(levels):
            self.add_module(f"level_{i}", EMAVectorQuantizer(l_bins,
                                                             emb_width))

    def encode(self, xs: Sequence[torch.Tensor]) -> list:
        return [b.encode(x) for b, x in zip(self.children(), xs)]

    def decode(self, zs: Sequence[torch.Tensor]) -> list:
        return [b.decode(z) for b, z in zip(self.children(), zs)]

    def forward(self, xs: Sequence[torch.Tensor], *, train: bool = False):
        """Per-level (labels, quantized, commit, metrics), as four lists."""
        out = [b(x, train=train) for b, x in zip(self.children(), xs)]
        zs, xqs, commits, metrics = map(list, zip(*out))
        return zs, xqs, commits, metrics
