"""The EMA vector-quantization bottleneck: nearest-code encoding, decoding,
the eval forward and the training forward.

Counterpart of speech_inpainting_tpu/quantize/vq.py. Its `axis_name` is
the training forward's `group`, a process group or None (one device):
  - the one-hot sums k_sum and k_elem of each rank's rows are
    all_reduced (JAX's `_psum`), so every rank's codebook takes the update
    of the rows of all;
  - the candidates come from the group's first rank by broadcast (JAX's
    `_bcast_from_zero`), drawn from that rank's own rows, as each shard of
    JAX's shard_map form takes shard 0's; with `global_rows` they are
    drawn instead from every rank's rows, gathered in rank order (each
    rank's generator in the same state), as JAX's mesh-jitted step over
    the global batch draws them (train/da.py's joint regime).
The codebook `k`
(k_bins, emb_width), the EMA sums `k_sum` and `k_elem` and the `initted`
flag are buffers, so an optimizer never sees them; they are filled from
the JAX package's `vq` collection (convert/from_jax.py), a reference
checkpoint's `k` (convert/ida_torch.py) or the first training batch.

The training forward, in the JAX package's order:
  - one set of restart candidates per call, drawn before quantising:
    k_bins random rows of the preprocessed input, tiled and jittered by
    N(0, 1)·0.01/√d when it has fewer rows (`_tile_candidates`), from an
    explicit CPU `torch.Generator`, so that a card run and a CPU run seeded
    alike draw the same candidates;
  - the first-batch init, `where(initted, k, candidates)`, k_elem set to 1;
  - quantisation against the codebook after that init;
  - the EMA update of k_sum and k_elem (mu), the codebook their ratio where
    k_elem reaches `threshold` and a candidate elsewhere (the dead-code
    restart: an unused code reads 0.99 < 1 after its first update);
  - the straight-through output flat + sg(x_d − flat), whose gradient
    reaches the encoder through `flat` only, and the commit term.
The buffers' update runs without gradient and in full float32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import full_f32
from ..parallel.distributed import all_gather_rows, all_reduce_, broadcast_
from .kmeans import pairwise_sqdist


def _prenorm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x - x.mean()) / x.numel() ** 0.5


def _tile_candidates(gen: Optional[torch.Generator], x: torch.Tensor,
                     k_bins: int) -> torch.Tensor:
    """k_bins random rows of x (N, d): when N < k_bins the rows are tiled
    ⌈k_bins/N⌉ times and jittered by N(0, 1)·0.01/√d first; then a random
    permutation's first k_bins. The jitter and the permutation are drawn
    on the CPU from `gen` and moved to x's device."""
    n, d = x.shape
    if n < k_bins:
        x = x.repeat((k_bins + n - 1) // n, 1)
        noise = torch.randn(x.shape, generator=gen, dtype=x.dtype)
        x = x + noise.to(x.device) * (0.01 / d ** 0.5)
        n = x.shape[0]
    perm = torch.randperm(n, generator=gen)[:k_bins]
    return x[perm.to(x.device)]


class EMAVectorQuantizer(nn.Module):
    """One BottleneckBlock: (N, C, T) ↔ labels (N, T)."""

    def __init__(self, k_bins: int, emb_width: int, mu: float = 0.99,
                 threshold: float = 1.0):
        super().__init__()
        self.k_bins = k_bins
        self.emb_width = emb_width
        self.mu = mu
        self.threshold = threshold
        self.register_buffer("k", torch.zeros(k_bins, emb_width))
        self.register_buffer("k_sum", torch.zeros(k_bins, emb_width))
        self.register_buffer("k_elem", torch.zeros(k_bins))
        self.register_buffer("initted", torch.zeros((), dtype=torch.bool))

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

    @torch.no_grad()
    def _init_k(self, cand: torch.Tensor) -> None:
        """The first-batch init, as a select on the flag (no host read)."""
        self.k.copy_(torch.where(self.initted, self.k, cand))
        self.k_sum.copy_(torch.where(self.initted, self.k_sum, cand))
        self.k_elem.copy_(torch.where(self.initted, self.k_elem,
                                      torch.ones_like(self.k_elem)))
        self.initted.fill_(True)

    @torch.no_grad()
    def _update_k(self, flat: torch.Tensor, labels: torch.Tensor,
                  cand: torch.Tensor, group=None) -> dict:
        """The EMA update and the dead-code restart; their metrics. With a
        `group`, the sums over the rows of all its ranks."""
        with full_f32():
            one_hot = F.one_hot(labels, self.k_bins).to(flat.dtype)
            _k_sum = one_hot.t() @ flat
            _k_elem = one_hot.sum(dim=0)
        if group is not None:
            all_reduce_([_k_sum, _k_elem], group)
        old_k = self.k.clone()
        self.k_sum.copy_(self.mu * self.k_sum + (1 - self.mu) * _k_sum)
        self.k_elem.copy_(self.mu * self.k_elem + (1 - self.mu) * _k_elem)
        usage = (self.k_elem[:, None] >= self.threshold).to(flat.dtype)
        self.k.copy_(usage * (self.k_sum
                              / self.k_elem.clamp(min=1e-8)[:, None])
                     + (1 - usage) * cand)
        _k_prob = _k_elem / _k_elem.sum().clamp(min=1e-8)
        return {"entropy": -(_k_prob * torch.log(_k_prob + 1e-8)).sum(),
                "used_curr": (_k_elem >= self.threshold).sum(),
                "usage": usage.sum(),
                "dk": torch.linalg.vector_norm(self.k - old_k)
                / old_k.numel() ** 0.5}

    def _candidates(self, generator, flat, group, global_rows):
        if group is not None and global_rows:
            return _tile_candidates(generator, all_gather_rows(flat, group),
                                    self.k_bins)
        cand = _tile_candidates(generator, flat, self.k_bins)
        if group is not None:
            broadcast_([cand], group)
        return cand

    def forward(self, x: torch.Tensor, *, train: bool = False,
                update_k: bool = True,
                generator: Optional[torch.Generator] = None,
                group=None, global_rows: bool = False):
        """x (N, C, T) → (labels (N, T), quantized (N, emb_width, T),
        commit ‖sg(x_d) − x‖² / x.numel() over the preprocessed x, metrics
        {fit: mean nearest distance, pn: prenorm; in training with
        update_k also entropy, used_curr, usage, dk}). In eval the output
        is the codebook rows themselves; in training the straight-through
        flat + sg(x_d − flat), and with update_k the buffers are updated
        (candidates drawn from `generator`), over the rows of every rank
        of `group` where one is given (module docstring)."""
        n, _, t = x.shape
        flat, prenorm = self._preprocess(x)
        if not train:
            labels, fit = self.quantise(flat)
            x_d = self.dequantise(labels)
            commit = ((x_d - flat) ** 2).sum() / flat.numel()
            x_out = x_d.reshape(n, t, -1).transpose(1, 2)
            return labels.reshape(n, t), x_out, commit, {"fit": fit,
                                                         "pn": prenorm}
        if update_k:
            cand = self._candidates(generator, flat.detach(), group,
                                    global_rows)
            self._init_k(cand)
        with torch.no_grad():
            labels, fit = self.quantise(flat.detach())
            x_d = self.dequantise(labels)
        metrics = {"fit": fit, "pn": prenorm}
        if update_k:
            metrics.update(self._update_k(flat.detach(), labels, cand,
                                          group))
        commit = ((x_d - flat) ** 2).sum() / flat.numel()
        x_st = flat + (x_d - flat).detach()
        x_out = x_st.reshape(n, t, -1).transpose(1, 2)
        return labels.reshape(n, t), x_out, commit, metrics


class Bottleneck(nn.Module):
    """Multi-level bottleneck; level i's codebook is `level_{i}`."""

    def __init__(self, levels: int, l_bins: int, emb_width: int,
                 mu: float = 0.99):
        super().__init__()
        for i in range(levels):
            self.add_module(f"level_{i}", EMAVectorQuantizer(l_bins,
                                                             emb_width, mu))

    def encode(self, xs: Sequence[torch.Tensor]) -> list:
        return [b.encode(x) for b, x in zip(self.children(), xs)]

    def decode(self, zs: Sequence[torch.Tensor]) -> list:
        return [b.decode(z) for b, z in zip(self.children(), zs)]

    def forward(self, xs: Sequence[torch.Tensor], *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                group=None, global_rows: bool = False):
        """Per-level (labels, quantized, commit, metrics), as four lists;
        training updates every level's codebook (update_k=train), over
        `group`'s ranks where one is given."""
        out = [b(x, train=train, update_k=train, generator=generator,
                 group=group, global_rows=global_rows)
               for b, x in zip(self.children(), xs)]
        zs, xqs, commits, metrics = map(list, zip(*out))
        return zs, xqs, commits, metrics
