"""Trainable weight-normed and spectral-normed convolutions.

Counterpart of speech_inpainting_tpu/models/common.py's WNConv1d,
WNConvTranspose1d, WNConv2d and SNConv1d, as `nn.Module`s whose parameters
carry the reference's names and shapes, so that a state dict is a reference
checkpoint's:
  - weight norm: `weight_v`, `weight_g` and `bias`; g holds one magnitude
    per row of axis 0 (C_out, or C_in on the transposed conv, whose weight
    is (C_in, C_out/groups, K)), shaped (rows, 1, …) as torch's legacy
    weight_norm stores it; the kernel w = g·v/‖v‖ is computed in float32
    on every call (no eps), then cast to the compute type;
  - spectral norm: `weight_orig` and `bias` parameters, `weight_u` (C_out)
    and `weight_v` (C_in/groups·K) buffers. A call with update_stats runs
    one power iteration, v = n(Wᵀn(u)), u = n(Wv), n(z) = z/(‖z‖ + 1e-12),
    and stores u, v; without it the stored u, v are used as they are. Either
    way σ = uᵀWv with u, v detached, so σ keeps its gradient in W.
Parameters stay float32 whatever `dtype` is; the convolution computes in
`dtype` (inputs, kernel and bias cast per call), as flax's param_dtype/dtype
split does. Inits, drawn from an explicit `torch.Generator`: torch's
U(±1/√fan_in) for kernels ("torch") and every bias, HiFi-GAN's N(0, 0.01)
for kernels with kernel_init="hifigan", g = ‖v‖ per row, and the power
iteration's u from N(0, 1) with v = n(Wᵀn(u)).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import weight_norm_kernel

LRELU_SLOPE = 0.1  # HiFi-GAN's leaky ReLU slope


def _uniform(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


class _WeightNormed(nn.Module):
    """`weight_v`, `weight_g` (rows of axis 0) and `bias`, with their init."""

    def __init__(self, v_shape: tuple, n_out: int, fan_in: int,
                 kernel_init: str, dtype: torch.dtype,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if kernel_init not in ("torch", "hifigan"):
            raise ValueError(f"kernel_init {kernel_init!r}")
        self.dtype = dtype
        self.fan_in = fan_in
        self.kernel_init = kernel_init
        self.weight_g = nn.Parameter(
            torch.empty((v_shape[0],) + (1,) * (len(v_shape) - 1)))
        self.weight_v = nn.Parameter(torch.empty(v_shape))
        self.bias = nn.Parameter(torch.empty(n_out))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        gen = generator or torch.Generator()
        shape = self.weight_v.shape
        if self.kernel_init == "hifigan":
            v = 0.01 * torch.randn(shape, generator=gen)
        else:
            v = _uniform(gen, shape, self.fan_in)
        self.weight_v.copy_(v)
        self.weight_g.copy_(torch.sqrt(torch.sum(
            v * v, dim=tuple(range(1, v.ndim)), keepdim=True)))
        self.bias.copy_(_uniform(gen, self.bias.shape, self.fan_in))

    def kernel(self) -> torch.Tensor:
        """The folded kernel in the compute type."""
        return weight_norm_kernel(self.weight_v, self.weight_g).to(self.dtype)

    def _bias(self) -> torch.Tensor:
        return self.bias.to(self.dtype)


class WNConv1d(_WeightNormed):
    """weight_norm(Conv1d): weight_v (C_out, C_in/groups, K), g (C_out, 1,
    1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, kernel_init: str = "torch",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        fan_in = in_channels // groups * kernel_size
        super().__init__((out_channels, in_channels // groups, kernel_size),
                         out_channels, fan_in, kernel_init, dtype, generator)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x.to(self.dtype), self.kernel(), self._bias(),
                        self.stride, self.padding, self.dilation, self.groups)


class WNConvTranspose1d(_WeightNormed):
    """weight_norm(ConvTranspose1d), dim 0 as torch keeps it: weight_v
    (C_in, C_out, K), g (C_in, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 kernel_init: str = "torch",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__((in_channels, out_channels, kernel_size),
                         out_channels, in_channels * kernel_size, kernel_init,
                         dtype, generator)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x.to(self.dtype), self.kernel(),
                                  self._bias(), self.stride, self.padding)


class WNConv2d(_WeightNormed):
    """weight_norm(Conv2d), the period discriminators' convs: weight_v
    (C_out, C_in, KH, KW), g (C_out, 1, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int], stride: Sequence[int] = (1, 1),
                 padding: Sequence[int] = (0, 0),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        kh, kw = kernel_size
        super().__init__((out_channels, in_channels, kh, kw), out_channels,
                         in_channels * kh * kw, "torch", dtype, generator)
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.kernel(), self._bias(),
                        self.stride, self.padding)


def _normalize(z: torch.Tensor) -> torch.Tensor:
    return z / (torch.sqrt(torch.sum(z * z)) + 1e-12)


class SNConv1d(nn.Module):
    """spectral_norm(Conv1d) with a persistent power-iteration state."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        fan_in = in_channels // groups * kernel_size
        gen = generator or torch.Generator()
        self.weight_orig = nn.Parameter(_uniform(
            gen, (out_channels, in_channels // groups, kernel_size), fan_in))
        self.bias = nn.Parameter(_uniform(gen, (out_channels,), fan_in))
        u = torch.randn(out_channels, generator=gen)
        w_mat = self.weight_orig.detach().reshape(out_channels, -1)
        self.register_buffer("weight_u", u)
        self.register_buffer("weight_v", _normalize(w_mat.T @ _normalize(u)))

    def forward(self, x: torch.Tensor,
                update_stats: bool = True) -> torch.Tensor:
        w = self.weight_orig
        w_mat = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            if update_stats:
                v = _normalize(w_mat.T @ _normalize(self.weight_u))
                u = _normalize(w_mat @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
            else:
                # copies: a later train-mode call updates the buffers in
                # place, which σ's saved operands must not see
                u, v = self.weight_u.clone(), self.weight_v.clone()
        sigma = u @ (w_mat @ v)
        return F.conv1d(x.to(self.dtype), (w / sigma).to(self.dtype),
                        self.bias.to(self.dtype), self.stride, self.padding,
                        groups=self.groups)
