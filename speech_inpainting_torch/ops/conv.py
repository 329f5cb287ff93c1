"""Convolution helpers with the JAX package's names.

`speech_inpainting_tpu.ops.conv` rebuilds torch's Conv1d/ConvTranspose1d
semantics (torch weight layouts, symmetric integer padding) over `lax`; here
they are torch's own operators, so the port keeps the names and the layouts:
  conv1d            x (B, C_in, T), w (C_out, C_in/groups, K)
  conv_transpose1d  x (B, C_in, T), w (C_in, C_out/groups, K)
  conv2d            x (B, C_in, H, W), w (C_out, C_in/groups, KH, KW)
`avg_pool1d` is torch's AvgPool1d with count_include_pad, as the JAX
package's `lax.reduce_window` sum over k is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

conv1d = F.conv1d
conv_transpose1d = F.conv_transpose1d
conv2d = F.conv2d


def avg_pool1d(x: torch.Tensor, kernel: int, stride: int,
               padding: int) -> torch.Tensor:
    """x (B, C, T) → (B, C, ⌊(T + 2p − k)/s⌋ + 1), the zero padding counted
    in each window's mean."""
    return F.avg_pool1d(x, kernel, stride, padding, count_include_pad=True)


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Fold weight norm into a dense kernel, w = g · v / ‖v‖, the norm taken
    over every axis but 0 (torch weight_norm dim=0), in float32."""
    v32 = v.to(torch.float32)
    norm = torch.sqrt(torch.sum(v32 * v32, dim=tuple(range(1, v.ndim)),
                                keepdim=True))
    shape = (-1,) + (1,) * (v.ndim - 1)
    return (g.reshape(shape) * (v / norm.to(v.dtype))).to(v.dtype)


# torch's weight_norm keeps dim=0 on a ConvTranspose1d too, so the norm runs
# over axes (1, 2) of the (C_in, C_out, K) kernel: g has C_in entries.
weight_norm_kernel_tr = weight_norm_kernel


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """'same'-length padding for odd kernels."""
    return (kernel_size * dilation - dilation) // 2
