"""Dynamic int8 (W8A8) matrix products for serving: the int8 HuBERT option.

Counterpart of speech_inpainting_tpu/ops/int8.py. Symmetric dynamic
quantization, chosen so that every scale factors out of the contraction and
the rescale is exact:

    x: (..., K) activations  → per-row scale    sx = amax(|x|, -1) / 127
    w: (K, N) weights        → per-column scale sw = amax(|w|, 0) / 127
    y = (round(x / sx) · round(w / sw)) · sx · sw    [int8 · int8 → int32]

Rounding is half to even (torch.round, as jnp.round), codes are clipped to
±127, and the rescale is (y · sx) · sw in float32, the JAX order, so codes
and scales are bit-equal to the JAX package's. The product is
`torch._int_mm`, cuBLASLt's int8 GEMM on the card (the JAX package leaves
it to XLA's `dot_general`: it is a plain matrix product, no Pallas kernel).
On the card `_int_mm` takes more than 16 rows and K and N in multiples of
8: the operands are padded with zero rows and columns (zero codes add
nothing to the sums) and the padding is cut from the result.

Weights are quantized per call: the parameters stay float32, so a
converted checkpoint loads into `Int8Linear` as into the port's dense
layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.hubert import Dense

_MIN_ROWS = 17      # cuBLASLt's int8 GEMM in `_int_mm` takes more than 16


def quantize_rows(x: torch.Tensor, eps: float = 1e-8):
    """Symmetric per-row int8 quantization over the last axis. Returns (q,
    scale): q int8 with |q| <= 127 and scale float32 (..., 1), q · scale ≈
    x. An all-zero row gets scale eps/127 and codes 0."""
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=eps) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_cols(w: torch.Tensor, eps: float = 1e-8):
    """Symmetric per-column int8 quantization of a (K, N) matrix: q int8
    (K, N), scale float32 (1, N)."""
    w = w.float()
    scale = w.abs().amax(dim=0, keepdim=True).clamp(min=eps) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127)
    return q.to(torch.int8), scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 → (M, N) int32 by `torch._int_mm`:
    M padded to more than 16 rows and to a multiple of 8, K and N to
    multiples of 8 (zero codes), a row-major and b column-major, the
    padding cut from the result."""
    (M, K), N = a.shape, b.shape[1]
    m = _round_up(max(M, _MIN_ROWS), 8)
    k, n = _round_up(K, 8), _round_up(N, 8)
    if (m, k) != (M, K):
        a = F.pad(a, (0, k - K, 0, m - M))
    if (k, n) != (K, N):
        b = F.pad(b, (0, n - N, 0, k - K))
    if b.stride(0) != 1:   # b column-major, as a weight's transpose is
        b = b.t().contiguous().t()
    return torch._int_mm(a.contiguous(), b)[:M, :N]


def dynamic_int8_dot(x: torch.Tensor, w: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (..., K) @ w (K, N) through int8 codes, with the exact float32
    rescale; the result in `out_dtype`."""
    xq, sx = quantize_rows(x)
    wq, sw = quantize_cols(w)
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    y = y.float() * sx.reshape(-1, 1) * sw
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(out_dtype)


class Int8Linear(Dense):
    """The port's dense layer (models/hubert.py:Dense: `weight` (N, K),
    `bias` (N,)) with its product through `dynamic_int8_dot`, as the JAX
    package's `Int8Dense`: the activations are quantized as they come (in
    float32, not first cast to the compute type), the result is cast to
    the compute type and the bias added in it."""

    def forward(self, x):
        dt = self.compute_dtype
        y = dynamic_int8_dot(x, self.weight.t(), out_dtype=dt)
        return y + self.bias.to(dt)


__all__ = ["quantize_rows", "quantize_cols", "dynamic_int8_dot",
           "Int8Linear"]
