"""Fused HiFi-GAN ResBlock1 steps: the CUDA kernels' wrappers and their plain
versions.

A ResBlock1 step with dilation d is x ← x + conv2(lrelu(conv1_d(lrelu(x)))),
conv1 dilated by d, conv2 undilated, "same" padding, slope 0.1. Two wrappers
replace the two TPU kernels of speech_inpainting_tpu/ops/pallas_resblock.py:
  - `fused_resblock1` (K1, `fused_resblock1` there): all S steps of a block;
  - `fused_resblock_step` (K2, `fused_resblock_step` there): one step, which
    `resblock1_forward` chains once per dilation as the JAX function of that
    name does.
On a CUDA tensor both launch csrc/resblock1.cu (one launch per step, the
intermediate kept in shared memory; its source note gives the design and
what bounds it) or raise; on a CPU tensor they run `resblock1_reference` and
`resblock_step_reference`, the unfused chains of F.leaky_relu and F.conv1d
that the kernels are held against.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import build
from .conv import get_padding

LRELU_SLOPE = 0.1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# csrc/resblock1.cu's C signatures
_SIGNATURES = {
    "si_resblock1": ([_P] * 7 + [_I] * 5 + [ctypes.POINTER(_I), _I, _I, _P],
                     _I),
    "si_resblock_step": ([_P] * 6 + [_I] * 7 + [_P], _I),
    "si_cuda_error_string": ([_I], ctypes.c_char_p),
}


def resblock_step_reference(x, w1, b1, w2, b2, dilation=1):
    """The plain PyTorch ResBlock1 step. x (B, C, T); w1, w2 (C, C, K) with
    weight norm folded; b1, b2 (C,)."""
    k = w1.shape[-1]
    h = F.leaky_relu(x, LRELU_SLOPE)
    h = F.conv1d(h, w1, b1, dilation=dilation,
                 padding=get_padding(k, dilation))
    h = F.leaky_relu(h, LRELU_SLOPE)
    h = F.conv1d(h, w2, b2, padding=get_padding(k, 1))
    return x + h


def resblock1_reference(x, w1, b1, w2, b2, dilations=(1, 3, 5)):
    """The plain PyTorch ResBlock1. x (B, C, T); w1, w2 (S, C, C, K) with
    weight norm folded; b1, b2 (S, C)."""
    for s, d in enumerate(dilations):
        x = resblock_step_reference(x, w1[s], b1[s], w2[s], b2[s], d)
    return x


def _check(fn: str, x, w1, b1, w2, b2, wshape, bshape, K):
    """Refuse what the kernel does not take; returns the biases in float32."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {x.dtype} is not float32 or bfloat16")
    for name, t, shape in (("w1", w1, wshape), ("w2", w2, wshape),
                           ("b1", b1, bshape), ("b2", b2, bshape)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on {x.device}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"{fn}: weights must have x's dtype")
    if not (x.is_contiguous() and w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError(f"{fn}: x, w1 and w2 must be contiguous")
    if K % 2 == 0:
        raise ValueError(f"{fn}: needs an odd kernel size")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError(f"{fn} has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    return (b1.to(torch.float32).contiguous(),
            b2.to(torch.float32).contiguous())


def _launched(fn: str, lib, rc: int, shape) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: launch failed at (B, C, T, K)={shape}: "
                           f"{lib.si_cuda_error_string(rc).decode()}")


def fused_resblock1(x, w1, b1, w2, b2, dilations=(1, 3, 5)):
    """One whole ResBlock1 (K1); same arguments as `resblock1_reference`.

    x and the weights are float32 or bfloat16 (one type for all); the biases
    are taken in float32. The CUDA path sums in float32 and returns x's type.
    Inference only: the kernel has no backward, so inputs that require grad
    are refused. `fused_resblock1.launches` counts kernel launches on the
    card: S per call, one per residual step.
    """
    if x.device.type == "cpu":
        return resblock1_reference(x, w1, b1, w2, b2, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock1: no kernel for device {x.device}")
    B, C, T = x.shape
    S, _, _, K = w1.shape
    if len(dilations) != S:
        raise ValueError("fused_resblock1: needs one dilation per step")
    b1, b2 = _check("fused_resblock1", x, w1, b1, w2, b2, (S, C, C, K),
                    (S, C), K)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    scratch = torch.empty_like(x) if S > 1 else None
    dils = (ctypes.c_int * S)(*(int(d) for d in dilations))
    lib = build.library("resblock1", _SIGNATURES)
    rc = lib.si_resblock1(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, C, T, K, S, dils,
        _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launched("fused_resblock1", lib, rc, (B, C, T, K))
    fused_resblock1.launches += S  # si_resblock1 enqueued one per step
    return out


fused_resblock1.launches = 0


def fused_resblock_step(x, w1, b1, w2, b2, dilation=1):
    """One ResBlock1 step (K2); same arguments as `resblock_step_reference`.

    Types, biases and the refusal of inputs that require grad are as for
    `fused_resblock1`. `fused_resblock_step.launches` counts kernel launches
    on the card: one per call.
    """
    if x.device.type == "cpu":
        return resblock_step_reference(x, w1, b1, w2, b2, dilation)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_resblock_step: no kernel for device {x.device}")
    B, C, T = x.shape
    K = w1.shape[-1]
    if int(dilation) < 1:
        raise ValueError("fused_resblock_step: dilation must be at least 1")
    b1, b2 = _check("fused_resblock_step", x, w1, b1, w2, b2, (C, C, K),
                    (C,), K)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = build.library("resblock1", _SIGNATURES)
    rc = lib.si_resblock_step(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), B, C, T, K, int(dilation),
        _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launched("fused_resblock_step", lib, rc, (B, C, T, K))
    fused_resblock_step.launches += 1
    return out


fused_resblock_step.launches = 0


def resblock1_forward(x, block, dilations=(1, 3, 5)):
    """A whole ResBlock1 as one K2 call per dilation, the JAX package's
    `resblock1_forward`. `block` maps w1, w2 to (S, C, C, K) and b1, b2 to
    (S, C). Weight norm is already folded: convert/from_jax.py folds it once
    at load, where the JAX function folds the flax (v, g) tree on every
    call."""
    for s, d in enumerate(dilations):
        x = fused_resblock_step(x, block["w1"][s], block["b1"][s],
                                block["w2"][s], block["b2"][s], d)
    return x
