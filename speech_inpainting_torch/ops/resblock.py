"""Fused HiFi-GAN ResBlock1: the CUDA kernel's wrapper and its plain version.

`fused_resblock1` replaces the TPU kernel
speech_inpainting_tpu/ops/pallas_resblock.py:fused_resblock1 (K1): for each
step s with dilation d_s, x ← x + conv2_s(lrelu(conv1_s(lrelu(x)))), conv1_s
dilated by d_s, conv2_s undilated, "same" padding, slope 0.1. On a CUDA
tensor it launches csrc/resblock1.cu (one launch per step, the intermediate
kept in shared memory; its source note gives the design and what bounds it)
or raises; on a CPU tensor it runs `resblock1_reference`, the unfused chain
of F.leaky_relu and F.conv1d that the kernel is held against.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..kernels import build
from .conv import get_padding

LRELU_SLOPE = 0.1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def resblock1_reference(x, w1, b1, w2, b2, dilations=(1, 3, 5)):
    """The plain PyTorch ResBlock1. x (B, C, T); w1, w2 (S, C, C, K) with
    weight norm folded; b1, b2 (S, C)."""
    k = w1.shape[-1]
    for s, d in enumerate(dilations):
        h = F.leaky_relu(x, LRELU_SLOPE)
        h = F.conv1d(h, w1[s], b1[s], dilation=d, padding=get_padding(k, d))
        h = F.leaky_relu(h, LRELU_SLOPE)
        h = F.conv1d(h, w2[s], b2[s], padding=get_padding(k, 1))
        x = x + h
    return x


@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/resblock1.cu, built and loaded at first use, with its C
    signatures."""
    lib = build.library("resblock1")
    lib.si_resblock1.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    lib.si_resblock1.restype = ctypes.c_int
    lib.si_cuda_error_string.argtypes = [ctypes.c_int]
    lib.si_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_resblock1(x, w1, b1, w2, b2, dilations=(1, 3, 5)):
    """One whole ResBlock1; same arguments as `resblock1_reference`.

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
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_resblock1: dtype {x.dtype} is not float32 "
                        "or bfloat16")
    for name, t, shape in (("w1", w1, (S, C, C, K)), ("w2", w2, (S, C, C, K)),
                           ("b1", b1, (S, C)), ("b2", b2, (S, C))):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_resblock1: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"fused_resblock1: {name} is on {t.device}, "
                             f"x on {x.device}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError("fused_resblock1: weights must have x's dtype")
    if not (x.is_contiguous() and w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError("fused_resblock1: x, w1 and w2 must be contiguous")
    if len(dilations) != S or K % 2 == 0:
        raise ValueError("fused_resblock1: needs one dilation per step and "
                         "an odd kernel size")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError("fused_resblock1 has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    scratch = torch.empty_like(x) if S > 1 else None
    b1 = b1.to(torch.float32).contiguous()
    b2 = b2.to(torch.float32).contiguous()
    dils = (ctypes.c_int * S)(*(int(d) for d in dilations))
    lib = _lib()
    rc = lib.si_resblock1(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, C, T, K, S, dils,
        _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_resblock1: launch failed at (B, C, T, K)="
                           f"{(B, C, T, K)}: "
                           f"{lib.si_cuda_error_string(rc).decode()}")
    fused_resblock1.launches += S  # si_resblock1 enqueued one per step
    return out


fused_resblock1.launches = 0
