"""Fused HiFi-GAN ResBlock1 steps: the CUDA kernels' wrappers and their plain
versions.

A ResBlock1 step with dilation d is x ← x + conv2(lrelu(conv1_d(lrelu(x)))),
conv1 dilated by d, conv2 undilated, "same" padding, slope 0.1. Two wrappers
replace the two TPU kernels of speech_inpainting_tpu/ops/pallas_resblock.py:
  - `fused_resblock1` (K1, `fused_resblock1` there): all S steps of a block;
  - `fused_resblock_step` (K2, `fused_resblock_step` there): one step, which
    `resblock1_forward` chains once per dilation as the JAX function of that
    name does.
On a CUDA tensor both launch csrc/resblock1.cu or raise: two launches per
residual step (conv1 into an intermediate h of layout (B, T, C) that the
wrapper allocates, then conv2 plus the residual), on the tensor cores, tiled
as `_plan` says; the source note gives the design and what bounds it. On a
CPU tensor they run `resblock1_reference` and `resblock_step_reference`, the
unfused chains of F.leaky_relu and F.conv1d that the kernels are held
against.

Both kernels are also operators of the `si` namespace of `torch.library`,
`torch.ops.si.resblock1` and `torch.ops.si.resblock_step`, so that
`torch.export` can trace a model through them (a `ctypes` call on
`data_ptr()`s cannot be traced) and an exported program launches the same
kernels: the CUDA implementation is the launcher above (with its checks and
launch count), the CPU one the plain version, the fake one `empty_like(x)`.
They are registered with `torch.library.Library`, whose per-call cost is
the dispatcher's alone (the `custom_op` decorator adds a Python layer that
costs several times more per call). models/hifigan_fast.py's K1 call goes
through the operator on the card, eager and exported alike;
`resblock1_forward` calls K2's launcher directly in eager mode, where its
90 calls per I_da vocoder call are paced by the host, and the operator
while a graph is traced.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import build
from .conv import get_padding

LRELU_SLOPE = 0.1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(_I)
# csrc/resblock1.cu's C signatures
_SIGNATURES = {
    "si_resblock1": ([_P] * 7 + [_I] * 5 + [_IP, _IP, _I, _I, _P], _I),
    "si_resblock_step": ([_P] * 7 + [_I] * 5 + [_IP, _I, _I, _P], _I),
    "si_cuda_error_string": ([_I], ctypes.c_char_p),
}

# The kernel's tiles, (output channels, positions, waves) per block, in the
# order `_plan` prefers them (larger tiles reuse each staged operand more),
# with the blocks each needs, in multiples of the card's SMs, to be taken:
# the 64 × 256 tile (up to 141 KB of shared memory, one block per SM) needs
# two waves, or its last wave leaves most SMs idle. `_smem` mirrors the
# kernel's shared-memory layout.
TILES = ((64, 256, 2), (64, 128, 1), (64, 64, 1), (32, 128, 1), (32, 64, 1),
         (16, 128, 1), (32, 32, 1))
SMS = 132                 # an H100 SXM's streaming multiprocessors
MAX_SMEM = 232448         # a Hopper block's dynamic shared memory, bytes
HALO_MAX = 64             # (K - 1)·dilation that the kernel's x prefetch holds
KERNEL_SIZES = (3, 7, 11)  # K of the kernel's instantiations (the ResBlock1
#                            sizes of every config in configs/)


class Plan(NamedTuple):
    """One residual step's two launches: both take the same tile; launch A
    (conv1, dilated) needs `smem_a` bytes, launch B (conv2) `smem_b`."""
    co_tile: int
    t_tile: int
    blocks: int           # per launch
    smem_a: int
    smem_b: int


def _smem(co_tile, t_tile, K, dilation):
    """Bytes of shared memory a launch of csrc/resblock1.cu takes: its ring
    of two slots, each the tile's weights for one 64-byte chunk of input
    channels (rows of 64·K + 16 bytes) and the time-major window (rows of
    80 bytes); or the epilogue's f32 output tile (one padding word per row)
    where that is larger. The launcher refuses any other number."""
    ring = 2 * (co_tile * (64 * K + 16) + (t_tile + (K - 1) * dilation) * 80)
    return max(ring, 4 * (co_tile * t_tile + max(co_tile, t_tile)))


@functools.lru_cache(maxsize=1024)
def _plan(B: int, C: int, T: int, K: int, dilation: int) -> Plan:
    """The tiling of one residual step: the first tile of `TILES` that
    divides C, fits in shared memory and gives each launch its waves of
    blocks (at least one block per SM); where none does, the one with the
    most blocks. The plan is the same for both types (a chunk is 64 bytes
    in either). Raises ValueError for what the kernel does not take."""
    if (C % 16 or K not in KERNEL_SIZES or dilation < 1 or B < 1 or T < 1
            or (K - 1) * dilation > HALO_MAX):
        raise ValueError(f"resblock kernel: needs C a multiple of 16, K in "
                         f"{KERNEL_SIZES}, dilation >= 1 and (K - 1)·dilation"
                         f" <= {HALO_MAX} (got B={B} C={C} T={T} K={K} "
                         f"d={dilation})")
    best = None
    for co, tt, waves in TILES:
        smem = (_smem(co, tt, K, dilation), _smem(co, tt, K, 1))
        if C % co or max(smem) > MAX_SMEM:
            continue
        plan = Plan(co, tt, B * (C // co) * math.ceil(T / tt), *smem)
        if plan.blocks >= waves * SMS:
            return plan
        if best is None or plan.blocks > best.blocks:
            best = plan
    if best is None:
        raise ValueError(f"resblock kernel: no tile fits K={K} d={dilation} "
                         f"in {MAX_SMEM} bytes of shared memory")
    return best


@functools.lru_cache(maxsize=1024)
def _plan_array(B, C, T, K, dilations):
    """The plan as csrc/resblock1.cu takes it: 6 ints per step (read, never
    written, by the kernel's launcher)."""
    vals = []
    for d in dilations:
        p = _plan(B, C, T, K, int(d))
        vals += [p.co_tile, p.t_tile, p.smem_a, p.co_tile, p.t_tile, p.smem_b]
    return (_I * len(vals))(*vals)


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
    """Refuse what the kernel does not take; returns the biases in x's
    type."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {x.dtype} is not float32 or bfloat16")
    device = x.device
    for name, t, shape in (("w1", w1, wshape), ("w2", w2, wshape),
                           ("b1", b1, bshape), ("b2", b2, bshape)):
        if t.shape != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on {device}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"{fn}: weights must have x's dtype")
    if not (x.is_contiguous() and w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError(f"{fn}: x, w1 and w2 must be contiguous")
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError(f"{fn}: w1 and w2 must be 16-byte aligned")
    if K not in KERNEL_SIZES:
        raise ValueError(f"{fn}: the kernel takes K in {KERNEL_SIZES}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError(f"{fn} has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    return b1.to(x.dtype).contiguous(), b2.to(x.dtype).contiguous()


def _launched(fn: str, lib, rc: int, shape) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: launch failed at (B, C, T, K)={shape}: "
                           f"{lib.si_cuda_error_string(rc).decode()}")


def fused_resblock1(x, w1, b1, w2, b2, dilations=(1, 3, 5)):
    """One whole ResBlock1 (K1); same arguments as `resblock1_reference`.

    x and the weights are float32 or bfloat16 (one type for all); the biases
    are taken in that type too, as F.conv1d takes them. The CUDA path sums
    in float32, rounds each conv's output to x's type as the plain chain
    does, keeps the intermediate h in x's type and returns x's type.
    Inference only: the kernel has no backward, so inputs that require grad
    are refused.
    `fused_resblock1.launches` counts kernel launches on the card: 2·S per
    call, two per residual step.
    """
    if x.device.type == "cpu":
        return resblock1_reference(x, w1, b1, w2, b2, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock1: no kernel for device {x.device}")
    return _launch_resblock1(x, w1, b1, w2, b2, dilations)


def _launch_resblock1(x, w1, b1, w2, b2, dilations):
    """K1 on the card: checks, plan, launch and count."""
    B, C, T = x.shape
    S, _, _, K = w1.shape
    if len(dilations) != S:
        raise ValueError("fused_resblock1: needs one dilation per step")
    b1, b2 = _check("fused_resblock1", x, w1, b1, w2, b2, (S, C, C, K),
                    (S, C), K)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    plan = _plan_array(B, C, T, K, tuple(int(d) for d in dilations))
    h = torch.empty((B, T, C), dtype=x.dtype, device=x.device)
    dils = (_I * S)(*(int(d) for d in dilations))
    lib = build.library("resblock1", _SIGNATURES)
    rc = lib.si_resblock1(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), h.data_ptr(), B, C, T, K, S, dils,
        plan, _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launched("fused_resblock1", lib, rc, (B, C, T, K))
    fused_resblock1.launches += 2 * S  # si_resblock1 enqueued two per step
    return out


fused_resblock1.launches = 0


def fused_resblock_step(x, w1, b1, w2, b2, dilation=1):
    """One ResBlock1 step (K2); same arguments as `resblock_step_reference`.

    Types, biases and the refusal of inputs that require grad are as for
    `fused_resblock1`. `fused_resblock_step.launches` counts kernel launches
    on the card: two per call.
    """
    if x.device.type == "cpu":
        return resblock_step_reference(x, w1, b1, w2, b2, dilation)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_resblock_step: no kernel for device {x.device}")
    return _launch_resblock_step(x, w1, b1, w2, b2, dilation)


def _launch_resblock_step(x, w1, b1, w2, b2, dilation):
    """K2 on the card: checks, plan, launch and count."""
    B, C, T = x.shape
    K = w1.shape[-1]
    if int(dilation) < 1:
        raise ValueError("fused_resblock_step: dilation must be at least 1")
    b1, b2 = _check("fused_resblock_step", x, w1, b1, w2, b2, (C, C, K),
                    (C,), K)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    plan = _plan_array(B, C, T, K, (int(dilation),))
    h = torch.empty((B, T, C), dtype=x.dtype, device=x.device)
    lib = build.library("resblock1", _SIGNATURES)
    rc = lib.si_resblock_step(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), h.data_ptr(), B, C, T, K,
        int(dilation), plan, _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launched("fused_resblock_step", lib, rc, (B, C, T, K))
    fused_resblock_step.launches += 2
    return out


fused_resblock_step.launches = 0


# the operators: the launchers on the card, the plain versions on the CPU
_LIB = torch.library.Library("si", "DEF")
_LIB.define("resblock1(Tensor x, Tensor w1, Tensor b1, Tensor w2, "
            "Tensor b2, int[] dilations) -> Tensor")
_LIB.define("resblock_step(Tensor x, Tensor w1, Tensor b1, Tensor w2, "
            "Tensor b2, int dilation) -> Tensor")
_LIB.impl("resblock1", _launch_resblock1, "CUDA")
_LIB.impl("resblock1", resblock1_reference, "CPU")
_LIB.impl("resblock_step", _launch_resblock_step, "CUDA")
_LIB.impl("resblock_step", resblock_step_reference, "CPU")


@torch.library.register_fake("si::resblock1")
def _resblock1_fake(x, w1, b1, w2, b2, dilations):
    return torch.empty_like(x)


@torch.library.register_fake("si::resblock_step")
def _resblock_step_fake(x, w1, b1, w2, b2, dilation):
    return torch.empty_like(x)


def resblock1_forward(x, block, dilations=(1, 3, 5)):
    """A whole ResBlock1 as one K2 call per dilation, the JAX package's
    `resblock1_forward`. `block` maps w1, w2 to (S, C, C, K) and b1, b2 to
    (S, C). Weight norm is already folded: convert/from_jax.py folds it once
    at load, where the JAX function folds the flax (v, g) tree on every
    call. Each step calls `fused_resblock_step`, or the operator
    `torch.ops.si.resblock_step` while `torch.export` traces."""
    step = (torch.ops.si.resblock_step if torch.compiler.is_compiling()
            else fused_resblock_step)
    for s, d in enumerate(dilations):
        x = step(x, block["w1"][s], block["b1"][s], block["w2"][s],
                 block["b2"][s], int(d))
    return x
