"""Where the port's entry points run: the CUDA card unless the caller asks
for the CPU. Without a card, an entry point raises instead of quietly running
on the CPU. `full_f32` is the numerics the entry points pin for the call;
`stage` how they take host inputs onto the device; `tensor_cache` keeps the
constant tensors that the frontends make once per device; `cast` is a
dtype cast that an exported graph records only where it casts."""
from __future__ import annotations

import contextlib
import functools

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the current CUDA device; "cpu" must be asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def full_f32():
    """Run float32 convolutions and matrix products in full float32, as the
    JAX package does at `Precision.HIGHEST`: turns off TF32 in cuDNN and
    cuBLAS (torch lets cuDNN's f32 convolutions run in TF32 by default) and
    restores the caller's flags on exit, also after an exception."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def stage(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """x (an array, a list or a tensor) as a `dtype` tensor on `device`. A
    host array bound for the card goes through pinned memory by a
    non-blocking copy on the current stream, so the caller is not held
    until the card has taken it (a pageable copy would wait for the
    stream)."""
    t = torch.as_tensor(x, dtype=dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def tensor_cache(maxsize: int):
    """functools.lru_cache for a function that makes constant tensors,
    bypassed while `torch.export` (or `torch.compile`) traces: a tensor
    made under the trace's fake mode must not outlive the trace, and is
    made anew there (the program keeps it as a constant)."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            if torch.compiler.is_compiling():
                return fn(*args)
            return cached(*args)

        call.cache_info, call.cache_clear = (cached.cache_info,
                                             cached.cache_clear)
        return call
    return wrap


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in `dtype`: t itself where it has that type already. Eager
    `t.to(dtype)` is then a no-op as well, but `torch.export` records it
    as two nodes of the program (the cast and an assertion of its input's
    metadata), which a loaded artifact runs on every call."""
    return t if t.dtype == dtype else t.to(dtype)
