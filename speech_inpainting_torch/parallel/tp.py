"""Tensor parallelism for the HuBERT transformer: Megatron's intra-layer
split of the attention and MLP blocks over a `tp` mesh axis.

Counterpart of speech_inpainting_tpu/parallel/tp.py, whose rules name the
parameters to shard; here they name the same parameters in the port's
module names, as DTensor placements of a torch Linear's (out, in) weight:

  - q/k/v projections: output (head) rows sharded, Shard(0) on weight and
    bias: each rank computes num_heads / tp whole heads (SelfAttention
    counts its heads from the projection's width);
  - out_proj and the MLP's output_dense: input columns sharded, Shard(1):
    each rank holds a partial sum, which one all_reduce over tp completes
    (DTensor's RowwiseParallel, the Megatron g);
  - the MLP's intermediate_dense: output rows sharded (GELU applies on the
    rank's rows);
  - everything else (the conv frontend, LayerNorms, pos-conv, head)
    replicated, a plain tensor on every rank.

`shard_params` turns the matched Linear modules into ColwiseParallel /
RowwiseParallel ones on the mesh's tp axis, each rank keeping its slice of
the weights it holds (which `sync_from_coordinator` made equal), so no
collective runs at placement. It composes with data parallelism on the
same mesh: the batch shards over dp, and the steps reduce the gradients
over dp only (a tp pair sees the same rows). num_attention_heads and
intermediate_size must divide by the tp size. The int8 serving encoder
(ops/int8.py) is refused: the JAX package's rules name float kernels.
"""
from __future__ import annotations

import re

from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard
from torch.distributed.tensor.parallel import (ColwiseParallel,
                                               RowwiseParallel,
                                               parallelize_module)

# First match wins; unmatched parameters replicate. Names are the port's
# dotted parameter names (models/hubert.py).
TP_RULES = (
    (re.compile(r"attention\.(q|k|v)_proj\.weight$"), Shard(0)),
    (re.compile(r"attention\.(q|k|v)_proj\.bias$"), Shard(0)),
    (re.compile(r"attention\.out_proj\.weight$"), Shard(1)),
    (re.compile(r"feed_forward\.intermediate_dense\.weight$"), Shard(0)),
    (re.compile(r"feed_forward\.intermediate_dense\.bias$"), Shard(0)),
    (re.compile(r"feed_forward\.output_dense\.weight$"), Shard(1)),
)


def tp_spec(name: str, axis: str = "tp") -> dict:
    """{mesh axis: placement} of one parameter ({} when replicated)."""
    for pat, placement in TP_RULES:
        if pat.search(name):
            return {axis: placement}
    return {}


def tp_specs(model: nn.Module, axis: str = "tp") -> dict:
    """{parameter name: tp_spec} over `model`'s parameters."""
    return {n: tp_spec(n, axis) for n, _ in model.named_parameters()}


def check_tp(cfg, mesh: DeviceMesh, axis: str = "tp") -> None:
    """The head is the unit of the split: heads and the MLP's hidden width
    must divide by the tp size; the int8 encoder is not split."""
    if getattr(cfg, "int8", False):
        raise ValueError("tensor parallelism splits the float dense layers; "
                         "the int8 encoder (ops/int8.py) is not split")
    tp = mesh.size(mesh.mesh_dim_names.index(axis))
    for name in ("num_attention_heads", "intermediate_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} not divisible by "
                             f"tp={tp}")


def shard_params(mesh: DeviceMesh, model: nn.Module, axis: str = "tp"
                 ) -> nn.Module:
    """Split `model`'s matched Linear modules over the mesh's `axis`
    (in place; returns the model). Every rank must hold the same weights
    beforehand: each keeps its slice of its own copy."""
    from ..ops.int8 import Int8Linear

    plan = {}
    for name, module in model.named_modules():
        spec = tp_spec(f"{name}.weight", axis)
        if not spec:
            continue
        if isinstance(module, Int8Linear):
            raise ValueError(f"{name}: the int8 encoder is not split")
        plan[name] = (ColwiseParallel() if spec[axis] == Shard(0)
                      else RowwiseParallel())
    tp_mesh = mesh[axis] if mesh.ndim > 1 else mesh
    return parallelize_module(model, tp_mesh, plan, src_data_rank=None)


__all__ = ["TP_RULES", "tp_spec", "tp_specs", "check_tp", "shard_params"]
