"""Device meshes and batch placement over torch.distributed.

Counterpart of speech_inpainting_tpu/parallel/mesh.py. The JAX package runs
one process per host over every local chip, and a mesh is an array of those
chips; the port runs one process per card (a rank), and a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the process
group, with the JAX package's axis names (`dp`, `tp`, `dcn`/`ici`) and its
`-1` rule for sizes. Each rank holds its own rows of a batch sharded on the
data axes and a whole copy of what is replicated; the gradient all-reduces
that XLA inserts are explicit (parallel/distributed.py:all_reduce_grads).

Placements are DTensor's: `data_sharding` gives `Shard(0)` on the data axes
and `Replicate()` elsewhere, `replicated` `Replicate()` on every axis.

A mesh is made over a process group that the caller joined
(parallel/distributed.py: `initialize`, or `join_world_of_one`, which the
CLIs' --mesh calls in one process). Its ranks' tensors live on the card
unless the caller asks for the CPU (`device_type="cpu"`), whatever the
group's backend: two ranks that share one card talk over gloo and compute
on the card. At world size 1 every helper here is the identity on the
mesh's device.
"""
from __future__ import annotations

import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..device import resolve_device


def free_port() -> int:
    """A TCP port free on localhost now (for a group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(axes: Sequence[tuple] = (("dp", -1),), devices=None, *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh from (name, size) pairs; size -1 absorbs the remainder.

    `devices` are the global ranks laid out (default: every rank of the
    group, in order), so make_mesh((("dp", -1), ("tp", 2))) puts the two
    ranks of a tp pair next to each other. `device_type` is where the
    ranks' tensors live: the card (None, "cuda") or, asked for, the CPU
    ("cpu"). Needs a process group (parallel.distributed.initialize)."""
    device_type = resolve_device(device_type).type
    require_group()
    ranks = list(range(world_size())) if devices is None else list(devices)
    names = [n for n, _ in axes]
    sizes = [s for _, s in axes]
    n = len(ranks)
    fixed = int(np.prod([s for s in sizes if s != -1]))
    sizes = [n // fixed if s == -1 else s for s in sizes]
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh sizes {sizes} do not lay out {n} ranks")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(sizes),
                      mesh_dim_names=tuple(names))


def require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: join one first "
            "(parallel.distributed.initialize, or join_world_of_one in one "
            "process; the CLIs' --mesh does this)")


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def on_mesh(device: torch.device, mesh: DeviceMesh) -> torch.device:
    """`device` (resolved) as this rank's device on `mesh`; a device other
    than the mesh's raises."""
    want = mesh_device(mesh)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device != want:
        raise ValueError(f"device {device} is not the mesh's ({want})")
    return want


def data_spec(mesh: DeviceMesh) -> tuple:
    """The axes the batch dimension shards over: ("dp",) when the mesh has
    a dp axis (beside tp etc.), else every axis, which makes the hybrid
    ("dcn", "ici") mesh trainable as it is."""
    names = tuple(mesh.mesh_dim_names)
    return ("dp",) if "dp" in names else names


def data_sharding(mesh: DeviceMesh, axis: Optional[str] = None) -> tuple:
    """Placements of a batch: Shard(0) on `axis` (None: data_spec's axes),
    Replicate() on the others."""
    spec = (axis,) if axis is not None else data_spec(mesh)
    return tuple(Shard(0) if n in spec else Replicate()
                 for n in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(),) * mesh.ndim


def data_index(mesh: DeviceMesh, axis: Optional[str] = None) -> tuple:
    """(this rank's index among the data shards, their count): its
    coordinate on the data axes, row-major."""
    spec = (axis,) if axis is not None else data_spec(mesh)
    coord = mesh.get_coordinate()
    idx, count = 0, 1
    for name, c in zip(mesh.mesh_dim_names, coord):
        if name in spec:
            size = mesh.size(mesh.mesh_dim_names.index(name))
            idx, count = idx * size + c, count * size
    return idx, count


def tree_map(fn, tree):
    """fn over the tensor and array leaves of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def rows(x, index: int, count: int):
    """Rows [index·B/count, (index+1)·B/count) of x's first dimension."""
    b = x.shape[0]
    if b % count:
        raise ValueError(f"global batch {b} not divisible by {count} "
                         "data shards")
    per = b // count
    return x[index * per:(index + 1) * per]


def _on(device: torch.device):
    return lambda x: torch.as_tensor(x).to(device)


def shard_batch(mesh: DeviceMesh, batch, axis: Optional[str] = None):
    """This rank's rows of a global (host) batch, on its device: the batch
    dimension cut over `axis` (None: the mesh's data axes)."""
    index, count = data_index(mesh, axis)
    put = _on(mesh_device(mesh))
    return tree_map(lambda x: put(rows(x, index, count)), batch)


def replicate(mesh: DeviceMesh, tree):
    """Rank 0's copy of `tree` on every rank, on each rank's device: tensors
    and arrays are returned anew; a module's parameters and buffers are
    overwritten in place and the module returned."""
    from .distributed import broadcast_

    device = mesh_device(mesh)
    if isinstance(tree, torch.nn.Module):
        tree.to(device)
        broadcast_([*tree.parameters(), *tree.buffers()])
        return tree
    out = tree_map(lambda x: torch.as_tensor(x).to(device).clone(), tree)
    leaves = []
    tree_map(leaves.append, out)
    broadcast_(leaves)
    return out


__all__ = ["make_mesh", "mesh_device", "on_mesh", "data_spec",
           "data_sharding", "replicated", "data_index", "shard_batch",
           "replicate", "free_port", "require_group"]
