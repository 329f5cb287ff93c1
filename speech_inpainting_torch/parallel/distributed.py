"""Multi-process runtime: joining the process group, the coordinator's
state on every rank, each rank's rows of a batch, and the collectives the
trainers and the inpainter issue.

Counterpart of speech_inpainting_tpu/parallel/distributed.py. The JAX
package joins one process per host to a coordination service
(`jax.distributed.initialize`), after which each jitted step is one SPMD
program over every chip and XLA inserts the gradient all-reduces. The port
runs one process per card, PyTorch's idiom:

  - `initialize` joins `torch.distributed` at tcp://--coordinator with an
    explicit rank and world size; NCCL for the card, gloo for the CPU (the
    JAX package's `cpu_collectives="gloo"`). One process is a no-op (the
    reference dist shim's works-on-one-device contract), explicit
    arguments that fail raise, and a bare call joins the group a launcher
    (torchrun's RANK / WORLD_SIZE / MASTER_ADDR) describes, or says on
    stderr why it cannot and runs single-process;
  - every rank computes the same global batch order from the shared seed
    and keeps its rows (`local_batches`: the DistributedSampler contract);
  - the steps reduce their gradients explicitly (`all_reduce_grads`: one
    coalesced all_reduce per device and type), with the reduce the loss
    asks for: a sum for the I_ea trainer's summed losses, a mean for the
    GAN and f0-VQ losses, which are means over equal row counts.

Launch recipe (N processes, one per card; the same command everywhere but
--process-id)::

    python -m speech_inpainting_torch.cli.train_hifigan ... \\
        --coordinator host0:1234 --num-processes N --process-id i

or `torchrun --nproc-per-node N -m speech_inpainting_torch.cli.train_hifigan
... --mesh`, whose environment a bare `initialize()` reads. On the CPU
(`--device cpu`) the ranks talk over gloo, as the tests do.

Gloo carries only broadcast and all_reduce for CUDA tensors, so that two
ranks can share one card over gloo, every collective here is one of those
two: a gather of rows is an all_reduce of a zeroed buffer in which each
rank wrote its own rows (`all_gather_rows`).
"""
from __future__ import annotations

import functools
import os
import socket
import sys
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from .mesh import (data_index, data_spec, free_port, make_mesh, mesh_device,
                   rank, require_group, rows, tree_map, world_size)


def _local_index(process_id: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(torch.cuda.device_count(), 1)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device="cuda") -> bool:
    """Join the process group; a no-op in one process. Returns True when
    this process is one of several. `device` says where the ranks compute:
    a CUDA device joins over NCCL (each rank on card LOCAL_RANK, else
    process_id modulo the cards it sees), the CPU over gloo. With every
    argument None, a launcher's environment (torchrun's) is joined where
    there is one."""
    if num_processes is not None and num_processes <= 1:
        return False                   # the dist.py:21-24 contract
    bare = (coordinator_address is None and num_processes is None
            and process_id is None)
    if not bare and (coordinator_address is None or num_processes is None
                     or process_id is None):
        raise ValueError(
            "a multi-process run needs coordinator_address, num_processes "
            "and process_id (--coordinator, --num-processes, "
            f"--process-id), got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if bare and not _cluster_env():
        return False
    cuda = torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    try:
        if bare:
            rank_ = int(os.environ["RANK"])
            if cuda:
                torch.cuda.set_device(_local_index(rank_))
            dist.init_process_group(backend, init_method="env://")
        else:
            if cuda:
                torch.cuda.set_device(_local_index(process_id))
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                rank=process_id, world_size=num_processes)
    except (KeyError, RuntimeError, ValueError) as e:
        if bare:
            # a launcher-like environment that does not describe a group
            # (a stray RANK, no MASTER_ADDR): joining is impossible, and
            # the degrade is loud, since N silent single-process jobs
            # would train divergent models
            print("[distributed] cluster-like env detected but bare "
                  f"autodetect failed ({type(e).__name__}: {e}); running "
                  "single-process. If this process IS one of several, pass "
                  "explicit coordinator_address/num_processes/process_id.",
                  file=sys.stderr, flush=True)
            return False
        raise
    return dist.get_world_size() > 1


def join_world_of_one(device="cuda") -> None:
    """Join a process group of one rank on a free localhost port (NCCL for
    a CUDA device, else gloo), unless this process is in a group already:
    what a mesh needs in one process, so that its collectives are the real
    ones."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)


def _cluster_env() -> bool:
    """True where a launcher's variables are set (torchrun, Slurm through
    torchrun): a false positive costs the stderr degrade above, a false
    negative would train N disjoint single-process jobs."""
    return any(k in os.environ for k in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
        "TORCHELASTIC_RUN_ID"))


def is_coordinator() -> bool:
    """Rank 0: the only one that writes checkpoints, logs and TensorBoard
    media (the reference gates on rank == 0, I_ea/hifi_gan/train.py:47-50)."""
    return rank() == 0


# ------------------------------------------------------------ collectives

def _comm_device(t: torch.Tensor) -> torch.device:
    """NCCL moves CUDA tensors only; gloo takes either."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (its storage), else t."""
    return t.to_local() if hasattr(t, "to_local") else t


def _coalesced(tensors: Sequence[torch.Tensor], op) -> None:
    """op(buffer) on one flat buffer per (device, type) of `tensors`, then
    the results copied back into them."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for (_, dtype), ts in groups.items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([t.detach().reshape(-1).to(wire) for t in ts])
        flat = flat.to(_comm_device(flat))
        op(flat)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view(t.shape).to(t.device, dtype))
            off += n


def _src(group) -> int:
    return 0 if group is None else dist.get_global_rank(group, 0)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """The group's first rank's values into `tensors`, in place. Without a
    process group, nothing to do; in a group of one, the collective still
    runs (the code path of many)."""
    if not dist.is_initialized() or not tensors:
        return
    src = _src(group)
    _coalesced([local_shard(t) for t in tensors],
               lambda flat: dist.broadcast(flat, src=src, group=group))


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor], group=None,
                average: bool = False) -> None:
    """The sum (or mean) over the group's ranks, in place, in one
    all_reduce per device and type (gloo has no AVG: the mean divides the
    sum). Without a process group, nothing to do; in a group of one, the
    collective still runs."""
    if not dist.is_initialized() or not tensors:
        return
    n = dist.get_world_size(group)

    def op(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if average:
            flat.div_(n)

    _coalesced([local_shard(t) for t in tensors], op)


def all_reduce_grads(params: Iterable[torch.Tensor], group=None, *,
                     average: bool) -> None:
    """The gradient reduction XLA inserts for a batch sharded over `group`:
    each parameter's `.grad` summed (or averaged) over the ranks, as one
    coalesced all_reduce. A parameter without a gradient gets zeros first,
    so that every rank reduces the same buffers. The reduce follows the
    loss: its sum over the rows for a summed loss, the mean over ranks for
    a mean over equal row counts."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_([p.grad for p in params], group, average)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated on dim 0 in rank order,
    on every rank: each rank writes its rows into a zeroed buffer of the
    whole, and one all_reduce sums the buffers (gloo gathers no CUDA
    tensor; adding zeros leaves each row exact)."""
    n = 1 if world_size() == 1 else dist.get_world_size(group)
    if n == 1:
        return x
    i = dist.get_group_rank(group, dist.get_rank()) if group is not None \
        else dist.get_rank()
    out = x.new_zeros((n * x.shape[0], *x.shape[1:]))
    out[i * x.shape[0]:(i + 1) * x.shape[0]] = x
    all_reduce_([out], group)
    return out


def reduce_metrics(metrics: dict, group=None, sums: Sequence[str] = ()
                   ) -> dict:
    """A step's 0-dim tensor metrics over the ranks: those named in `sums`
    summed, the others averaged (the JAX step's over the global batch,
    for equal row counts). Other values pass unchanged."""
    if not dist.is_initialized():
        return metrics
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0]
    if not keys:
        return metrics
    vals = torch.stack([metrics[k].float() for k in keys])
    all_reduce_([vals], group)
    n = dist.get_world_size(group)
    out = dict(metrics)
    for k, v in zip(keys, vals):
        out[k] = (v if k in sums else v / n).to(metrics[k].dtype)
    return out


# ------------------------------------------------------------- meshes

def data_group(mesh: DeviceMesh):
    """The process group over which a batch on `mesh` is sharded: the dp
    axis's, or, where the batch shards over every axis (the hybrid mesh,
    which spans every rank), the whole group's."""
    spec = data_spec(mesh)
    if len(spec) == 1:
        return mesh.get_group(spec[0])
    if mesh.mesh.numel() != world_size():
        raise ValueError("a mesh without a dp axis must span every rank")
    return dist.group.WORLD


def make_global_mesh(axes: Sequence[tuple] = (("dp", -1),), *,
                     device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over every rank of the group (make_mesh's default)."""
    return make_mesh(axes, device_type=device_type)


def _host_key() -> str:
    """The rank's host: torchrun's node rank where set, else its name."""
    return os.environ.get("GROUP_RANK") or socket.gethostname()


def make_hybrid_mesh(ici_axes: Sequence[tuple] = (("ici", -1),),
                     dcn_axis: str = "dcn", *,
                     device_type: Optional[str] = None) -> DeviceMesh:
    """A (dcn, *ici) mesh: the slow axis across hosts, the fast axes over
    the ranks inside one host (NVLink), as the JAX package groups by
    process. Hosts are ranked by key, ranks inside one in rank order; every
    host must hold as many ranks. The training loops shard the batch over
    every axis of a mesh without a dp axis (mesh.data_spec)."""
    device_type = resolve_device(device_type).type
    require_group()
    keys = [None] * world_size()
    if world_size() > 1:
        dist.all_gather_object(keys, _host_key())
    else:
        keys = [_host_key()]
    hosts = sorted(set(keys))
    by_host = [[r for r, k in enumerate(keys) if k == h] for h in hosts]
    sizes = {len(g) for g in by_host}
    if len(sizes) != 1:
        raise ValueError(f"uneven hosts: {sorted(sizes)} ranks")
    per = sizes.pop()
    names = [dcn_axis] + [n for n, _ in ici_axes]
    ici = [s for _, s in ici_axes]
    fixed = int(np.prod([s for s in ici if s != -1]))
    ici = [per // fixed if s == -1 else s for s in ici]
    if int(np.prod(ici)) != per:
        raise ValueError(f"ici sizes {ici} do not lay out {per} ranks")
    return DeviceMesh(device_type,
                      torch.tensor(by_host).reshape([len(hosts)] + ici),
                      mesh_dim_names=tuple(names))


def shard_host_batch(mesh: DeviceMesh, batch):
    """This process's rows of the global batch (local_batches has cut
    them), placed on its device: each rank is the one process of its
    shard, so placing is all there is (JAX assembles a global array
    here)."""
    device = mesh_device(mesh)
    return tree_map(lambda x: torch.as_tensor(x).to(device), batch)


def local_batches(batches, mesh: Optional[DeviceMesh] = None):
    """Each global batch cut to THIS rank's rows (the DistributedSampler
    contract: every rank computes the same batch order from the shared
    seed). With a mesh, the rows of this rank's coordinate on its data
    axes (tp ranks of one dp shard take the same rows); without, rows by
    rank. One shard: passthrough."""
    if mesh is not None:
        index, count = data_index(mesh)
    else:
        index, count = rank(), world_size()
    if count == 1:
        yield from batches
        return
    for batch in batches:
        yield tree_map(lambda x: rows(x, index, count), batch)


# ------------------------------------------------ the coordinator's state

class _Slot:
    """Where the i-th tensor of a state dict sits in its layout."""

    def __init__(self, i: int):
        self.i = i


def _split(obj, tensors: list):
    """obj's layout, its tensors appended to `tensors` and replaced by
    slots."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return _Slot(len(tensors) - 1)
    if isinstance(obj, dict):
        return {k: _split(v, tensors) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_split(v, tensors) for v in obj)
    return obj


def _fill(obj, tensors: list):
    if isinstance(obj, _Slot):
        return tensors[obj.i]
    if isinstance(obj, dict):
        return {k: _fill(v, tensors) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_fill(v, tensors) for v in obj)
    return obj


def sync_from_coordinator(state):
    """Rank 0's state on every rank: the broadcast DDP makes when it wraps
    a model (I_ea/hifi_gan/train.py:82-85). `state` has state_dict() and
    load_state_dict() (a train state: parameters, buffers, optimizer
    moments and counts, guards, step, rng; or a module). Run after a
    checkpoint restore: a rank whose checkpoint directory is stale or not
    shared would otherwise train from other weights. Rank 0 sends the
    layout (which holds every non-tensor value) and its tensors' shapes as
    an object, then the tensors in coalesced broadcasts. No-op in one
    process."""
    if world_size() == 1:
        return state
    tensors: list = []
    layout = _split(state.state_dict(), tensors)
    box = [(layout, [(t.shape, t.dtype, t.device.type == "cpu")
                     for t in tensors])]
    dist.broadcast_object_list(box, src=0)
    layout, meta = box[0]
    if rank() != 0:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.cuda.is_available() and torch.cuda.is_initialized()
               else torch.device("cpu"))
        tensors = [torch.empty(shape, dtype=dtype,
                               device="cpu" if cpu else dev)
                   for shape, dtype, cpu in meta]
    broadcast_(tensors)
    if rank() != 0:
        state.load_state_dict(_fill(layout, tensors))
    return state


# ----------------------------------------------------------------- CLIs

def add_cli_args(parser) -> None:
    """The multi-host launch flags every training CLI shares."""
    g = parser.add_argument_group("multi-host")
    g.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (omit under torchrun: "
                        "read from its environment)")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)


def data_parallel_mesh(flag: bool, device) -> Optional[DeviceMesh]:
    """The CLIs' --mesh: a dp mesh over every rank of the group on
    `device`'s type (in one process with no group, a group of one is
    joined first), or None without the flag."""
    if not flag:
        return None
    join_world_of_one(device)
    mesh = make_mesh(device_type=torch.device(device).type)
    if is_coordinator():
        print(f"data-parallel over {world_size()} ranks", flush=True)
    return mesh


def leaves_no_group(main):
    """A CLI's main that destroys, when it returns or raises, the process
    group it joined (the multi-host flags, --mesh); a group its caller had
    joined stays."""
    @functools.wraps(main)
    def run(*args, **kwargs):
        joined = dist.is_initialized()
        try:
            return main(*args, **kwargs)
        finally:
            if not joined and dist.is_initialized():
                dist.destroy_process_group()
    return run


def initialize_from_args(args) -> bool:
    """initialize() from parsed CLI flags (and their --device); True when
    this process is one of several."""
    return initialize(getattr(args, "coordinator", None),
                      getattr(args, "num_processes", None),
                      getattr(args, "process_id", None),
                      device=getattr(args, "device", "cuda"))


__all__ = ["initialize", "initialize_from_args", "add_cli_args",
           "is_coordinator", "local_batches", "make_global_mesh",
           "make_hybrid_mesh", "shard_host_batch", "sync_from_coordinator",
           "all_reduce_grads", "all_reduce_", "broadcast_",
           "all_gather_rows", "reduce_metrics", "data_group", "local_shard",
           "data_parallel_mesh", "join_world_of_one", "leaves_no_group"]
