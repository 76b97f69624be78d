"""Process groups and the data-parallel mesh (port of
`optispeech_tpu/parallel/mesh.py`).

One process per device. `init_distributed` joins the `torch.distributed`
group that `python -m torch.distributed.run` describes in the environment:
NCCL on the card (`cuda:{LOCAL_RANK}`), gloo on the CPU. The mesh is a
`DeviceMesh` whose axes named `*data*` (`data`, and `dcn_data` on a hybrid
mesh) carry the batch; every rank holds the whole model and its own shard of
the global batch (`shard_batch`, or a loader built with `shard_id=rank,
num_shards=world`).

The train step takes its gradients with `torch.autograd.grad`, so no DDP
reducer hook ever fires: `all_reduce_grads` sums them over the data axes
itself, one flattened buffer per dtype and turn, before the optimiser
clips and applies them. The losses are each rank's share of the global
batch's loss (global token counts, per-item means over the world size,
`models/losses.py`), so the summed gradient is the gradient of the loss
over the global batch, as in JAX's sharded step; `reduce_logs` sums the
shares into the logged values.
"""

import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

# the variables `python -m torch.distributed.run` sets for every worker
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
LAUNCH_HINT = ("python -m torch.distributed.run --standalone --nproc_per_node N "
               "-m optispeech_tpu_torch.cli.train --distributed ...")
# log keys every rank computes from the reduced gradient: the same on every rank
REPLICATED_LOG_PREFIXES = ("grad_norm/",)


def init_distributed(device=None, backend: Optional[str] = None,
                     timeout_s: float = 300) -> torch.device:
    """Join the process group that the launcher's environment describes and
    return this rank's device: `cuda:{LOCAL_RANK}` (or the CUDA device
    given) under NCCL, the CPU under gloo for `device="cpu"`. `backend`
    overrides the choice ("gloo" takes CUDA tensors too, staged through the
    host). A collective that waits longer than `timeout_s` raises.

    Raises when the environment is missing: there is no fallback to one
    process, and none from NCCL to gloo."""
    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"a distributed run needs {', '.join(missing)} in the environment; "
                           f"start it with `{LAUNCH_HINT}`")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        dev = torch.device("cpu")
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' (--device cpu) "
                               "to train over gloo on the CPU")
        dev = torch.device(device) if device is not None else torch.device("cuda")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError("a process group of another rank or size is already initialised")
        return dev
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _require_group():
    if not dist.is_initialized():
        raise RuntimeError(f"no process group: call init_distributed first (`{LAUNCH_HINT}`)")


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data"):
    """The 1-D `data` mesh over every rank of the group. `num_devices`, when
    given, must equal the world size: JAX trims its mesh as a
    single-process debug knob, which has no meaning with one process per
    device."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices} but the group has {world} ranks: the mesh "
                         "spans every process (one per device); trimming it is a "
                         "single-process debug knob of the JAX package")
    return init_device_mesh(_mesh_device_type(), (world,), mesh_dim_names=(axis_name,))


def make_hybrid_mesh(num_slices: int, axis_names=("dcn_data", "data")):
    """The 2-D data mesh of a multi-slice run: `num_slices` rows on the outer
    axis, the ranks of a slice on the inner one. Gradients are summed over
    the inner axis, then across the rows."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    world = dist.get_world_size()
    if world % num_slices:
        raise ValueError(f"{world} devices not divisible by {num_slices} slices")
    return init_device_mesh(_mesh_device_type(), (num_slices, world // num_slices),
                            mesh_dim_names=tuple(axis_names))


def data_axes(mesh) -> list[str]:
    """The mesh's axes that carry the batch: every axis whose name holds
    "data" (JAX's `data_sharding` rule)."""
    return [a for a in mesh.mesh_dim_names if "data" in a]


def data_size(mesh) -> int:
    """Ranks over which the batch is split (1 without a mesh)."""
    if mesh is None:
        return 1
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in data_axes(mesh))


def data_rank(mesh) -> int:
    """This rank's place among the batch's shards, row-major over the data
    axes (0 without a mesh)."""
    if mesh is None:
        return 0
    coord = mesh.get_coordinate()
    index = 0
    for a in data_axes(mesh):
        dim = mesh.mesh_dim_names.index(a)
        index = index * mesh.size(dim) + coord[dim]
    return index


def mean_share(mean: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of a mean over the global batch, given the mean
    over its own shard: every shard holds as many items, so it is the mean
    over the world size (the mean itself without a group of several)."""
    world = data_size(mesh)
    return mean if world == 1 else mean / world


def all_reduce_sum(tensor: torch.Tensor, mesh) -> torch.Tensor:
    """Sum `tensor` in place over the mesh's data axes, the inner axis
    first; returns it."""
    for axis in reversed(data_axes(mesh)):
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return tensor


def _coalesced(tensors: list, collective) -> list:
    """Run `collective` on one flat buffer per dtype holding `tensors`, and
    return the tensors' values read back from the buffers (views)."""
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        for i, piece in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = piece.view_as(tensors[i])
    return out


def all_reduce_grads(grads, mesh) -> list:
    """The gradients (a list as `torch.autograd.grad` returns it, None for an
    unused parameter) summed over the data axes: one collective per dtype
    and axis, not one per tensor. None stays None (every rank runs the same
    graph, so the same parameters are unused everywhere)."""
    present = [i for i, g in enumerate(grads) if g is not None]
    reduced = _coalesced([grads[i].detach() for i in present],
                         lambda flat: all_reduce_sum(flat, mesh))
    out = list(grads)
    for i, g in zip(present, reduced):
        out[i] = g
    return out


def reduce_logs(logs: dict, mesh) -> dict:
    """The global values of a step's 0-d logs: the per-rank shares of the
    losses summed in one stacked all-reduce; `grad_norm/*`, computed from
    the reduced gradient, kept as they are."""
    if mesh is None or not logs:
        return logs
    shared = [k for k in logs if not k.startswith(REPLICATED_LOG_PREFIXES)]
    if not shared:
        return logs
    total = all_reduce_sum(torch.stack([logs[k].detach().float().reshape(()) for k in shared]),
                           mesh)
    return {**logs, **dict(zip(shared, total.unbind()))}


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch: the batch dimension split evenly
    over the data axes. Entries without a shape (texts, None) pass through."""
    n, r = data_size(mesh), data_rank(mesh)
    for k, v in batch.items():
        if v is not None and getattr(v, "shape", None) and v.shape[0] % n:
            raise ValueError(f"batch dim {v.shape[0]} of `{k}` is not divisible by the "
                             f"{n}-device mesh; set data.batch_size to a multiple of the "
                             "device count")

    def rows(v):
        if v is None or not getattr(v, "shape", None):
            return v
        local = v.shape[0] // n
        return v[r * local:(r + 1) * local]

    return {k: rows(v) for k, v in batch.items()}


def replicate_state(state, mesh):
    """Broadcast rank 0's parameters and buffers of the state's generator and
    discriminator to every rank of the data axes (outer axis first), in
    place; returns the state."""
    modules = [state.generator, state.discriminator]
    tensors = [t for m in modules for t in [*m.parameters(), *m.buffers()]]
    with torch.no_grad():
        for axis in data_axes(mesh):
            group = mesh.get_group(axis)
            src = dist.get_global_rank(group, 0)
            values = _coalesced([t.detach() for t in tensors],
                                lambda flat: dist.broadcast(flat, src=src, group=group))
            for t, v in zip(tensors, values):
                t.copy_(v)
    return state


def parameter_digest(modules) -> str:
    """sha256 of the modules' parameters and buffers, bytes in order."""
    import hashlib

    h = hashlib.sha256()
    for m in modules:
        for name, t in [*m.named_parameters(), *m.named_buffers()]:
            h.update(name.encode())
            h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_replicas(state) -> str:
    """The digest of this rank's G and D (`parameter_digest`), gathered from
    every rank of the group; raises when any rank's differs (the replicas
    drifted apart). Returns the digest."""
    digest = parameter_digest([state.generator, state.discriminator])
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, digest)
    if len(set(digests)) != 1:
        raise RuntimeError(f"the ranks' parameters differ: digests {digests}")
    return digest


def exit_barrier():
    """Every rank waits here for the others, under the group's timeout:
    gloo's `monitored_barrier` (which names a rank that never came), NCCL's
    `barrier`. A timeout raises."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier()
    else:
        dist.barrier()
