"""The (data, model) device mesh over ``torch.distributed`` (port of
``fashionvisualexpl_tpu/core/mesh.py``).

The JAX package drives every device of a 2-axis ``jax.sharding.Mesh``
from one controller through ``shard_map``.  The port runs one process (a
rank) per mesh position:

- ``data``  — the batch axis (data parallelism over BPR triple batches);
- ``model`` — the embedding-table row axis (row-sharded tables).

Rank ``r`` sits at ``(data = r // model, model = r % model)``, as
``make_mesh``'s ``reshape(data, model)`` lays the devices out in JAX.  Each
axis gets a process subgroup (``dist.new_group``) for the collectives over
that axis: ``psum`` is ``all_reduce(SUM)`` over the axis group and
``all_gather`` stacks the axis's tensors in axis order.  The JAX specs and
shardings (``replicated``, ``batch_sharding``, ``row_sharding``) become a
per-name rule, ``parallel/spmd.py::param_spec_tree``: a table is row-sharded
or replicated.

Backends: ``nccl`` when every rank has a card of its own; ``gloo`` when
ranks share a card (NCCL refuses two ranks on one device) and on the CPU.
Gloo has no ``all_gather`` for CUDA tensors, so under gloo a CUDA tensor's
gather is staged through pinned host memory, explicitly: the staging is the
declared transport of the shared-card layout, ``staged_bytes`` counts its
bytes (device to host plus host to device) by collective, and nothing is
computed on the host.  An axis of size 1 needs no collective and skips it
under gloo; under nccl it runs (a one-rank communicator), so a one-rank
nccl mesh still exercises the route.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import torch
import torch.distributed as dist

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

# bytes that gloo's all_gather of CUDA tensors moved through pinned host
# memory (see the module docstring), by collective
staged_bytes: Counter = Counter()


class Mesh:
    """One rank's view of a (data, model) mesh: the axis sizes
    (``shape[axis]``), this rank's coordinates (``axis_index``), its device
    and the process subgroup of each axis (None without
    ``torch.distributed``)."""

    def __init__(self, data: int, model: int, rank: int, device: torch.device,
                 groups: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.rank = rank
        self.device = device
        self.groups = groups or {}
        self.backend = backend
        self._coords = {DATA_AXIS: rank // model, MODEL_AXIS: rank % model}

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def is_primary(self) -> bool:
        """The rank that writes logs, checkpoints and dumps."""
        return self.rank == 0

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        return self._coords[axis]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend})")


def make_mesh(data: int = -1, model: int = 1, device: DeviceLike = None) -> Mesh:
    """This rank's (data, model) mesh over every process of the
    ``torch.distributed`` group (one process when none is initialized).
    ``data=-1`` absorbs all remaining ranks.  Every rank must call it, in
    the same order as any other ``new_group``: it creates the axis
    groups.  ``device`` is this rank's (``None`` = its CUDA card)."""
    ready = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if ready else 1
    rank = dist.get_rank() if ready else 0
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    dev = resolve_device(device)
    if not ready:
        return Mesh(data, model, rank, dev)
    groups = {}
    for j in range(model):  # the data axis: one group per model column
        ranks = [i * model + j for i in range(data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[DATA_AXIS] = g
    for i in range(data):  # the model axis: one group per data row
        ranks = [i * model + j for j in range(model)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[MODEL_AXIS] = g
    return Mesh(data, model, rank, dev, groups, dist.get_backend())


def single_device_mesh(device: DeviceLike = None) -> Mesh:
    return Mesh(1, 1, 0, resolve_device(device))


def is_trivial(mesh: Mesh) -> bool:
    return mesh.size == 1


def axis_index(mesh: Mesh, axis: str) -> int:
    return mesh.axis_index(axis)


def _skips(mesh: Mesh, axis: str) -> bool:
    """No collective over ``axis``: one rank on it (and not nccl), or no
    process group at all."""
    return axis not in mesh.groups or (mesh.shape[axis] == 1 and mesh.backend != "nccl")




def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``jax.lax.psum``), as a new
    tensor on ``x``'s device; ``x`` itself when the axis needs no
    collective."""
    if _skips(mesh, axis):
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.groups[axis])  # gloo takes CUDA tensors here
    return out


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[axis size, *x.shape]: every rank's ``x`` on ``axis``, in axis order
    (``jax.lax.all_gather``), on ``x``'s device."""
    if _skips(mesh, axis):
        return x[None]
    x = x.detach().contiguous()
    n = mesh.shape[axis]
    if mesh.backend == "gloo" and x.is_cuda:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        out = torch.empty((n, *x.shape), dtype=x.dtype, pin_memory=True)
        dist.all_gather(list(out.unbind(0)), host, group=mesh.groups[axis])
        staged_bytes["all_gather"] += host.nbytes + out.nbytes
        return out.to(x.device)
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x, group=mesh.groups[axis])
    return out


def broadcast_object(obj, mesh: Mesh):
    """The primary's ``obj`` on every rank (e.g. the metrics it computed)."""
    if mesh.size == 1 or not mesh.groups:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
