"""SPMD training engine: row-sharded tables over a (data, model) mesh
(port of ``fashionvisualexpl_tpu/parallel/spmd.py``).

Each rank holds the row shard of every table that the model's
``row_sharded_params()`` names (padded with zero rows to the model-axis
multiple, ``pad_rows_to_multiple``) and a copy of every other parameter,
and it trains on its ``data`` slice of the global triple batch, which every
rank draws whole from the same seed:

- **Lookup** (``collective_take``): each model rank gathers the rows of the
  global id batch that it owns (a masked local gather), and ``psum`` over
  ``model`` assembles the whole embeddings, replicated across the model
  axis, so every model rank computes the same loss.  Its backward is the
  masked local scatter of the replicated cotangent: each row's gradient
  reaches its one owner once.  (``torch.distributed.nn``'s ``all_reduce``
  would sum the cotangent again over ``model`` and multiply it by the axis
  size.)
- **Gradients**: one ``psum`` over ``data`` (the loss rides the same
  buffer).  Whole-matrix regularization terms are pre-scaled by 1/|data|
  through the model's ``global_reg_scale`` so the reduction counts them
  once.
- **Update**: TF-parity Adam, elementwise, on each rank's own shard and
  replicated copies; no optimizer traffic.

Pad ids are never sampled, so padded rows stay zero (Adam's decay of zero
moments is a no-op).  The generic engine passes no dropout generator to the
loss, as the JAX package's sharded loss gets no key.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_gather,
    psum,
)
from fashionvisualexpl_tpu_torch.core.train_state import TrainState, apply_gradients
from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
from fashionvisualexpl_tpu_torch.train.trainer import split_seed


class _CollectiveTake(torch.autograd.Function):
    """Masked local gather + psum over ``model``; backward: the masked local
    scatter of the (replicated) cotangent, not summed again."""

    @staticmethod
    def forward(ctx, table, ids, mesh):
        rows = table.shape[0]
        local = ids.long() - mesh.axis_index(MODEL_AXIS) * rows
        ok = (local >= 0) & (local < rows)
        safe = torch.where(ok, local, 0)
        # the mask broadcasts over ALL trailing table dims (image tables
        # are 4-D: [rows, H, W, C])
        mask = ok.reshape(ok.shape + (1,) * (table.dim() - 1))
        vals = torch.where(mask, table[safe], 0.0)
        ctx.save_for_backward(safe, mask)
        ctx.table_shape = table.shape
        return psum(vals, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        safe, mask = ctx.saved_tensors
        grad = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        grad.index_put_((safe,), torch.where(mask, g, 0.0), accumulate=True)
        return grad, None, None


def collective_take(row_sharded, mesh: Mesh) -> Callable:
    """A model ``take(name, table, ids)`` for a rank of ``mesh``: for a
    row-sharded table (``table`` this rank's shard, ``ids`` global) the
    collective lookup above; for a replicated one the plain gather."""
    sharded = frozenset(row_sharded)

    def take(name: str, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        if name not in sharded:
            return table[ids]
        return _CollectiveTake.apply(table, ids, mesh)

    return take


def pad_rows_to_multiple(arr, multiple: int):
    """``arr`` (numpy or tensor) with zero rows appended up to a multiple
    of ``multiple`` rows; ``arr`` itself when it is one already."""
    rows = arr.shape[0]
    padded = -(-rows // multiple) * multiple
    if padded == rows:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr.new_zeros((padded - rows, *arr.shape[1:]))])
    pad_width = [(0, padded - rows)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width)


def param_spec_tree(model, tree: Mapping[str, object]) -> Dict[str, bool]:
    """The per-name rule of the JAX ``PartitionSpec`` tree: True for a
    table row-sharded over ``model`` (a top-level name in
    ``model.row_sharded_params()``), False for a replicated one (every
    nested group's member, ``"color_enc.W1"``, included)."""
    sharded = set(model.row_sharded_params())
    return {k: k in sharded for k in tree}


def row_shard(arr, mesh: Mesh) -> torch.Tensor:
    """This rank's row shard of a whole table (numpy or a tensor), padded
    to the model-axis multiple, as a new tensor on the mesh's device."""
    t = torch.as_tensor(np.asarray(arr)) if not isinstance(arr, torch.Tensor) else arr
    t = pad_rows_to_multiple(t.detach(), mesh.shape[MODEL_AXIS])
    rows = t.shape[0] // mesh.shape[MODEL_AXIS]
    lo = mesh.axis_index(MODEL_AXIS) * rows
    return t[lo:lo + rows].to(mesh.device, copy=True).contiguous()


def unshard_rows(shard: torch.Tensor, mesh: Mesh, rows: Optional[int] = None) -> torch.Tensor:
    """The whole table from every model rank's shard (a collective over
    ``model``), its pad rows cut at ``rows`` when given."""
    whole = all_gather(shard, mesh, MODEL_AXIS)
    whole = whole.reshape(-1, *shard.shape[1:])
    return whole if rows is None else whole[:rows].contiguous()


def shard_params(model, params: Mapping[str, object], frozen: Mapping[str, object],
                 mesh: Mesh) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, frozen) of this rank from whole numpy arrays or tensors:
    row-sharded tables padded and cut to this rank's rows, the rest
    copied, all on the mesh's device."""

    def prep(tree):
        spec = param_spec_tree(model, tree)
        return {k: row_shard(v, mesh) if spec[k]
                else torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v
                                     ).detach().to(mesh.device, copy=True)
                for k, v in tree.items()}

    return prep(params), prep(frozen)


def load_tensors(model, tensors: Mapping[str, torch.Tensor]) -> None:
    """Put ``tensors`` (dotted names) into ``model`` in place of its
    parameters' data and its buffers: the rank's model then holds its
    shards (or, back, the whole tables)."""
    for name, t in tensors.items():
        path, _, leaf = name.rpartition(".")
        mod = model.get_submodule(path) if path else model
        if leaf in mod._parameters:
            mod._parameters[leaf].data = t
        elif leaf in mod._buffers:
            mod._buffers[leaf] = t
        else:
            raise KeyError(f"{name!r} is neither a parameter nor a buffer of {model.name}")


@contextlib.contextmanager
def spmd_model(model, take: Callable, reg_scale: float):
    """``model`` with the collective ``take`` and the data-parallel
    ``global_reg_scale`` for the duration of one loss."""
    old = model.__dict__.get("take"), model.global_reg_scale
    model.take, model.global_reg_scale = take, reg_scale
    try:
        yield model
    finally:
        if old[0] is None:
            del model.take
        else:
            model.take = old[0]
        model.global_reg_scale = old[1]


def data_slice(mesh: Mesh, *batch: torch.Tensor):
    """This rank's ``data`` slice of each global batch array."""
    d = mesh.shape[DATA_AXIS]
    B = batch[0].shape[0]
    if B % d:
        raise ValueError(f"batch {B} not divisible by data axis {d}")
    b = B // d
    lo = mesh.axis_index(DATA_AXIS) * b
    return tuple(x[lo:lo + b] for x in batch)


def psum_flat(tensors, mesh: Mesh, axis: str):
    """``psum`` of several float32 tensors through one flat buffer (one
    collective)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = psum(flat, mesh, axis)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


def make_spmd_grad_fn(model, mesh: Mesh, reg: float) -> Callable:
    """``grad_fn(params, users, pos, neg) -> (loss, grads)`` on this rank's
    ``data`` slice: ``params`` are the model's own (sharded) parameters by
    name; the loss of ``model.loss`` under ``collective_take`` and
    ``global_reg_scale = 1/d``; loss and grads summed over ``data``."""
    take = collective_take(model.row_sharded_params(), mesh)
    d = mesh.shape[DATA_AXIS]

    def grad_fn(params: Mapping[str, torch.Tensor], users, pos, neg):
        names = list(params)
        leaves = [params[k] for k in names]
        with spmd_model(model, take, 1.0 / d), torch.enable_grad():
            loss = model.loss(users, pos, neg, reg, rng=None)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        loss, *grads = psum_flat([loss.detach().reshape(1)] + grads, mesh, DATA_AXIS)
        return loss.reshape(()), dict(zip(names, grads))

    return grad_fn


def make_spmd_train_step(model, mesh: Mesh, tx, reg: float) -> Callable:
    """``step(state, frozen, users, pos, neg) -> (state, loss)`` over the
    GLOBAL batch (each rank takes its ``data`` slice): the sharded grads,
    then the elementwise update of this rank's params in place."""
    grad_fn = make_spmd_grad_fn(model, mesh, reg)

    def step(state: TrainState, frozen, users, pos, neg):
        del frozen  # the model reads its own (sharded) buffers
        u, p, n = data_slice(mesh, users.long(), pos.long(), neg.long())
        loss, grads = grad_fn(state.params, u, p, n)
        return apply_gradients(state, grads, tx), loss

    return step


def run_spmd_steps(step: Callable, state: TrainState, frozen, triples):
    """``step`` over one epoch's global triples ([steps, batch] each);
    returns (state, summed loss as a 0-d device tensor)."""
    users, pos, neg = triples
    losses = torch.empty(users.shape[0], dtype=torch.float32, device=users.device)
    for s in range(users.shape[0]):
        state, losses[s] = step(state, frozen, users[s], pos[s], neg[s])
    return state, torch.sum(losses)


def make_spmd_epoch_fn(model, mesh: Mesh, tx, reg: float, num_items: int, steps: int,
                       batch: int, sampling="user_perm") -> Callable:
    """``epoch(state, frozen, key, train_pairs, padded_pos, pos_counts) ->
    (state, summed loss)``: the epoch's global triples drawn on the mesh's
    device from ``split_seed(key)``'s first seed, as the single-device
    ``Trainer`` draws them (identical keys give identical batches on any
    mesh), then the sharded steps.  Call with the params placed by
    ``shard_params`` (the model holding its shards, ``load_tensors``)."""
    if batch % mesh.shape[DATA_AXIS]:
        raise ValueError(f"batch {batch} not divisible by data axis "
                         f"{mesh.shape[DATA_AXIS]}")
    step = make_spmd_train_step(model, mesh, tx, reg)

    def epoch(state: TrainState, frozen, key: int, train_pairs, padded_pos, pos_counts):
        sample_key, _ = split_seed(key)
        triples = sample_triplets(sample_key, train_pairs, padded_pos, pos_counts,
                                  num_items, steps, batch, with_replacement=sampling,
                                  device=mesh.device)
        return run_spmd_steps(step, state, frozen, triples)

    return epoch
