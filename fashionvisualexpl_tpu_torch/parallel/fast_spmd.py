"""The generic packed engine over a (data, model) mesh (port of the generic
part of ``fashionvisualexpl_tpu/parallel/fast_spmd.py``).

The packed rows of ``train/packed_generic.py`` are row-sharded over
``model`` (padded to the axis multiple, ``shard_generic_packed_state``),
the dense params replicated, the batch sliced over ``data``.  Per step and
rank:

- the forward rows: a local read of the owned rows through K4
  (``ops/gather.py::gather_rows``; a non-owned id reads row 0 and is masked
  to zero), then one ``psum`` over ``model`` of the parameter columns only
  (the moment columns never travel): ``_packed_forward_take`` /
  ``_packed_forward_take_cols``;
- the loss and its gradients with respect to the gathered views, the
  model's own table reads (frozen tables by id) through
  ``parallel/spmd.py::collective_take``; loss and dense grads summed over
  ``data`` in one collective;
- the row ids and row grads all-gathered over ``data`` (ids ride the grads
  as float32 bit patterns: one gather a table), deduped once
  (``compact_row_grads``), and every model rank applies LazyAdam to the
  unique rows it owns: the owned-row read through K4, the write-back
  through K5 (``ops/row_scatter.py::scatter_rows_set``), which drops the
  non-owned ids, routed out of range (``_sharded_packed_lazy_apply_taucol``).
  Pad rows and ``row_align`` pad columns pass through untouched.

Dropout differs per data shard and is identical across model shards: the
step's generator seed is folded with the rank's data index.  float8
moments are refused (``_moment_cols``), as in the JAX package.

Not ported here: ``make_fast_spmd_epoch_fn``, ``make_packed_spmd_epoch_fn``
and ``shard_packed_state`` (BPRMF's sparse and ``PackedLazyState``
engines, ROADMAP queue 1, item 5); no ``Trainer`` path reaches them.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch

from fashionvisualexpl_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_gather,
    psum,
)
from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
from fashionvisualexpl_tpu_torch.ops.gather import gather_rows
from fashionvisualexpl_tpu_torch.ops.row_scatter import scatter_rows_set
from fashionvisualexpl_tpu_torch.parallel.spmd import (
    collective_take,
    data_slice,
    psum_flat,
    row_shard,
    spmd_model,
    unshard_rows,
)
from fashionvisualexpl_tpu_torch.train.fast import compact_row_grads, dense_adam
from fashionvisualexpl_tpu_torch.train.packed import _lazy_rows
from fashionvisualexpl_tpu_torch.train.packed_generic import (
    GenericPackedState,
    _flat_dense,
    _lazy_rows_bf16,
    _moment_cols,
    _offsets,
    run_packed_steps,
)
from fashionvisualexpl_tpu_torch.train.trainer import fold_in, split_seed


def _owned(ids: torch.Tensor, rows: int, mesh: Mesh):
    """(shard-local ids as int64, owned mask) of global ``ids``."""
    local = ids.long() - mesh.axis_index(MODEL_AXIS) * rows
    return local, (local >= 0) & (local < rows)


def _packed_forward_take_cols(pmv: torch.Tensor, ids: torch.Tensor, emb_cols: int,
                              scalar_cols: Sequence[int], mesh: Mesh):
    """(rows' [0, emb_cols) block [n, emb_cols], their ``scalar_cols``
    [n, len]) for global ``ids`` against this rank's packed shard: the
    owned rows read through K4, the rest masked to zero, then one psum over
    ``model`` of just those columns."""
    local, ok = _owned(ids, pmv.shape[0], mesh)
    rows = gather_rows(pmv, torch.where(ok, local, 0).to(torch.int32))
    cols = [rows[:, :emb_cols]] + [rows[:, c:c + 1] for c in scalar_cols]
    out = psum(torch.where(ok[:, None], torch.cat(cols, dim=1), 0.0), mesh, MODEL_AXIS)
    return out[:, :emb_cols], out[:, emb_cols:]


def _packed_forward_take(pmv: torch.Tensor, ids: torch.Tensor, emb_cols: int,
                         mesh: Mesh) -> torch.Tensor:
    """``_packed_forward_take_cols`` without scalar columns."""
    return _packed_forward_take_cols(pmv, ids, emb_cols, (), mesh)[0]


def _sharded_packed_lazy_apply_taucol(pmv: torch.Tensor, uids: torch.Tensor,
                                      g: torch.Tensor, lr: float, t: torch.Tensor,
                                      k_groups, rows_fn: Callable, mw: int, tau_ix: int,
                                      mesh: Mesh) -> torch.Tensor:
    """LazyAdam on the unique rows ``uids`` (global ids, pads 2**30) that
    this rank owns, in place: the rows read through K4 (non-owned ids read
    row 0), each (pmv offset, grad offset, width) group of ``k_groups``
    updated by ``rows_fn`` over its ``mw * width`` columns, tau (column
    ``tau_ix``) stamped with t, the columns after it (``row_align`` pads)
    passed through; written back through K5, the non-owned ids routed out
    of range (``rows``) and dropped."""
    rows = pmv.shape[0]
    local, ok = _owned(uids, rows, mesh)
    old = gather_rows(pmv, torch.where(ok, local, 0).to(torch.int32))
    dt = (t - old[:, tau_ix])[:, None]
    parts = [rows_fn(old[:, off:off + mw * w], g[:, g_off:g_off + w], dt, t, lr)
             for off, g_off, w in k_groups]
    parts.append(t.reshape(1, 1).expand(old.shape[0], 1))
    parts.append(old[:, tau_ix + 1:])
    scatter_rows_set(pmv, torch.where(ok, local, rows).to(torch.int32),
                     torch.cat(parts, dim=1))
    return pmv


def _gather_rows_with_ids(ids: torch.Tensor, grads: torch.Tensor, mesh: Mesh):
    """(ids, grads) of every ``data`` rank, stacked in axis order: one
    all_gather, the int32 ids riding as float32 bit patterns."""
    packed = torch.cat([grads, ids.to(torch.int32).view(torch.float32)[:, None]], dim=1)
    allp = all_gather(packed, mesh, DATA_AXIS).reshape(-1, packed.shape[1])
    return allp[:, -1].contiguous().view(torch.int32), allp[:, :-1]


def make_generic_packed_spmd_step(model, mesh: Mesh, lr: float, reg: float,
                                  moment_dtype: str = "float32",
                                  lazy_catchup: bool = False) -> Callable:
    """``step(state, (frozen, (users, pos, neg), rng)) -> (state, loss)`` on
    this rank: ``state`` its shard (``shard_generic_packed_state``), the
    triples the GLOBAL batch, ``frozen`` its (sharded) buffers, ``rng`` the
    step's generator (its seed folded with the data index here).  The
    frozen tables are read by id (not fused), as in the JAX package."""
    mw = _moment_cols(moment_dtype)
    spec = model.packed_spec()
    E = spec.extra_items
    u_offs, Wu = _offsets(spec.user_tables)
    i_offs, Wi = _offsets(spec.item_tables)
    nS = len(spec.item_scalars)
    rows_fn = functools.partial(_lazy_rows if mw == 3 else _lazy_rows_bf16,
                                catchup=lazy_catchup)
    scalar_cols = [mw * Wi + mw * j for j in range(nS)]
    item_groups = [(0, 0, Wi)] + [(mw * Wi + mw * j, Wi + j, 1) for j in range(nS)]
    d = mesh.shape[DATA_AXIS]
    take = collective_take(model.row_sharded_params(), mesh)

    @torch.no_grad()
    def step(state: GenericPackedState, batch):
        frozen, triples, rng = batch
        u, p_ids, n_ids = data_slice(mesh, *(x.to(torch.int32) for x in triples))
        b = u.shape[0]
        ids = (u.long(), p_ids.long(), n_ids.long())
        ii = torch.cat([p_ids, n_ids])
        UR = _packed_forward_take(state.user_pmv, u, Wu, mesh)
        IRe, IRs = _packed_forward_take_cols(state.item_pmv, ii, Wi, scalar_cols, mesh)
        user_vw = {n: UR[:, off:off + w] for n, off, w in u_offs}
        pos_vw = {n: IRe[:b, off:off + w] for n, off, w in i_offs}
        neg_vw = {n: IRe[b:, off:off + w] for n, off, w in i_offs}
        for j, s in enumerate(spec.item_scalars):
            pos_vw[s], neg_vw[s] = IRs[:b, j], IRs[b:, j]
        extra_vw = {}
        if E:
            xids = model.packed_extra_item_ids(frozen, ids).reshape(-1).to(torch.int32)
            XRe, XRs = _packed_forward_take_cols(state.item_pmv, xids, Wi, scalar_cols, mesh)
            extra_vw = {n: XRe[:, off:off + w].reshape(b, E, w) for n, off, w in i_offs}
            for j, s in enumerate(spec.item_scalars):
                extra_vw[s] = XRs[:, j].reshape(b, E)
            ii = torch.cat([ii, xids])
        dense_p = {}
        for name in spec.dense:
            dense_p.update(_flat_dense(name, state.dense[name][0]))
        # distinct dropout per data shard, identical across model shards
        rng_l = rng
        if isinstance(rng, torch.Generator):
            rng_l = torch.Generator(device=rng.device).manual_seed(
                fold_in(rng.initial_seed(), mesh.axis_index(DATA_AXIS)))

        groups = (user_vw, pos_vw, neg_vw, extra_vw, dense_p)
        keys = [(i, k) for i, grp in enumerate(groups) for k in grp]
        kw = {"extra_vw": extra_vw} if E else {}
        with spmd_model(model, take, 1.0 / d), torch.enable_grad():
            for i, k in keys:
                groups[i][k] = groups[i][k].detach().requires_grad_()
            loss = model.packed_loss(user_vw, pos_vw, neg_vw, dense_p, frozen, ids, reg,
                                     rng_l, **kw)
            grads = torch.autograd.grad(loss, [groups[i][k] for i, k in keys],
                                        allow_unused=True)
        gU, gP, gN, gX, gD = ({}, {}, {}, {}, {})
        for (i, k), g in zip(keys, grads):
            (gU, gP, gN, gX, gD)[i][k] = g if g is not None else torch.zeros_like(groups[i][k])
        dnames = list(gD)
        loss, *dg = psum_flat([loss.detach().reshape(1)] + [gD[k] for k in dnames],
                              mesh, DATA_AXIS)
        gD = dict(zip(dnames, dg))

        u_all, gu_all = _gather_rows_with_ids(
            u, torch.cat([gU[n] for n, _, _ in u_offs], dim=1), mesh)
        gi_parts = [torch.cat([gP[n], gN[n]] + ([gX[n].reshape(b * E, w)] if E else []))
                    for n, _, w in i_offs]
        gi_parts += [torch.cat([gP[s], gN[s]] + ([gX[s].reshape(b * E)] if E else []))[:, None]
                     for s in spec.item_scalars]
        ii_all, gi_all = _gather_rows_with_ids(ii, torch.cat(gi_parts, dim=1), mesh)

        t = (state.step + 1).to(torch.float32)
        B = u_all.shape[0]
        uids, cg = compact_row_grads(u_all, gu_all, B)
        _sharded_packed_lazy_apply_taucol(state.user_pmv, uids, cg, lr, t, [(0, 0, Wu)],
                                          rows_fn, mw, mw * Wu, mesh)
        iids, cgi = compact_row_grads(ii_all, gi_all, (2 + E) * B)
        _sharded_packed_lazy_apply_taucol(state.item_pmv, iids, cgi, lr, t, item_groups,
                                          rows_fn, mw, mw * (Wi + nS), mesh)

        dense = {}
        for name in spec.dense:
            p, m, v = state.dense[name]
            if isinstance(p, torch.Tensor):
                dense[name] = dense_adam(p, m, v, gD[name], lr, t)
            else:
                outs = {k: dense_adam(p[k], m[k], v[k], gD[f"{name}.{k}"], lr, t) for k in p}
                dense[name] = tuple({k: o[i] for k, o in outs.items()} for i in range(3))
        return (GenericPackedState(state.step + 1, state.user_pmv, state.item_pmv, dense),
                loss.reshape(()))

    return step


def make_generic_packed_spmd_epoch_fn(
    model, mesh: Mesh, lr: float, reg: float, num_items: int, steps: int, batch: int,
    with_replacement=False, moment_dtype: str = "float32", lazy_catchup: bool = False,
) -> Callable:
    """``epoch(state, frozen, key, train_pairs, padded_pos, pos_counts) ->
    (state, summed loss)``: the global triples drawn on the mesh's device
    from ``split_seed(key)``'s first seed, the steps' generators from its
    second (``run_packed_steps``), as the single-device packed epoch; the
    steps of ``make_generic_packed_spmd_step``."""
    if batch % mesh.shape[DATA_AXIS]:
        raise ValueError(f"batch {batch} not divisible by data axis "
                         f"{mesh.shape[DATA_AXIS]}")
    step_fn = make_generic_packed_spmd_step(model, mesh, lr, reg, moment_dtype=moment_dtype,
                                            lazy_catchup=lazy_catchup)

    def epoch(state: GenericPackedState, frozen, key: int, train_pairs, padded_pos,
              pos_counts):
        sample_key, step_key = split_seed(key)
        triples = sample_triplets(sample_key, train_pairs, padded_pos, pos_counts,
                                  num_items, steps, batch,
                                  with_replacement=with_replacement, device=mesh.device)
        return run_packed_steps(step_fn, state, frozen, triples, step_key)

    return epoch


def _dense_map(fn, dense):
    def one(x):
        return fn(x) if isinstance(x, torch.Tensor) else {k: fn(v) for k, v in x.items()}

    return {name: tuple(one(x) for x in pmv) for name, pmv in dense.items()}


def shard_generic_packed_state(state: GenericPackedState, mesh: Mesh) -> GenericPackedState:
    """This rank's shard of a whole packed state: user and item rows padded
    to the model-axis multiple (pad rows are unreachable ids) and cut to
    its rows, the dense params copied, all on the mesh's device."""
    def copy(x):
        return x.detach().to(mesh.device, copy=True)

    return GenericPackedState(copy(state.step), row_shard(state.user_pmv, mesh),
                              row_shard(state.item_pmv, mesh), _dense_map(copy, state.dense))


def unshard_generic_packed_state(state: GenericPackedState, mesh: Mesh,
                                 num_users: int, num_items: int) -> GenericPackedState:
    """The whole (single-device layout) packed state from every model
    rank's shard: a collective over ``model``; the pad rows cut."""
    def copy(x):
        return x.detach().clone()

    return GenericPackedState(state.step.clone(),
                              unshard_rows(state.user_pmv, mesh, num_users),
                              unshard_rows(state.item_pmv, mesh, num_items),
                              _dense_map(copy, state.dense))

