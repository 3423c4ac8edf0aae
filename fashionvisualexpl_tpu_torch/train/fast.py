"""Fast-path trainer: compact row gradients + sparse-apply Adam (port of
``fashionvisualexpl_tpu/train/fast.py``).

The generic trainer differentiates through the row gathers, whose backward
builds a DENSE table-shaped gradient per step.  This path never does:

1. gather the batch rows, differentiate the loss wrt the GATHERED rows
   ([B, K] gradients, no table-shaped intermediates);
2. dedupe ids by a stable sort + segment-sum into compact per-unique-row
   gradients;
3. Adam with optax.adam's update rule, applied as a pre-scaled scatter of
   the compact gradients into the moments and one full-table sweep (decay
   both moments, bias-corrected parameter update).

``make_fast_bprmf_step(pallas_bpr=True)`` computes the pairwise term and its
row gradients with the fused BPR kernel (``ops/bpr.py``, K1) instead of
autograd over the torch chain; ``fused_adam=True`` runs the sweep through
the fused Adam kernel (``ops/adam.py``, K6) instead of ``sparse_adam_table``.
Each flag off is the JAX package's own XLA route, in plain torch.

The state is updated IN PLACE (JAX donates it): a step returns the same
tensors.  Ids are int32 at the boundary; ``compact_row_grads`` pads unused
segments with an out-of-range id, and every scatter here redirects those
pads (``pad_safe_ids``) so torch indexing never sees them (the packed
engine drops them instead).

``make_fast_vbpr_step`` is the same path for VBPR: its row tables (Gu, Tu,
Gi, Bi) take the sparse or lazy row update, the small dense E and Bp
ordinary Adam; as in the JAX package it launches no custom kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets

B1, B2, EPS = 0.9, 0.999, 1e-7


class FastState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the state's device
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def init_fast_state(params: Dict[str, torch.Tensor]) -> FastState:
    """Zero moments beside ``params`` (the tensors themselves, not copies:
    the steps update them in place)."""
    params = {k: v.detach() for k, v in params.items()}
    dev = next(iter(params.values())).device
    return FastState(
        torch.zeros((), dtype=torch.int32, device=dev), params,
        {k: torch.zeros_like(v) for k, v in params.items()},
        {k: torch.zeros_like(v) for k, v in params.items()},
    )


class LazyFastState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    tau: Dict[str, torch.Tensor]  # per ROW-table: [rows] int32 last-touch step


def init_lazy_state(
    params: Dict[str, torch.Tensor], row_tables: Tuple[str, ...]
) -> LazyFastState:
    base = init_fast_state(params)
    tau = {
        k: torch.zeros(base.params[k].shape[0], dtype=torch.int32,
                       device=base.params[k].device)
        for k in row_tables if k in base.params
    }
    return LazyFastState(base.step, base.params, base.mu, base.nu, tau)


def compact_row_grads(
    ids: torch.Tensor, grads: torch.Tensor, num_segments: int,
    pad_id: int = 2**30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort + segment-sum duplicate ids -> (unique_ids [S] in the
    ids' dtype, summed [S, ...]).  Unused segments carry ``pad_id`` (out of
    range for the target table) and zero gradients.  On the CPU the
    segment sums add in sorted order, as JAX's do; on CUDA ``index_add_``
    adds duplicates with atomics, in no fixed order."""
    sid, order = torch.sort(ids, stable=True)
    sg = grads[order]
    new_seg = torch.ones_like(sid, dtype=torch.int64)
    new_seg[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(new_seg, 0) - 1  # segment index per sorted entry
    summed = torch.zeros((num_segments, *grads.shape[1:]), dtype=grads.dtype,
                         device=grads.device)
    summed.index_add_(0, seg, sg)
    uids = torch.full((num_segments,), pad_id, dtype=ids.dtype, device=ids.device)
    uids.scatter_(0, seg, sid)
    return uids, summed


def pad_safe_ids(uids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int64 row ids for torch indexing: the out-of-range pads of
    ``compact_row_grads`` are redirected to the first segment's id, which
    is always a real row.  JAX drops those scatter updates, and its
    ``take`` returns NaN rows for those gathers (it does not clamp them);
    here a pad adds a zero gradient to a real row, or (lazy path) writes
    the same value as that row's own segment, whose result it masks in.

    The packed engine (``train/packed_generic.py``) must not use it: its
    row scatter (K5) takes unique ids and drops out-of-range ones, and a
    redirected pad would be a duplicate id writing a different row (the
    pad's own update on a zero gradient, with its own tau) in a race."""
    uids = uids.long()
    return torch.where(uids < n_rows, uids, uids[:1])


def _bias_corrections(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 - B1^t, 1 - B2^t) in float32 from the float32 step ``t``."""
    return 1.0 - torch.pow(B1, t), 1.0 - torch.pow(B2, t)


@torch.no_grad()
def prescaled_scatter(m, v, uids, g) -> None:
    """Add (1-B1)/B1 * g and (1-B2)/B2 * g^2 into the ``uids`` rows of m and
    v, in place, so that the uniform decay that follows produces
    b*m + (1-b)*g on touched rows, rounded as the JAX package rounds it.
    ``uids`` may hold the out-of-range pads of ``compact_row_grads``."""
    if g.dim() < m.dim():
        g = g[..., None] if m.dim() == 2 and g.dim() == 1 else g
    rows = pad_safe_ids(uids, m.shape[0])
    m.index_add_(0, rows, (1.0 - B1) / B1 * g)
    v.index_add_(0, rows, (1.0 - B2) / B2 * torch.square(g))


@torch.no_grad()
def sparse_adam_table(p, m, v, uids, g, lr: float, t: torch.Tensor):
    """One Adam step where the gradient is zero outside ``uids`` rows, in
    place.  Equivalent to optax.adam's dense update with the dense-scatter
    gradient: the scatter runs FIRST with pre-scaled contributions
    (``prescaled_scatter``), then the uniform decay."""
    prescaled_scatter(m, v, uids, g)
    m.mul_(B1)
    v.mul_(B2)
    bc1, bc2 = _bias_corrections(t)
    m_hat = m / bc1
    v_hat = v / bc2
    p.sub_(lr * m_hat / (torch.sqrt(v_hat) + EPS))
    return p, m, v


@torch.no_grad()
def lazy_adam_table(p, m, v, tau, uids, g, lr: float, t: torch.Tensor):
    """One LAZY Adam step: only the touched rows are read or written
    (LazyAdam semantics: per-row last-touch step ``tau``; on touch the
    deferred decay b^(t - tau) is applied in one catch-up, then the
    standard update).  Untouched rows keep their parameters.  In place."""
    if g.dim() < m.dim():
        g = g[..., None] if m.dim() == 2 and g.dim() == 1 else g
    rows = pad_safe_ids(uids, m.shape[0])
    real = uids.long() < m.shape[0]
    dt = t - tau[rows].to(torch.float32)
    dt_b = dt[:, None] if m.dim() > 1 else dt
    m_rows = m[rows] * torch.pow(B1, dt_b) + (1.0 - B1) * g
    v_rows = v[rows] * torch.pow(B2, dt_b) + (1.0 - B2) * torch.square(g)
    bc1, bc2 = _bias_corrections(t)
    m_hat = m_rows / bc1
    v_hat = v_rows / bc2
    p_rows = p[rows] - lr * m_hat / (torch.sqrt(v_hat) + EPS)
    # a pad writes exactly what its row's own segment writes
    mask = real[:, None] if m.dim() > 1 else real
    for table, vals in ((p, p_rows), (m, m_rows), (v, v_rows)):
        table.index_copy_(0, rows, torch.where(mask, vals, vals[:1]))
    tau.index_copy_(0, rows, t.to(tau.dtype).expand(rows.shape[0]).contiguous())
    return p, m, v, tau


@torch.no_grad()
def dense_adam(p, m, v, g, lr: float, t: torch.Tensor):
    """optax.adam on a whole array, out of place: (p, m, v)."""
    m = B1 * m + (1.0 - B1) * g
    v = B2 * v + (1.0 - B2) * torch.square(g)
    bc1, bc2 = _bias_corrections(t)
    m_hat = m / bc1
    v_hat = v / bc2
    return p - lr * m_hat / (torch.sqrt(v_hat) + EPS), m, v


def make_fast_bprmf_step(model, lr: float, reg: float,
                         fused_adam: bool = False,
                         pallas_bpr: bool = False,
                         lazy: bool = False) -> Callable:
    """Fast train step for BPRMF (reference loss semantics,
    BPRMF.py:95-112): ``step(state, (u, p, n)) -> (state, loss)``.
    ``fused_adam=True`` routes the full-table sweep through the fused Adam
    kernel (K6); ``pallas_bpr=True`` computes the pairwise loss and its row
    gradients through the fused BPR kernel (K1) instead of autograd over
    the torch chain; ``lazy=True`` switches the optimizer to LazyAdam
    semantics (``lazy_adam_table``; state is a ``LazyFastState``).  The
    flag names are the JAX package's.  ``model`` is unused, as there."""
    from fashionvisualexpl_tpu_torch.models.base import bpr_pairwise_loss, l2_loss

    del model
    if fused_adam:
        from fashionvisualexpl_tpu_torch.ops.adam import (
            adam_scalars,
            sparse_adam_table_fused,
        )
    if pallas_bpr:
        from fashionvisualexpl_tpu_torch.ops.bpr import bpr_triplet_loss

    def reg_loss(gu, gp, gn, bp, bn):
        return (
            reg * (l2_loss(gu) + l2_loss(gp) + l2_loss(gn)) * 2.0
            + reg * l2_loss(bp) * 2.0
            + reg * l2_loss(bn) * 2.0 / 10.0
        )

    def step(state, batch):
        u, p_ids, n_ids = (x.long() for x in batch)
        P = state.params
        with torch.no_grad():
            gu = P["Gu"][u]
            gp = P["Gi"][p_ids]
            gn = P["Gi"][n_ids]
            bp = P["Bi"][p_ids]
            bn = P["Bi"][n_ids]

        with torch.enable_grad():
            leaves = [x.requires_grad_() for x in (gu, gp, gn, bp, bn)]
            if pallas_bpr:
                # fused kernel fwd/bwd for the pairwise term; reg grads are
                # analytic (d(2 reg l2(x))/dx = 2 reg x)
                pair_loss = bpr_triplet_loss(*leaves)
                dgu, dgp, dgn, dbp, dbn = torch.autograd.grad(pair_loss, leaves)
            else:
                x_pos = bp + torch.sum(gu * gp, dim=1)
                x_neg = bn + torch.sum(gu * gn, dim=1)
                loss = bpr_pairwise_loss(x_pos, x_neg) + reg_loss(*leaves)
                dgu, dgp, dgn, dbp, dbn = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            if pallas_bpr:
                dgu = dgu + 2.0 * reg * gu
                dgp = dgp + 2.0 * reg * gp
                dgn = dgn + 2.0 * reg * gn
                dbp = dbp + 2.0 * reg * bp
                dbn = dbn + (2.0 * reg / 10.0) * bn
                loss = pair_loss + reg_loss(gu, gp, gn, bp, bn)
            loss = loss.detach()
            t = (state.step + 1).to(torch.float32)
            B = u.shape[0]
            scal = adam_scalars(lr, t) if fused_adam and not lazy else None

            ii = torch.cat([p_ids, n_ids])
            for name, ids, g, ns in (
                ("Gu", u, dgu, B),
                ("Gi", ii, torch.cat([dgp, dgn]), 2 * B),
                ("Bi", ii, torch.cat([dbp, dbn]), 2 * B),
            ):
                uids, cg = compact_row_grads(ids, g, ns)
                if lazy:
                    lazy_adam_table(P[name], state.mu[name], state.nu[name],
                                    state.tau[name], uids, cg, lr, t)
                elif fused_adam:
                    sparse_adam_table_fused(P[name], state.mu[name],
                                            state.nu[name], uids, cg, scal)
                else:
                    sparse_adam_table(P[name], state.mu[name], state.nu[name],
                                      uids, cg, lr, t)
        return state._replace(step=state.step + 1), loss

    return step


def make_fast_epoch_fn(model, lr: float, reg: float, num_items: int,
                       steps: int, batch: int,
                       fused_adam: bool = False,
                       with_replacement=False,
                       pallas_bpr: bool = False,
                       lazy: bool = False,
                       device: DeviceLike = None) -> Callable:
    """``epoch(state, key, train_pairs, padded_pos, pos_counts) ->
    (state, summed loss)``: one epoch of ``steps`` batches sampled on
    ``device`` (``None`` = the CUDA card; raises without one) from the int
    ``key``.  The per-step losses stay on the device; their sum is returned
    as a 0-d tensor, read by the caller once per epoch."""
    dev = resolve_device(device)
    step_fn = make_fast_bprmf_step(model, lr, reg, fused_adam=fused_adam,
                                   pallas_bpr=pallas_bpr, lazy=lazy)

    def epoch(state, key: int, train_pairs: Optional[torch.Tensor],
              padded_pos: torch.Tensor, pos_counts: torch.Tensor):
        users, pos, neg = sample_triplets(
            key, train_pairs, padded_pos, pos_counts, num_items, steps, batch,
            with_replacement=with_replacement, device=dev,
        )
        losses = torch.empty(steps, dtype=torch.float32, device=dev)
        for s in range(steps):
            state, losses[s] = step_fn(state, (users[s], pos[s], neg[s]))
        return state, torch.sum(losses)

    return epoch


def make_fast_vbpr_step(model, lr: float, reg: float, lazy: bool = False) -> Callable:
    """Fast train step for VBPR (reference loss semantics, VBPR.py:99-143):
    ``step(state, (F, (u, p, n))) -> (state, loss)``, ``F`` the frozen
    feature matrix.  The row tables (Gu, Tu, Gi, Bi) get the sparse-apply
    path (``lazy_adam_table`` when ``lazy=True``; the state is then a
    ``LazyFastState``), E and Bp dense Adam, in place.  ``model`` is
    unused, as in the JAX package."""
    from fashionvisualexpl_tpu_torch.models.base import bpr_pairwise_loss, l2_loss

    del model

    def step(state, batch):
        frozen_F, ids = batch
        u, p_ids, n_ids = (x.long() for x in ids)
        P = state.params
        with torch.no_grad():
            rows = (P["Gu"][u], P["Tu"][u], P["Gi"][p_ids], P["Gi"][n_ids],
                    P["Bi"][p_ids], P["Bi"][n_ids], P["E"], P["Bp"])
            fp, fn = frozen_F[p_ids], frozen_F[n_ids]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in rows]
            gu, tu, gp, gn, bp, bn, E, Bp = leaves
            x_pos = (bp + torch.sum(gu * gp, dim=1)
                     + torch.sum(tu * (fp @ E), dim=1) + (fp @ Bp)[:, 0])
            x_neg = (bn + torch.sum(gu * gn, dim=1)
                     + torch.sum(tu * (fn @ E), dim=1) + (fn @ Bp)[:, 0])
            loss = bpr_pairwise_loss(x_pos, x_neg) + (
                reg * (l2_loss(gu) + l2_loss(gp) + l2_loss(gn) + l2_loss(tu)) * 2.0
                + reg * l2_loss(bp) * 2.0
                + reg * l2_loss(bn) * 2.0 / 10.0
                + reg * (l2_loss(E) + l2_loss(Bp)) * 2.0
            )
            dgu, dtu, dgp, dgn, dbp, dbn, dE, dBp = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            t = (state.step + 1).to(torch.float32)
            B = u.shape[0]
            ii = torch.cat([p_ids, n_ids])
            for name, ids_, g, ns in (
                ("Gu", u, dgu, B),
                ("Tu", u, dtu, B),
                ("Gi", ii, torch.cat([dgp, dgn]), 2 * B),
                ("Bi", ii, torch.cat([dbp, dbn]), 2 * B),
            ):
                uids, cg = compact_row_grads(ids_, g, ns)
                if lazy:
                    lazy_adam_table(P[name], state.mu[name], state.nu[name],
                                    state.tau[name], uids, cg, lr, t)
                else:
                    sparse_adam_table(P[name], state.mu[name], state.nu[name],
                                      uids, cg, lr, t)
            for name, g in (("E", dE), ("Bp", dBp)):
                new = dense_adam(P[name], state.mu[name], state.nu[name], g, lr, t)
                for table, val in zip((P[name], state.mu[name], state.nu[name]), new):
                    table.copy_(val)
        return state._replace(step=state.step + 1), loss.detach()

    return step


def make_fast_vbpr_epoch_fn(model, lr: float, reg: float, num_items: int,
                            steps: int, batch: int, lazy: bool = False,
                            device: DeviceLike = None) -> Callable:
    """``epoch(state, F, key, train_pairs, padded_pos, pos_counts) ->
    (state, summed loss)``: ``steps`` batches sampled on ``device`` (``None``
    = the CUDA card) from the int ``key`` with the sampler's default
    scheme, as the JAX epoch samples, then ``make_fast_vbpr_step``'s steps.
    The JAX function also takes ``frozen`` after ``model`` and ignores it
    (its epoch takes F); the port drops it."""
    dev = resolve_device(device)
    step_fn = make_fast_vbpr_step(model, lr, reg, lazy=lazy)

    def epoch(state, frozen_F: torch.Tensor, key: int,
              train_pairs: Optional[torch.Tensor], padded_pos: torch.Tensor,
              pos_counts: torch.Tensor):
        users, pos, neg = sample_triplets(key, train_pairs, padded_pos, pos_counts,
                                          num_items, steps, batch, device=dev)
        losses = torch.empty(steps, dtype=torch.float32, device=dev)
        for s in range(steps):
            state, losses[s] = step_fn(state, (frozen_F, (users[s], pos[s], neg[s])))
        return state, torch.sum(losses)

    return epoch
