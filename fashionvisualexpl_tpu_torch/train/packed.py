"""Packed-state fast path: LazyAdam on packed rows, and the specialized
packed steps of BPRMF, VBPR and GradFashion (port of
``fashionvisualexpl_tpu/train/packed.py``).

A packed row holds a parameter row and its Adam moments side by side, so
one gather reads and one scatter writes all three:

- user table  [U, 3Wu]    : the user tables side by side (BPRMF: Gu,
  Wu = K; VBPR and GradFashion: [Gu | Tu], Wu = K + D), then m, then v;
- item table  [I, 3K + 3] : columns [0:K) = Gi, [K:2K) = m, [2K:3K) = v,
  [3K] = Bi, [3K+1] = Bi's m, [3K+2] = Bi's v (the item bias folded into
  the item row);
- tau_u [U], tau_i [I]    : int32 last-touch steps, arrays of their own;
- dense                   : name -> (p, m, v) of the small whole params
  (VBPR: E, Bp; GradFashion: E, Bp, Ec, Ee; BPRMF: none).

The update touches the gathered rows only (``_lazy_rows``): LazyAdam's
catch-up decay b^dt for the dt steps since the row's last touch, then the
standard update, and optionally the closed-form momentum tail of the
skipped steps (``_momentum_catchup``).  The generic engine
(``train/packed_generic.py``) builds on these functions; its rows carry
tau as a last column instead.

One step maker serves the three models (``make_packed_step``; the JAX
package's per-model names are aliases of it): the layout comes from
``model.packed_spec()`` and the loss is ``model.packed_loss`` over the
gathered views, as in the generic engine, which it therefore equals bit
for bit on the CPU.  The frozen features (VBPR's F, GradFashion's Fc and
Fe) go to the loss as the ``frozen`` keyword, a mapping like the model's
buffers, and are read by id; the dense params take ordinary Adam
(``train/fast.py::dense_adam``).

Per step: four row reads through K4 (``ops/gather.py::gather_rows``: the
forward user and item rows, then the deduped user and item rows) and two
row writes through K5 (``ops/row_scatter.py::scatter_rows_set``); on CPU
tensors the wrappers take their plain versions.  The dedupe
(``compact_row_grads``) pads unused segments with the id 2**30: K4 clamps
a pad's read, K5 drops its write, and the tau write drops it by a mask
(``_stamp_tau``), so untouched rows and their tau stay as they were.  The
rows and tau are updated in place (JAX donates them); a step returns a new
state holding them.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
from fashionvisualexpl_tpu_torch.ops.gather import gather_rows
from fashionvisualexpl_tpu_torch.ops.row_scatter import scatter_rows_set
from fashionvisualexpl_tpu_torch.train.fast import (
    B1,
    B2,
    EPS,
    compact_row_grads,
    dense_adam,
)


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once to nearest, as IEEE (and the JAX
    package) define it: taken in float64, then rounded (exact for sqrt).
    PyTorch's vectorized CPU sqrt can be one ulp off."""
    return torch.sqrt(x.double()).to(x.dtype)


def _momentum_catchup(p, m, v, dt, t, lr):
    """Apply the momentum tail dense Adam would have applied over the
    dt - 1 skipped steps, in closed form: skipped step j has m_j = m B1^j
    and v_j = v B2^j, so with the bias corrections taken at the touch step
    the tail is a geometric sum in r = B1 / sqrt(B2):

        p -= lr * m_hat / (sqrt(v_hat) + EPS) * sum_{j=1}^{dt-1} r^j

    All float32, in the JAX package's order of operations."""
    r = B1 / ieee_sqrt(torch.tensor(B2, dtype=torch.float32, device=p.device))
    geom = r * (1.0 - torch.pow(r, torch.clamp(dt - 1.0, min=0.0))) / (1.0 - r)
    m_hat = m / (1.0 - torch.pow(B1, t))
    v_hat = v / (1.0 - torch.pow(B2, t))
    return p - lr * geom * m_hat / (ieee_sqrt(v_hat) + EPS)


def _lazy_rows(rows, g, dt, t, lr, catchup: bool = False):
    """LazyAdam on gathered packed rows: ``rows`` [S, 3K] as p|m|v column
    groups, ``g`` [S, K] the summed gradients of the p columns, ``dt``
    [S, 1] the steps since each row's last touch, ``t`` the float32 step.
    ``catchup=True`` first applies the momentum tail of the skipped steps
    (``_momentum_catchup``).  Returns the new [S, 3K] rows."""
    K = g.shape[1]
    p, m, v = rows[:, :K], rows[:, K:2 * K], rows[:, 2 * K:3 * K]
    if catchup:
        p = _momentum_catchup(p, m, v, dt, t, lr)
    m = m * torch.pow(B1, dt) + (1.0 - B1) * g
    v = v * torch.pow(B2, dt) + (1.0 - B2) * torch.square(g)
    m_hat = m / (1.0 - torch.pow(B1, t))
    v_hat = v / (1.0 - torch.pow(B2, t))
    p = p - lr * m_hat / (ieee_sqrt(v_hat) + EPS)
    return torch.cat([p, m, v], dim=1)


# --- gathered views, the loss and its grads --------------------------------


def _offsets(tables):
    """[(name, column offset, width)] of tables laid side by side, and
    their total width."""
    offs, off = [], 0
    for name, w in tables:
        offs.append((name, off, w))
        off += w
    return offs, off


def _loss_grads(model, user_vw, pos_vw, neg_vw, dense, frozen, ids, reg, rng=None,
                extra_vw=None, **kw):
    """``model.packed_loss`` over the gathered views (dicts of tensors, as
    it takes them), differentiated with respect to the views themselves,
    not through the gathers: no table-shaped gradient exists.  ``kw`` goes
    to the loss as it is.  Returns (loss, (user, pos, neg, dense, extra)
    grads as dicts of the views' keys; zeros for a view the loss leaves
    unread)."""
    groups = [{k: x.detach().requires_grad_() for k, x in g.items()}
              for g in (user_vw, pos_vw, neg_vw, dense, extra_vw or {})]
    if extra_vw is not None:
        kw["extra_vw"] = groups[4]
    leaves = [x for g in groups for x in g.values()]
    with torch.enable_grad():
        loss = model.packed_loss(*groups[:4], frozen, ids, reg, rng, **kw)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    return loss, tuple({k: _or_zeros(next(grads), x) for k, x in g.items()} for g in groups)


def _or_zeros(g, x):
    return torch.zeros_like(x) if g is None else g


def _row_grads(model, spec, user_p, item_p, item_s, dense, frozen, ids, reg):
    """(loss, user row grads [B, Wu], item row grads [2B, Wi + nS] as
    [tables | scalars], dense grads) of ``model.packed_loss`` over the
    gathered parameter columns: ``user_p`` [B, Wu], ``item_p`` [2B, Wi]
    and ``item_s`` [2B, nS] (the positives' rows, then the negatives')."""
    u_offs, _ = _offsets(spec.user_tables)
    i_offs, _ = _offsets(spec.item_tables)
    B = user_p.shape[0]

    def side(rows, scalars):
        vw = {n: rows[:, off:off + w] for n, off, w in i_offs}
        vw.update({s: scalars[:, j] for j, s in enumerate(spec.item_scalars)})
        return vw

    loss, (gU, gP, gN, gD, _) = _loss_grads(
        model, {n: user_p[:, off:off + w] for n, off, w in u_offs},
        side(item_p[:B], item_s[:B]), side(item_p[B:], item_s[B:]), dense, frozen, ids, reg)
    gi = [torch.cat([gP[n], gN[n]]) for n, _, _ in i_offs]
    gi += [torch.cat([gP[s], gN[s]])[:, None] for s in spec.item_scalars]
    return (loss.detach(), torch.cat([gU[n] for n, _, _ in u_offs], dim=1),
            torch.cat(gi, dim=1), gD)


def _row_layout(spec):
    """(Wu, Wi, the item rows' scalar parameter columns, the user and the
    item rows' LazyAdam groups [(row offset, grad offset, width)]) of the
    specialized packed layout."""
    _, Wu = _offsets(spec.user_tables)
    _, Wi = _offsets(spec.item_tables)
    sc = [3 * Wi + 3 * j for j in range(len(spec.item_scalars))]
    return Wu, Wi, sc, [(0, 0, Wu)], [(0, 0, Wi)] + [(c, Wi + j, 1) for j, c in enumerate(sc)]


# --- the specialized state -------------------------------------------------


class PackedLazyState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    user_pmv: torch.Tensor  # [U, 3Wu]
    item_pmv: torch.Tensor  # [I, 3K + 3]
    tau_u: torch.Tensor  # [U] int32 last-touch step
    tau_i: torch.Tensor  # [I] int32
    dense: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}  # name: (p, m, v)


# the JAX package's per-model state names: one layout serves all three
PackedVbprState = PackedGradFashionState = PackedLazyState


def _zeros(x: torch.Tensor, *shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


@torch.no_grad()
def _pack(params, user_names, dense_names) -> PackedLazyState:
    """The packed state of a params mapping (e.g.
    ``dict(model.named_parameters())``): fresh tensors on the params'
    device, zero moments and tau."""
    user_p = torch.cat([params[n].detach() for n in user_names], dim=1)
    Gi, Bi = params["Gi"].detach(), params["Bi"].detach()
    U, I = user_p.shape[0], Gi.shape[0]
    user = torch.cat([user_p, _zeros(user_p, U, 2 * user_p.shape[1])], dim=1)
    item = torch.cat([Gi, _zeros(Gi, I, 2 * Gi.shape[1]), Bi[:, None], _zeros(Bi, I, 2)],
                     dim=1)
    dev = user.device
    dense = {n: (params[n].detach().clone(), torch.zeros_like(params[n]),
                 torch.zeros_like(params[n])) for n in dense_names}
    return PackedLazyState(torch.zeros((), dtype=torch.int32, device=dev), user, item,
                           torch.zeros(U, dtype=torch.int32, device=dev),
                           torch.zeros(I, dtype=torch.int32, device=dev), dense)


def pack_bprmf_state(params) -> PackedLazyState:
    """BPRMF (Gu, Gi, Bi)."""
    return _pack(params, ("Gu",), ())


def pack_vbpr_state(params) -> PackedLazyState:
    """VBPR (Gu, Tu, Gi, Bi, E, Bp)."""
    return _pack(params, ("Gu", "Tu"), ("E", "Bp"))


def pack_grad_fashion_state(params) -> PackedLazyState:
    """GradFashion (Gu, Tu, Gi, Bi, E, Bp, Ec, Ee)."""
    return _pack(params, ("Gu", "Tu"), ("E", "Bp", "Ec", "Ee"))


def unpack_packed_params(state: PackedLazyState, embed_k: int,
                         embed_d: int = 0) -> Dict[str, torch.Tensor]:
    """The standard params mapping as slice VIEWS of the packed tables (no
    copy): the steps update the tables in place, so the views follow them;
    clone them to keep a snapshot.  ``embed_d`` > 0 adds Tu; the dense
    params come as they are."""
    K, D = embed_k, embed_d
    out = {"Gu": state.user_pmv[:, :K], "Gi": state.item_pmv[:, :K],
           "Bi": state.item_pmv[:, 3 * K]}
    if D:
        out["Tu"] = state.user_pmv[:, K:K + D]
    out.update({n: pmv[0] for n, pmv in state.dense.items()})
    return out


unpack_bprmf_params = unpack_vbpr_params = unpack_grad_fashion_params = unpack_packed_params


# --- the step ----------------------------------------------------------------


def _read_tau(tau: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
    """float32 tau of the deduped ids; a pad (out of range) reads the last
    row, as K4 clamps its row read."""
    return tau[uids.long().clamp(max=tau.shape[0] - 1)].to(torch.float32)


def _stamp_tau(tau: torch.Tensor, uids: torch.Tensor, t: torch.Tensor) -> None:
    """tau[uids] = t in place for the real ids; the pads (2**30, out of
    range) are dropped by a mask: a pad's index is clamped into range and
    its value masked to 0, which the max never takes, since every tau is
    at most the state's step < t.  The max makes the write of duplicate
    indices exact in any order (no race, no host sync)."""
    real = uids.long() < tau.shape[0]
    idx = torch.where(real, uids.long(), 0)
    val = torch.where(real, t.to(torch.int32), 0).to(tau.dtype)
    tau.scatter_reduce_(0, idx, val, reduce="amax")


def _lazy_update(pmv, tau, read, write, g, t, lr, groups) -> None:
    """LazyAdam in place on the unique rows ``read`` (int32; K4 reads
    them), with ``g`` their summed grads: each (row offset, grad offset,
    width) group of ``groups`` over its 3 * width columns, written back to
    ``write`` through K5 and stamped in ``tau``; an id of ``write`` out of
    range is dropped by both."""
    rows = gather_rows(pmv, read)
    dt = (t - _read_tau(tau, read))[:, None]
    new = torch.cat([_lazy_rows(rows[:, off:off + 3 * w], g[:, g_off:g_off + w], dt, t, lr)
                     for off, g_off, w in groups], dim=1)
    scatter_rows_set(pmv, write, new)
    _stamp_tau(tau, write, t)


def _lazy_apply(pmv, tau, ids, g, t, lr, groups) -> None:
    """One dedupe of the batch's row grads, then ``_lazy_update`` (the
    dedupe's pads read some row and are dropped)."""
    uids, cg = compact_row_grads(ids, g, ids.shape[0])
    _lazy_update(pmv, tau, uids, uids, cg, t, lr, groups)


def make_packed_step(model, lr: float, reg: float) -> Callable:
    """``step(state, (users, pos, neg), frozen=None) -> (state, loss)``
    over a ``PackedLazyState`` packed for ``model`` (BPRMF, VBPR or
    GradFashion; reference loss semantics, LazyAdam update semantics):
    ``model.packed_loss`` over the rows the two forward gathers read,
    ``frozen`` (the model's frozen tables by name, e.g.
    ``dict(model.named_buffers())``) handed to it.  The row tables take
    packed LazyAdam, the dense params ordinary Adam."""
    spec = model.packed_spec()
    if spec.extra_items:
        raise ValueError("the specialized packed step reads no extra item rows: use "
                         "train/packed_generic.py")
    Wu, Wi, sc, user_groups, item_groups = _row_layout(spec)

    @torch.no_grad()
    def step(state: PackedLazyState, batch, frozen=None):
        u, p_ids, n_ids = (x.to(torch.int32) for x in batch)
        ii = torch.cat([p_ids, n_ids])
        UR = gather_rows(state.user_pmv, u)  # [B, 3Wu]
        IR = gather_rows(state.item_pmv, ii)  # [2B, 3K + 3]
        loss, gu, gi, gD = _row_grads(
            model, spec, UR[:, :Wu], IR[:, :Wi], IR[:, sc],
            {n: pmv[0] for n, pmv in state.dense.items()}, frozen,
            (u.long(), p_ids.long(), n_ids.long()), reg)
        t = (state.step + 1).to(torch.float32)
        # users: all user tables share one packed row and one dedupe;
        # items: the embedding and the bias grads share one dedupe
        _lazy_apply(state.user_pmv, state.tau_u, u, gu, t, lr, user_groups)
        _lazy_apply(state.item_pmv, state.tau_i, ii, gi, t, lr, item_groups)
        dense = {n: dense_adam(*pmv, gD[n], lr, t) for n, pmv in state.dense.items()}
        return state._replace(step=state.step + 1, dense=dense), loss

    return step


# the JAX package's per-model names
make_packed_bprmf_step = make_packed_vbpr_step = make_packed_grad_fashion_step = (
    make_packed_step)


# --- the epoch -------------------------------------------------------------


def run_specialized_steps(step_fn: Callable, state, triples):
    """``step_fn(state, (u, p, n))`` over one epoch's triples ([steps,
    batch] each).  Returns (state, summed loss as a 0-d tensor on the
    triples' device)."""
    users, pos, neg = triples
    losses = torch.empty(users.shape[0], dtype=torch.float32, device=users.device)
    for s in range(users.shape[0]):
        state, losses[s] = step_fn(state, (users[s], pos[s], neg[s]))
    return state, torch.sum(losses)


def make_packed_epoch_fn(model, lr: float, reg: float, num_items: int, steps: int,
                         batch: int, with_replacement=True,
                         device: DeviceLike = None) -> Callable:
    """``epoch(state, key, train_pairs, padded_pos, pos_counts, frozen=None)
    -> (state, summed loss)``: ``steps`` batches sampled on ``device``
    (``None`` = the CUDA card; raises without one) from the int ``key``
    itself, as the JAX epoch samples from its key, then
    ``make_packed_step``'s steps, ``frozen`` handed to each."""
    dev = resolve_device(device)
    step_fn = make_packed_step(model, lr, reg)

    def epoch(state, key: int, train_pairs, padded_pos, pos_counts, frozen=None):
        triples = sample_triplets(key, train_pairs, padded_pos, pos_counts, num_items,
                                  steps, batch, with_replacement=with_replacement,
                                  device=dev)
        return run_specialized_steps(functools.partial(step_fn, frozen=frozen), state,
                                     triples)

    return epoch


# the JAX package's per-model names
make_packed_vbpr_epoch_fn = make_packed_grad_fashion_epoch_fn = make_packed_epoch_fn


class PackedTrainState:
    """A specialized packed state as ``fit`` sees a train state: ``.step``,
    and ``.params``, the standard mapping (views of the packed tables, see
    ``unpack_packed_params``; for evaluation, the best-params copy and the
    checkpoint, never inside the step).  ``kind`` ("bprmf", "vbpr" or
    "grad_fashion") labels the layout.  A checkpoint
    (``core/checkpoint.py``) stores the fields named in ``_fields``: the
    packed state bit for bit and ``kind``, which a restore must find equal
    to the template's."""

    _fields = ("inner", "kind")

    def __init__(self, inner: PackedLazyState, kind: str, embed_k: int, embed_d: int = 0):
        self.inner = inner
        self.kind = kind
        self.embed_k = embed_k
        self.embed_d = embed_d

    def with_inner(self, inner: PackedLazyState) -> "PackedTrainState":
        return PackedTrainState(inner, self.kind, self.embed_k, self.embed_d)

    @property
    def step(self) -> torch.Tensor:
        return self.inner.step

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return unpack_packed_params(self.inner, self.embed_k, self.embed_d)
