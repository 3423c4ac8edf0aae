"""Exact on-device negative sampling (port of
``fashionvisualexpl_tpu/data/sampler.py``).

For user u with sorted unique positives p_0 < p_1 < ... < p_{c-1}, the r-th
smallest NON-positive item (r uniform in [0, num_items - c)) is

    j = r + k,   k = |{ t : p_t - t <= r }|

computed as one O(P) comparison count over the fixed-width padded rows
(out-of-range sentinels from data/interactions.py:pad_sorted_positives never
count): no rejection loop, exactly uniform over the complement.

Each epoch scheme is split in two.  ``triplets_from_draws`` is the core: it
takes the epoch's random draws as tensors (``order`` is the permutation, or
the bootstrap indices; ``u01`` the [take] uniforms of the negative sampler)
and is deterministic, so the tests feed it JAX's ``split(key)`` draws and
get JAX's triples bit for bit.  ``sample_triplets`` is the wrapper that
makes the draws with a seeded ``torch.Generator`` on the tables' device.
Ids are int32 at the boundary, as in JAX; indexing runs in int64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device

SCHEMES = ("user_perm", "pair_perm", "bootstrap")


def scheme_name(with_replacement) -> str:
    """False -> "user_perm", True -> "bootstrap", a scheme name as is."""
    mode = {False: "user_perm", True: "bootstrap"}.get(
        with_replacement, with_replacement
    )
    if mode not in SCHEMES:
        raise ValueError(f"unknown sampling scheme {with_replacement!r}")
    return mode


def _negatives_from_rows(u01, rows, counts, num_items):
    """Closed-form complement sampling given pre-gathered positive rows."""
    c = num_items - counts  # [B] int32
    r = torch.floor(u01 * c).to(torch.int32)
    r = torch.minimum(r, c - 1)  # guard the u01 == 1.0 edge
    arange = torch.arange(rows.shape[1], dtype=torch.int32, device=rows.device)
    shifted = rows - arange[None, :]  # [B, P]
    k = torch.sum(shifted <= r[:, None], dim=1, dtype=torch.int32)
    return r + k


def derived_pairs_ok(train_pairs, padded_pos) -> bool:
    """Host-side eligibility check for the derived-pairs mode
    (``train_pairs=None``): True iff the row-major flattening of
    ``padded_pos`` IS the user-major pair list (every user has exactly
    ``padded_pos.shape[1]`` positives stored in the padded rows' ascending
    order).  Then the derived mode gives the same triples as the
    materialised one for all three schemes."""
    train_pairs = np.asarray(train_pairs)
    padded_pos = np.asarray(padded_pos)
    U, Pw = padded_pos.shape
    if train_pairs.shape != (U * Pw, 2):  # non-uniform counts exit here
        return False
    by_user = train_pairs.reshape(U, Pw, 2)
    if not bool((by_user[:, :, 0] == np.arange(U)[:, None]).all()):
        return False
    return bool((by_user[:, :, 1] == padded_pos).all())


def sample_negatives(
    u01: torch.Tensor,  # [B] float32 uniforms
    users: torch.Tensor,  # [B] int
    padded_pos: torch.Tensor,  # [U, P] int32, strictly increasing rows
    pos_counts: torch.Tensor,  # [U] int32
    num_items: int,
) -> torch.Tensor:
    """One negative item per batch row, uniform over non-positives."""
    users = users.long()
    return _negatives_from_rows(u01, padded_pos[users], pos_counts[users], num_items)


def _uniform_runs(perm_u, rows_u, u01, num_items, take):
    """user_perm with uniform counts: users' runs in permuted order, one
    negative per slot from the run's own row (the derived and the
    materialised uniform paths share this after their pos lookup)."""
    nu, Pw = rows_u.shape
    users = perm_u.to(torch.int32)[:, None].expand(nu, Pw).reshape(nu * Pw)[:take]
    c = num_items - Pw
    r = torch.floor(u01 * c).to(torch.int32).clamp_max(c - 1)
    r_u = torch.nn.functional.pad(r, (0, nu * Pw - take)).reshape(nu, Pw)
    arange = torch.arange(Pw, dtype=torch.int32, device=rows_u.device)
    shifted = rows_u - arange[None, :]
    k = torch.sum(shifted[:, None, :] <= r_u[:, :, None], dim=2, dtype=torch.int32)
    neg = (r_u + k).reshape(nu * Pw)[:take]
    return users, neg


def triplets_from_draws(
    scheme: str,
    order: torch.Tensor,  # user_perm: [U] perm; pair_perm: [n] perm; bootstrap: [take] idx
    u01: torch.Tensor,  # [take] float32 uniforms for the negatives
    train_pairs: Optional[torch.Tensor],  # [N, 2] int32 user-major, or None
    padded_pos: torch.Tensor,  # [U, P] int32
    pos_counts: torch.Tensor,  # [U] int32
    num_items: int,
    num_steps: int,
    batch_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch of BPR triples from its draws: (users, pos, neg), each
    [num_steps, batch_size] int32.  The draws and the visit order are
    JAX's (``sample_triplets`` there); the unfilled tail batch is dropped.
    ``train_pairs=None`` re-derives the pair list from ``padded_pos``
    (requires ``derived_pairs_ok``)."""
    scheme = scheme_name(scheme)
    derived = train_pairs is None
    U, Pw = padded_pos.shape
    n = U * Pw if derived else train_pairs.shape[0]
    take = num_steps * batch_size
    shape = (num_steps, batch_size)
    order = order.long()
    if scheme == "bootstrap":
        idx = order
    elif scheme == "pair_perm":
        idx = order[:take]
    else:
        perm = order
        # only the first ceil(take / Pw) permuted users' runs are consumed
        nu = min(U, -(-take // Pw)) if Pw else U
        if derived or n == U * Pw:
            # uniform counts (provable from shapes: n == U * Pw): shuffle
            # whole user runs; the pair list is row perm[k] of padded_pos
            perm_u = perm[:nu]
            rows_u = padded_pos[perm_u]  # [nu, Pw]
            if derived:
                pos = rows_u.reshape(nu * Pw)[:take]
            else:
                arange = torch.arange(Pw, dtype=torch.int64, device=perm.device)
                idx_u = (perm_u[:, None] * Pw + arange[None, :]).reshape(nu * Pw)[:take]
                pos = train_pairs[:, 1][idx_u]
            users, neg = _uniform_runs(perm_u, rows_u, u01, num_items, take)
            return users.reshape(shape), pos.reshape(shape), neg.reshape(shape)
        # ragged counts: segment of output slot j = (run starts <= j) - 1,
        # by scatter-add + cumsum; zero-count users collapse onto the next
        # start
        counts = pos_counts.long()
        permuted_counts = counts[perm]
        out_starts = torch.cumsum(permuted_counts, 0) - permuted_counts
        row_starts = torch.cumsum(counts, 0) - counts
        delta = torch.zeros(n + 1, dtype=torch.int64, device=perm.device)
        delta.index_add_(0, out_starts, torch.ones_like(out_starts))
        seg = (torch.cumsum(delta, 0) - 1)[:take]
        within = torch.arange(take, dtype=torch.int64, device=perm.device) - out_starts[seg]
        idx = row_starts[perm[seg]] + within
    if derived:
        # pair idx -> (user, slot) arithmetically; positives come from the
        # row gather the negative sampler needs anyway
        users = idx // Pw
        slot = idx % Pw
        rows = padded_pos[users]  # [take, Pw]
        pos = torch.gather(rows, 1, slot[:, None])[:, 0]
        neg = _negatives_from_rows(u01, rows, pos_counts[users], num_items)
        users = users.to(torch.int32)
        return users.reshape(shape), pos.reshape(shape), neg.reshape(shape)
    pairs = train_pairs[idx]
    # contiguous columns: the packed engines hand each step's ids to the
    # row gather K4, which takes contiguous ids only
    users = pairs[:, 0].contiguous()
    pos = pairs[:, 1].contiguous()
    neg = sample_negatives(u01, users, padded_pos, pos_counts, num_items)
    return users.reshape(shape), pos.reshape(shape), neg.reshape(shape)


def sample_triplets(
    seed: int,
    train_pairs: Optional[torch.Tensor],
    padded_pos: torch.Tensor,
    pos_counts: torch.Tensor,
    num_items: int,
    num_steps: int,
    batch_size: int,
    with_replacement=False,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch of shuffled BPR triples on ``device`` (``None`` = the CUDA
    card; raises without one).  The draws come from a ``torch.Generator``
    on that device seeded with ``seed``: the permutation (or bootstrap
    indices) first, then the [take] uniforms.  The tables must already be
    on the device.  See ``triplets_from_draws`` for the schemes."""
    dev = resolve_device(device)
    for name, t in (("train_pairs", train_pairs), ("padded_pos", padded_pos),
                    ("pos_counts", pos_counts)):
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"{name} is on {t.device}, the sampler on {dev}")
    scheme = scheme_name(with_replacement)
    U, Pw = padded_pos.shape
    n = U * Pw if train_pairs is None else train_pairs.shape[0]
    take = num_steps * batch_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    if scheme == "bootstrap":
        order = torch.randint(0, n, (take,), generator=gen, device=dev)
    else:
        size = U if scheme == "user_perm" else n
        order = torch.randperm(size, generator=gen, device=dev)
    u01 = torch.rand(take, generator=gen, device=dev)
    return triplets_from_draws(scheme, order, u01, train_pairs, padded_pos,
                               pos_counts, num_items, num_steps, batch_size)
