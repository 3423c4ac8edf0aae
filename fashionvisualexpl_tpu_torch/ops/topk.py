"""Streaming blocked top-k and score-position counting (port of
``fashionvisualexpl_tpu/ops/topk.py``).

These ops consume FACTORED scores (score = u . v + b): a Python loop over
item blocks (the JAX package's ``lax.scan``) keeps a running top-k and a
running >=-count per user, so peak memory is [users_block x item_block]
whatever the catalog size.

Exclusions happen BY ID inside the loop, never by comparing externally
recomputed scores: the block product and a pointwise dot can disagree in
the last ulp, which would shift position counts at exact-tie boundaries.
The per-block score product is a plain ``torch.matmul`` in float32, as the
JAX package leaves it to XLA (no TF32: the counts compare scores exactly).

``bucket_banned_ids`` and ``banned_bucket_width`` are host-side numpy, as in
the JAX package; ``bucket_banned_ids_device`` places the offsets with an
integer scatter (JAX uses a float einsum at HIGHEST precision) and gives
the same bits.  Top-k uses ``torch.topk`` (JAX: ``approx_max_k`` with
``recall_target=1.0``, exact too); the two order tied scores differently.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

OUT_OF_RANGE_ID = 2**30  # filler id no catalog reaches


def _merge_topk(run_vals, run_idx, blk_vals, blk_idx, k):
    """Merge running [U, k] with block [U, kb] candidates -> new running."""
    vals = torch.cat([run_vals, blk_vals], dim=1)
    idx = torch.cat([run_idx, blk_idx], dim=1)
    new_vals, pos = torch.topk(vals, k, dim=1)
    return new_vals, torch.take_along_dim(idx, pos, dim=1)


def _blocks(user_vecs, item_vecs, item_bias, item_block):
    """(blk, n_blocks, iv [n_blocks*blk, D], ib [n_blocks*blk], valid
    [n_blocks*blk]) with the catalog padded to whole blocks."""
    I = item_vecs.shape[0]
    blk = min(item_block, I)
    n_blocks = -(-I // blk)
    pad = n_blocks * blk - I
    iv = F.pad(item_vecs, (0, 0, 0, pad))
    ib = (
        F.pad(item_bias, (0, pad)) if item_bias is not None
        else torch.zeros(n_blocks * blk, dtype=user_vecs.dtype,
                         device=user_vecs.device)
    )
    valid = torch.arange(n_blocks * blk, device=user_vecs.device) < I
    return blk, n_blocks, iv, ib, valid


def _ge_counts(scores, ref_scores, allowed, valid_b):
    """[Bu, T] int32 |{allowed, valid items with score >= ref[:, t]}|."""
    keep = allowed & valid_b[None, :]
    return torch.stack(
        [
            ((scores >= ref_scores[:, t : t + 1]) & keep).sum(
                dim=1, dtype=torch.int32
            )
            for t in range(ref_scores.shape[1])
        ],
        dim=1,
    )


def _allowed_by_id(gid, banned_ids, like):
    if banned_ids is None:  # no exclusions: every catalog item counts
        return torch.ones_like(like, dtype=torch.bool)
    return ~(gid[:, :, None] == banned_ids[:, None, :]).any(dim=2)


def streaming_topk_and_counts(
    user_vecs: torch.Tensor,  # [Bu, D]
    item_vecs: torch.Tensor,  # [I, D]
    item_bias: Optional[torch.Tensor],  # [I] or None
    k: int,
    ref_scores: Optional[torch.Tensor] = None,  # [Bu, T] reference scores
    banned_ids: Optional[torch.Tensor] = None,  # [Bu, Pb] ids EXCLUDED from counts
    item_block: int = 4096,
    item_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One pass over the catalog in blocks.

    Returns (top_vals [Bu, k], top_idx [Bu, k] global int32 ids, ge_counts
    [Bu, T] int32 or None) where ge_counts[t] = |{i not in banned_ids[u] :
    s_ui >= ref_scores[u, t]}| over these items.  Pad banned_ids with a
    negative value (never matches a catalog id).  Top-k filler entries
    (users with fewer than k finite candidates) carry OUT_OF_RANGE_ID."""
    Bu = user_vecs.shape[0]
    dev = user_vecs.device
    blk, n_blocks, iv, ib, valid = _blocks(user_vecs, item_vecs, item_bias,
                                           item_block)
    kb = min(k, blk)
    run_vals = torch.full((Bu, k), float("-inf"), dtype=user_vecs.dtype, device=dev)
    run_idx = torch.full((Bu, k), OUT_OF_RANGE_ID, dtype=torch.int32, device=dev)
    counts = (
        torch.zeros(ref_scores.shape, dtype=torch.int32, device=dev)
        if ref_scores is not None else None
    )
    for b in range(n_blocks):
        lo, hi = b * blk, (b + 1) * blk
        valid_b = valid[lo:hi]
        scores = user_vecs @ iv[lo:hi].T + ib[None, lo:hi]  # [Bu, blk]
        scores = torch.where(valid_b[None, :], scores, float("-inf"))
        blk_vals, blk_pos = torch.topk(scores, kb, dim=1)
        blk_idx = blk_pos.to(torch.int32) + (lo + item_offset)
        # filler lanes (-inf from block padding) get the sentinel id
        blk_idx = torch.where(torch.isneginf(blk_vals), OUT_OF_RANGE_ID, blk_idx)
        run_vals, run_idx = _merge_topk(run_vals, run_idx, blk_vals, blk_idx, k)
        if counts is not None:
            gid = torch.arange(lo, hi, dtype=torch.int32, device=dev)[None, :]
            allowed = _allowed_by_id(gid + item_offset, banned_ids, scores)
            counts = counts + _ge_counts(scores, ref_scores, allowed, valid_b)
    return run_vals, run_idx, counts


def streaming_counts(
    user_vecs: torch.Tensor,  # [Bu, D]
    item_vecs: torch.Tensor,  # [I, D]
    item_bias: Optional[torch.Tensor],  # [I] or None
    ref_scores: torch.Tensor,  # [Bu, T]
    banned_ids: Optional[torch.Tensor],  # [Bu, Pb] ids EXCLUDED from counts
    item_block: int = 4096,
    item_offset: int = 0,
) -> torch.Tensor:
    """Counts-only streaming pass: ge_counts [Bu, T] int32 as in
    streaming_topk_and_counts, WITHOUT the top-k accumulation (the
    per-epoch metric path needs no top-k: the rank follows from these
    counts, eval/factored.py)."""
    dev = user_vecs.device
    blk, n_blocks, iv, ib, valid = _blocks(user_vecs, item_vecs, item_bias,
                                           item_block)
    counts = torch.zeros(ref_scores.shape, dtype=torch.int32, device=dev)
    for b in range(n_blocks):
        lo, hi = b * blk, (b + 1) * blk
        scores = user_vecs @ iv[lo:hi].T + ib[None, lo:hi]  # [Bu, blk]
        gid = torch.arange(lo, hi, dtype=torch.int32, device=dev)[None, :]
        allowed = _allowed_by_id(gid + item_offset, banned_ids, scores)
        counts = counts + _ge_counts(scores, ref_scores, allowed, valid[lo:hi])
    return counts


def _bucket_positions(banned, num_items, blk):
    """Shared bucketing core: per banned id, its (block, position-in-block
    -group) under a stable per-row sort by block.  Invalid ids (outside
    [0, num_items)) sort into a past-the-end bucket."""
    Bu, Pb = banned.shape
    n_blocks = -(-num_items // blk)
    in_range = (banned >= 0) & (banned < num_items)
    block_of = np.where(in_range, banned // blk, n_blocks)
    order = np.argsort(block_of, axis=1, kind="stable")
    sb = np.take_along_axis(block_of, order, axis=1)
    sid = np.take_along_axis(banned, order, axis=1)
    idx = np.arange(Pb)
    change = np.empty((Bu, Pb), bool)
    change[:, 0] = True
    if Pb > 1:
        change[:, 1:] = sb[:, 1:] != sb[:, :-1]
    start = np.maximum.accumulate(np.where(change, idx[None, :], 0), axis=1)
    pos = idx[None, :] - start  # position within the (user, block) group
    return n_blocks, sb, sid, pos, sb < n_blocks


def banned_bucket_width(
    banned_ids, num_items: int, item_block: int, chunk: int = 65536
) -> int:
    """Max ids any one user has in any one item block (the static W for
    bucket_banned_ids), computed in user chunks so 10^6-user tables never
    materialize the full bucket tensor."""
    banned = np.asarray(banned_ids)
    blk = min(item_block, num_items)
    W = 1
    for s in range(0, banned.shape[0], chunk):
        _, _, _, pos, valid = _bucket_positions(
            banned[s:s + chunk], num_items, blk
        )
        if valid.any():
            W = max(W, int(pos[valid].max()) + 1)
    return W


def bucket_banned_ids(
    banned_ids, num_items: int, item_block: int, width: Optional[int] = None
):
    """Bucket per-user banned ids by item block (host-side, numpy).

    Returns (local [n_blocks, Bu, W] int32 block-LOCAL offsets, valid
    [n_blocks, Bu, W] bool), W = max ids any user has in any one block.
    Ids outside [0, num_items) (the pad convention, e.g. -1) are dropped.
    Duplicate-safe: the consumer ORs equality over W exactly like the
    unbucketed mask pass.  ``width`` pins W (probe with
    banned_bucket_width); raises if any bucket overflows it."""
    banned = np.asarray(banned_ids)
    Bu, Pb = banned.shape
    blk = min(item_block, num_items)
    n_blocks, sb, sid, pos, valid_e = _bucket_positions(banned, num_items, blk)
    w_needed = int(pos[valid_e].max()) + 1 if valid_e.any() else 1
    W = width if width is not None else max(1, w_needed)
    if w_needed > W:
        raise ValueError(f"bucket width {w_needed} exceeds pinned {W}")

    local = np.zeros((n_blocks, Bu, W), np.int32)
    valid = np.zeros((n_blocks, Bu, W), bool)
    u_idx = np.broadcast_to(np.arange(Bu)[:, None], (Bu, Pb))
    b, u, p = sb[valid_e], u_idx[valid_e], pos[valid_e]
    local[b, u, p] = (sid[valid_e] - b * blk).astype(np.int32)
    valid[b, u, p] = True
    return local, valid


def bucket_banned_ids_device(
    banned: torch.Tensor,  # [Bu, Pb] int, pad < 0 or >= num_items
    num_items: int,
    item_block: int,
    width: int,
    return_overflow: bool = False,
):
    """bucket_banned_ids on the device: (local [n_blocks, Bu, W] int32,
    valid [n_blocks, Bu, W] bool), bit-equal to the JAX package's.

    ``width`` must come from a banned_bucket_width probe: an id whose
    in-block rank reaches ``width`` is DROPPED (it would then count as a
    negative).  ``return_overflow=True`` adds the number of dropped ids as
    a third output, for callers whose width is not probe-backed.

    Position in group: the number of earlier ids of the same (user, tile).
    Placement: an integer scatter of (tile, user, position) -> offset; each
    slot is hit by at most one id, so the result does not depend on the
    scatter's order.  Offsets reach item_block - 1, which an integer
    placement keeps exact whatever the matmul precision."""
    Bu, Pb = banned.shape
    dev = banned.device
    banned = banned.to(torch.int64)
    blk = min(item_block, num_items)
    n_blocks = -(-num_items // blk)
    in_range = (banned >= 0) & (banned < num_items)
    tile = torch.where(in_range, torch.div(banned, blk, rounding_mode="floor"), -1)
    ar = torch.arange(Pb, device=dev)
    same_earlier = (tile[:, :, None] == tile[:, None, :]) & (
        ar[None, None, :] < ar[None, :, None]
    )
    pos = same_earlier.sum(dim=2)  # [Bu, Pb]
    keep = in_range & (pos < width)
    t_k = tile[keep]
    u_k = torch.arange(Bu, device=dev)[:, None].expand(Bu, Pb)[keep]
    p_k = pos[keep]
    loc = torch.zeros((n_blocks, Bu, width), dtype=torch.int32, device=dev)
    msk = torch.zeros((n_blocks, Bu, width), dtype=torch.bool, device=dev)
    loc[t_k, u_k, p_k] = (banned[keep] - t_k * blk).to(torch.int32)
    msk[t_k, u_k, p_k] = True
    if return_overflow:
        overflow = (in_range & (pos >= width)).sum(dtype=torch.int32)
        return loc, msk, overflow
    return loc, msk


def streaming_counts_bucketed(
    user_vecs: torch.Tensor,  # [Bu, D]
    item_vecs: torch.Tensor,  # [I, D]
    item_bias: Optional[torch.Tensor],  # [I] or None
    ref_scores: torch.Tensor,  # [Bu, T]
    banned_local: torch.Tensor,  # [n_blocks, Bu, W] block-local banned offsets
    banned_valid: torch.Tensor,  # [n_blocks, Bu, W]
    item_block: int = 4096,
) -> torch.Tensor:
    """streaming_counts with PRE-BUCKETED banned ids (bucket_banned_ids):
    the same counts, with the per-block exclusion compare cut from the full
    banned width Pb to the per-block width W."""
    dev = user_vecs.device
    blk, n_blocks, iv, ib, valid = _blocks(user_vecs, item_vecs, item_bias,
                                           item_block)
    if banned_local.shape[0] != n_blocks:
        raise ValueError(
            f"banned buckets built for {banned_local.shape[0]} blocks, "
            f"scan has {n_blocks}"
        )
    local_iota = torch.arange(blk, dtype=torch.int32, device=dev)
    counts = torch.zeros(ref_scores.shape, dtype=torch.int32, device=dev)
    for b in range(n_blocks):
        lo, hi = b * blk, (b + 1) * blk
        scores = user_vecs @ iv[lo:hi].T + ib[None, lo:hi]  # [Bu, blk]
        is_banned = (
            (local_iota[None, :, None] == banned_local[b][:, None, :])
            & banned_valid[b][:, None, :]
        ).any(dim=2)  # [Bu, blk]
        counts = counts + _ge_counts(scores, ref_scores, ~is_banned, valid[lo:hi])
    return counts


def filter_items_topk(
    top_vals: torch.Tensor,  # [Bu, k_big] sorted desc
    top_idx: torch.Tensor,  # [Bu, k_big]
    banned: torch.Tensor,  # [Bu, P] padded banned ids (e.g. train items)
    banned_counts: torch.Tensor,  # [Bu]
    k: int,
):
    """Drop banned ids from an oversized candidate list and keep the first
    k (the masking trick replacing the dense [U, I] -inf mask,
    Evaluator.py:232-234)."""
    P = banned.shape[1]
    valid_b = torch.arange(P, device=banned.device)[None, :] < banned_counts[:, None]
    is_banned = (
        (top_idx[:, :, None] == banned[:, None, :]) & valid_b[:, None, :]
    ).any(dim=2)
    vals = top_vals.masked_fill(is_banned, float("-inf"))
    new_vals, pos = torch.topk(vals, k, dim=1)
    return new_vals, torch.take_along_dim(top_idx, pos, dim=1)
