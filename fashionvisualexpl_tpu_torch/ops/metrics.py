"""Vectorized full-catalog ranking metrics (port of
``fashionvisualexpl_tpu/ops/metrics.py``).

Exact semantic parity with the reference's per-user host loop
(src/recommender/Evaluator.py:82-128), computed for a whole user block at
once.  The reference protocol, reproduced faithfully:

- Candidate list per user = (all items - train items) + eval items, with the
  split's eval items logically at the tail (Evaluator.py:40-53).
- AUC: ``position`` = sum over eval items t of |{negatives with score >=
  s_t}|, negatives = candidates minus eval items; auc = 1 - position /
  (num_neg * num_pos) (Evaluator.py:92-101).
- HR / Precision / Recall from count-based hits: under the candidate
  protocol (negatives in id order, eval items at the tail, stable heapq
  ordering) eval item t is in the top-k iff rank_t < k, rank_t =
  |negatives >= s_t| + |earlier eval items >= s_t| + |later eval items >
  s_t|.  No top-k over the item axis.
- NDCG (the reference's nonstandard formula, Evaluator.py:120):
  log(2)/log(position + 2) if position < k else 0 — the *AUC* position
  count, not a rank.
- Users with an empty eval list are masked out of the mean
  (Evaluator.py:189-193 via the filter at :84-87).

Eval items come padded ([U, T], with a validity count vector); masks are
dense [U, I] bools.  ``topk_recommendations`` uses ``torch.topk`` where the
JAX package uses ``approx_max_k(recall_target=1.0)`` (exact there too); the
two order tied scores differently.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class PerUserMetrics(NamedTuple):
    hr: torch.Tensor  # [U]
    prec: torch.Tensor  # [U]
    rec: torch.Tensor  # [U]
    auc: torch.Tensor  # [U]
    ndcg: torch.Tensor  # [U]
    valid: torch.Tensor  # [U] bool — user has a non-empty eval list


class MeanMetrics(NamedTuple):
    hr: torch.Tensor
    prec: torch.Tensor
    rec: torch.Tensor
    auc: torch.Tensor
    ndcg: torch.Tensor
    num_users: torch.Tensor


def eval_above_counts(s_eval: torch.Tensor, t_valid: torch.Tensor) -> torch.Tensor:
    """[U, T] int32: eval items ranked above eval item t under the stable
    heapq order — earlier items with >= (they win ties), later ones with >."""
    T = s_eval.shape[1]
    ar = torch.arange(T, device=s_eval.device)
    later_gt = (s_eval[:, None, :] > s_eval[:, :, None]) & (
        ar[None, None, :] > ar[None, :, None]
    )
    earlier_ge = (s_eval[:, None, :] >= s_eval[:, :, None]) & (
        ar[None, None, :] < ar[None, :, None]
    )
    return ((later_gt | earlier_ge) & t_valid[:, None, :]).sum(
        dim=2, dtype=torch.int32
    )


def metrics_from_positions(
    position_t: torch.Tensor,  # [U, T] int32 negatives >= each eval score
    s_eval: torch.Tensor,  # [U, T] eval item scores
    eval_counts: torch.Tensor,  # [U] int32
    num_neg: torch.Tensor,  # [U] int32
    k: int,
) -> PerUserMetrics:
    """The per-user metrics from the position counts (shared by the dense
    and the streaming evaluator)."""
    T = s_eval.shape[1]
    t_valid = (
        torch.arange(T, device=s_eval.device)[None, :] < eval_counts[:, None]
    )
    position = torch.where(t_valid, position_t, 0).sum(dim=1, dtype=torch.int32)
    denom = torch.clamp_min(num_neg * eval_counts, 1).to(torch.float32)
    auc = 1.0 - position.to(torch.float32) / denom
    rank_t = position_t + eval_above_counts(s_eval, t_valid)
    hits = (t_valid & (rank_t < k)).sum(dim=1).to(torch.float32)
    hr = (hits > 0).to(torch.float32)
    prec = hits / float(k)
    rec = hits / torch.clamp_min(eval_counts, 1).to(torch.float32)
    log2 = torch.tensor(math.log(2.0), dtype=torch.float32, device=s_eval.device)
    ndcg = torch.where(
        position < k,
        log2 / torch.log(position.to(torch.float32) + 2.0),
        torch.zeros((), dtype=torch.float32, device=s_eval.device),
    )
    return PerUserMetrics(hr, prec, rec, auc, ndcg, eval_counts > 0)


def eval_users(
    scores: torch.Tensor,  # [U, I] float
    train_mask: torch.Tensor,  # [U, I] bool
    eval_items: torch.Tensor,  # [U, T] int, padded (pad value arbitrary in-range)
    eval_counts: torch.Tensor,  # [U] int32 — number of valid eval items per user
    k: int,
) -> PerUserMetrics:
    U, I = scores.shape
    T = eval_items.shape[1]
    eval_counts = eval_counts.to(torch.int32)
    t_valid = (
        torch.arange(T, device=scores.device)[None, :] < eval_counts[:, None]
    )  # [U, T]
    items = eval_items.long()
    # scatter-or of the valid eval items (a pad slot never clears a hit)
    eval_mask = torch.zeros((U, I), dtype=torch.uint8, device=scores.device)
    eval_mask = eval_mask.scatter_reduce(
        1, items, t_valid.to(torch.uint8), reduce="amax"
    ).bool()
    neg_mask = ~train_mask & ~eval_mask  # [U, I]
    pos_scores = torch.take_along_dim(scores, items, dim=1)  # [U, T]
    # position_t[u, t] = |{i in neg : scores[u,i] >= pos_scores[u,t]}|, a
    # loop over the small T axis (no [U, I, T] intermediate)
    position_t = torch.stack(
        [
            (neg_mask & (scores >= pos_scores[:, t : t + 1])).sum(
                dim=1, dtype=torch.int32
            )
            for t in range(T)
        ],
        dim=1,
    )
    num_neg = neg_mask.sum(dim=1, dtype=torch.int32)
    return metrics_from_positions(position_t, pos_scores, eval_counts, num_neg, k)


def mean_metrics(m: PerUserMetrics) -> MeanMetrics:
    n = torch.clamp_min(m.valid.sum(), 1).to(torch.float32)

    def avg(x):
        return torch.where(m.valid, x, 0.0).sum() / n

    return MeanMetrics(
        hr=avg(m.hr),
        prec=avg(m.prec),
        rec=avg(m.rec),
        auc=avg(m.auc),
        ndcg=avg(m.ndcg),
        num_users=m.valid.sum(),
    )


def topk_recommendations(
    scores: torch.Tensor,  # [U, I]
    train_mask: torch.Tensor,  # [U, I] bool
    k: int,
):
    """Top-k over all items with train items masked to -inf — the protocol
    of Evaluator.store_recommendation (Evaluator.py:225-239).  Returns
    (top_idx [U, k], top_scores [U, k]) sorted descending."""
    masked = scores.masked_fill(train_mask, float("-inf"))
    top_scores, top_idx = torch.topk(masked, k, dim=1)
    return top_idx, top_scores
