"""Full-catalog evaluator (port of ``fashionvisualexpl_tpu/eval/evaluator.py``).

Replaces the reference Evaluator (src/recommender/Evaluator.py) — its
fork-pool candidate lists and per-user Python metric loop — with a
device-resident [U, I] train mask and one vectorized metric function per
user block, so eval memory is bounded at block_users x num_items (plus the
mask).  For catalogs where [U, I] does not fit, use the streaming
``eval/factored.py::FactoredEvaluator``.

Also the recommendation dump with the reference's TSV format
(Evaluator.py:225-239).  Known reference bug NOT reproduced: the reference
records test AUC from the validation value ('auc_t': auc_v,
Evaluator.py:220); here auc_t is the test AUC, as in the JAX package.

``evaluate`` and every dump encode the model's items once
(``precompute_eval``), shared by both splits or by every user block.

``store_recommendation_grads`` writes the gradient-attribution dump
(``explain/grads.py``).
"""

from __future__ import annotations

import datetime
from typing import Dict, List

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.device import resolve_device
from fashionvisualexpl_tpu_torch.data.interactions import (
    Interactions,
    multi_hot,
    pad_lists,
)
from fashionvisualexpl_tpu_torch.ops.metrics import (
    MeanMetrics,
    PerUserMetrics,
    eval_users,
    mean_metrics,
    topk_recommendations,
)


def _block_starts(n: int, block: int) -> List[int]:
    return list(range(0, n, block))


def block_ids(start: int, block: int, n: int):
    """(ids [block] int64, in_range [block] bool) of one fixed-shape user
    block: the tail wraps around (``idx % n``) and is masked out."""
    ar = np.arange(block) + start
    return ar % n, ar < n


def concat_metrics(per_user: List[PerUserMetrics]) -> PerUserMetrics:
    return PerUserMetrics(*[torch.cat(f) for f in zip(*per_user)])


def split_record(test: MeanMetrics, val) -> Dict[str, float]:
    """The reference's results-dict schema (Evaluator.py:216-221, auc_t bug
    fixed); zeros for the validation keys when there is no validation."""
    out = dict(
        hr_t=float(test.hr), p_t=float(test.prec), r_t=float(test.rec),
        auc_t=float(test.auc), ndcg_t=float(test.ndcg),
    )
    if val is not None:
        out.update(
            hr_v=float(val.hr), p_v=float(val.prec), r_v=float(val.rec),
            auc_v=float(val.auc), ndcg_v=float(val.ndcg),
        )
    else:
        out.update(hr_v=0.0, p_v=0.0, r_v=0.0, auc_v=0.0, ndcg_v=0.0)
    return out


class Evaluator:
    """Dense evaluator over ``model`` (scores from
    ``model.predict_user_block``); its tables live on the model's device."""

    def __init__(
        self,
        model,
        data: Interactions,
        k: int = 20,
        user_block: int = 2048,
    ):
        self.model = model
        self.data = data
        self.k = k
        self.user_block = min(user_block, data.num_users)
        self.device = resolve_device(model.device)
        dev = self.device

        self._train_mask = torch.as_tensor(
            multi_hot(data.training_list, data.num_items), device=dev
        )
        test_padded, test_counts = pad_lists(data.test_list, pad_value=0)
        self._test_items = torch.as_tensor(test_padded, device=dev)
        self._test_counts = torch.as_tensor(test_counts, device=dev)
        if data.has_validation:
            val_padded, val_counts = pad_lists(data.validation_list, pad_value=0)
            self._val_items = torch.as_tensor(val_padded, device=dev)
            self._val_counts = torch.as_tensor(val_counts, device=dev)
        else:
            self._val_items = None
            self._val_counts = None

    # --- core ---

    def _scores(self, params, ids, ctx):
        scores = self.model.predict_user_block(ids, ctx, params=params)
        return scores[:, : self.data.num_items]

    @torch.no_grad()
    def _eval_block(self, split, params, frozen, user_ids, ctx) -> PerUserMetrics:
        """Score one user block and compute its per-user metrics."""
        del frozen
        scores = self._scores(params, user_ids, ctx)
        train_mask = self._train_mask[user_ids]
        if split == "val":
            items, counts = self._val_items[user_ids], self._val_counts[user_ids]
        else:
            items, counts = self._test_items[user_ids], self._test_counts[user_ids]
        return eval_users(scores, train_mask, items, counts, self.k)

    def _eval_split(self, split: str, params, frozen, ctx=None) -> MeanMetrics:
        U = self.data.num_users
        if ctx is None:
            ctx = self.model.precompute_eval(params)
        per_user = []
        for start in _block_starts(U, self.user_block):
            # fixed block shape (wrap-around tail), as in the JAX package
            idx, in_range = block_ids(start, self.user_block, U)
            m = self._eval_block(split, params, frozen,
                                 torch.as_tensor(idx, device=self.device), ctx)
            m = m._replace(valid=m.valid & torch.as_tensor(in_range, device=self.device))
            per_user.append(m)
        return mean_metrics(concat_metrics(per_user))

    def evaluate(self, params, frozen) -> Dict[str, float]:
        """Metrics for validation (if present) and test, with the
        reference's results-dict schema.  ``params`` maps names to tensors
        (``fit`` passes its state's params); ``None`` scores the model's
        own parameters."""
        ctx = self.model.precompute_eval(params)
        t = self._eval_split("test", params, frozen, ctx)
        v = (self._eval_split("val", params, frozen, ctx)
             if self._val_items is not None else None)
        return split_record(t, v)

    # --- reporting (reference print format, Evaluator.py:194-215) ---

    def print_epoch(self, epoch, total_epochs, mean_loss, rec) -> None:
        print_epoch_block(self.k, epoch, total_epochs, mean_loss, rec)

    # --- recommendation dumps (Evaluator.py:225-275 formats) ---

    @torch.no_grad()
    def _dump(self, params, path: str, columns=None) -> None:
        """Top-k rows `user\\titem\\tscore` per user block, train items
        masked; ``columns(ids, ctx, top_idx) -> [B, k, c]`` appends c more
        values to each row.  The items are encoded once (``ctx``)."""
        U = self.data.num_users
        ctx = self.model.precompute_eval(params)
        with open(path, "w") as out:
            for start in _block_starts(U, self.user_block):
                idx, _ = block_ids(start, self.user_block, U)
                ids = torch.as_tensor(idx, device=self.device)
                top_idx, top_scores = topk_recommendations(
                    self._scores(params, ids, ctx), self._train_mask[ids], self.k
                )
                extra = None if columns is None else columns(ids, ctx, top_idx).cpu().numpy()
                top_idx = top_idx.to(torch.int32).cpu().numpy()
                top_scores = top_scores.cpu().numpy()
                for row in range(min(self.user_block, U - start)):
                    for j in range(self.k):
                        tail = "" if extra is None else "".join(f"\t{a}" for a in extra[row, j])
                        out.write(f"{start + row}\t{top_idx[row, j]}\t"
                                  f"{top_scores[row, j]}{tail}\n")

    def store_recommendation(self, params, frozen, path: str) -> None:
        """Plain top-k TSV: `user\\titem\\tscore` rows, train items masked
        (Evaluator.py:225-239).  ``params`` as for ``evaluate``; the model's
        own parameters are not touched."""
        del frozen
        self._dump(params, path)

    def store_recommendation_attention(self, params, frozen, path: str,
                                       attention_fn) -> None:
        """Attention-augmented top-k TSV (Evaluator.py:241-259):
        `user\\titem\\tscore\\talpha_color\\talpha_edges\\talpha_class`.

        ``attention_fn(params, frozen, user_ids, ctx) -> [B, I, 3]`` weights,
        ``ctx`` the model's ``precompute_eval`` (computed once per dump)."""
        self._dump(params, path, lambda ids, ctx, top_idx: torch.take_along_dim(
            attention_fn(params, frozen, ids, ctx), top_idx[:, :, None], dim=1))

    def store_recommendation_grads(self, params, frozen, path: str,
                                   grads_fn=None, batch_grads_fn=None) -> None:
        """Gradient-attribution TSV (Evaluator.py:261-275):
        ``user\\titem\\tcolor_attr\\tedges_attr`` for every positive (train +
        validation + test) item of each user, through
        ``explain/grads.py::write_grads_tsv``: ``batch_grads_fn(params,
        frozen, users [B], items [B, W]) -> [B, W, 2]`` runs the bucketed
        engine, ``grads_fn(params, frozen, user, items) -> [len(items), 2]``
        the per-user loop.  The dump never needs scores, so both
        evaluators write it alike."""
        from fashionvisualexpl_tpu_torch.explain.grads import write_grads_tsv

        write_grads_tsv(path, self.data, params, frozen, grads_fn=grads_fn,
                        batch_grads_fn=batch_grads_fn, device=self.device)


def print_epoch_block(k, epoch, total_epochs, mean_loss, rec) -> None:
    """The reference's per-epoch metric block (Evaluator.py:194-215)."""
    m = rec.metrics or {}
    print(
        "Epoch %d/%d \tLoss: %.3f \tTrain Time: %s \tEvaluation Time: %s\n"
        "Metrics@%d (Validation)\n\t\tHR\tPrec\tRec\tAUC\tnDCG\n"
        "\t\t%f\t%f\t%f\t%f\t%f\n"
        "Metrics@%d (Test)\n\t\tHR\tPrec\tRec\tAUC\tnDCG\n"
        "\t\t%f\t%f\t%f\t%f\t%f\n"
        % (
            epoch, total_epochs, mean_loss,
            datetime.timedelta(seconds=rec.train_time_s),
            datetime.timedelta(seconds=rec.eval_time_s),
            k,
            m.get("hr_v", 0), m.get("p_v", 0), m.get("r_v", 0),
            m.get("auc_v", 0), m.get("ndcg_v", 0),
            k,
            m.get("hr_t", 0), m.get("p_t", 0), m.get("r_t", 0),
            m.get("auc_t", 0), m.get("ndcg_t", 0),
        )
    )
