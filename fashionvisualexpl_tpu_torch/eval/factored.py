"""Streaming evaluator for factored models, score = u_vec . i_vec + i_bias
(port of ``fashionvisualexpl_tpu/eval/factored.py``, single device).

Computes exactly the metrics of eval/evaluator.py (reference semantics,
Evaluator.py:82-128) WITHOUT the dense [U, I] score matrix or masks: per
user block, a blocked pass over the catalog counts, for each eval item, the
candidate negatives scoring >= it (excluded by id: train and eval items),
and the hits follow from those counts.  Peak memory is [user_block x
item_block] — the path to the scaled configuration (1M users x 500k items)
where the dense matrix is ~2 TB.

Models opt in by implementing ``factored_eval(params) -> (user_factors
[U, D], item_factors [I, D], item_bias [I] | None)``.

Not ported yet: the ``mesh`` (sharded) path with ``sharded_streaming_counts``
and ``sharded_streaming_topk_and_counts`` (ROADMAP: Multi-device).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.device import resolve_device
from fashionvisualexpl_tpu_torch.data.interactions import Interactions, pad_lists
from fashionvisualexpl_tpu_torch.eval.evaluator import (
    block_ids,
    concat_metrics,
    print_epoch_block,
    split_record,
)
from fashionvisualexpl_tpu_torch.ops.counts import streaming_counts_kernel
from fashionvisualexpl_tpu_torch.ops.metrics import (
    MeanMetrics,
    PerUserMetrics,
    mean_metrics,
    metrics_from_positions,
)
from fashionvisualexpl_tpu_torch.ops.topk import (
    banned_bucket_width,
    bucket_banned_ids_device,
    streaming_counts,
    streaming_counts_bucketed,
)

COUNTS_IMPLS = ("auto", "mask", "bucketed", "kernel")


def _masked(items, counts):
    """Padded ids with the pad slots set to -1 (never a real id)."""
    v = np.arange(items.shape[1])[None, :] < counts[:, None]
    return np.where(v, items, -1).astype(np.int32)


class FactoredEvaluator:
    def __init__(
        self,
        model,
        data: Interactions,
        k: int = 20,
        user_block: int = 1024,
        item_block: int = 4096,
        mesh=None,
        counts_impl: str = "auto",
    ):
        """counts_impl selects the >=-position-count engine:

        - "mask": the per-block id-mask scan (ops/topk.py streaming_counts);
        - "bucketed": the same scan with banned ids bucketed per item block
          (bucket_banned_ids_device);
        - "kernel": the fused scoring + count CUDA kernel K2
          (ops/counts.py); its plain version for CPU tensors;
        - "auto": "kernel" when the evaluator's device (the model's) is
          CUDA and the catalog has 16,384 items or more, else "bucketed".

        All produce identical counts on data whose scores are exact in
        f32.  ``mesh`` is not ported yet (ROADMAP: Multi-device)."""
        if mesh is not None:
            raise NotImplementedError(
                "the sharded streaming evaluator (mesh) is not ported yet "
                "(ROADMAP: Multi-device)"
            )
        if counts_impl not in COUNTS_IMPLS:
            raise ValueError(
                f"counts_impl {counts_impl!r} not in "
                "{'auto', 'mask', 'bucketed', 'kernel'}"
            )
        self.model = model
        self.data = data
        self.k = k
        self.user_block = min(user_block, data.num_users)
        self.item_block = item_block
        self.device = resolve_device(model.device)
        if counts_impl == "auto":
            counts_impl = (
                "kernel"
                if self.device.type == "cuda" and data.num_items >= 16384
                else "bucketed"
            )
        self.counts_impl = counts_impl
        # the kernel's item tile (the JAX package's measured best Pallas tile)
        self._counts_tile = 2048 if counts_impl == "kernel" else item_block

        dev = self.device
        train_padded, train_counts = pad_lists(data.training_list, pad_value=0)
        test_padded, test_counts = pad_lists(data.test_list, pad_value=0)
        self._train_items = torch.as_tensor(train_padded, device=dev)
        self._train_counts = torch.as_tensor(train_counts, device=dev)
        self._test_items = torch.as_tensor(test_padded, device=dev)
        self._test_counts = torch.as_tensor(test_counts, device=dev)
        if data.has_validation:
            val_padded, val_counts = pad_lists(data.validation_list, pad_value=0)
            self._val_items = torch.as_tensor(val_padded, device=dev)
            self._val_counts = torch.as_tensor(val_counts, device=dev)
        else:
            self._val_items = None
            self._val_counts = None

        if counts_impl != "mask":
            # the banned set (train + split eval items) is static, so the
            # bucket width W is probed once on the host and pinned; the
            # bucketing itself runs on the device per user block
            tr = _masked(train_padded, train_counts)
            banned_np = {"test": np.concatenate(
                [tr, _masked(test_padded, test_counts)], axis=1)}
            if data.has_validation:
                banned_np["val"] = np.concatenate(
                    [tr, _masked(val_padded, val_counts)], axis=1)
            self._bucket_w = {
                split: banned_bucket_width(b, data.num_items, self._counts_tile)
                for split, b in banned_np.items()
            }

    @torch.no_grad()
    def _eval_block(self, split, uf, item_factors, item_bias, user_ids) -> PerUserMetrics:
        """Per-user metrics for one user block, streaming over items."""
        I = item_factors.shape[0]
        train_items = self._train_items[user_ids]
        train_counts = self._train_counts[user_ids]
        if split == "val":
            ev_items, ev_counts = self._val_items[user_ids], self._val_counts[user_ids]
        else:
            ev_items, ev_counts = self._test_items[user_ids], self._test_counts[user_ids]

        def pointwise(items):
            v = item_factors[items.long()]  # [Bu, W, D]
            s = torch.einsum("bd,bwd->bw", uf, v)
            if item_bias is not None:
                s = s + item_bias[items.long()]
            return s

        s_eval = pointwise(ev_items)  # [Bu, T]
        T, P = ev_items.shape[1], train_items.shape[1]
        t_valid = torch.arange(T, device=uf.device)[None, :] < ev_counts[:, None]
        p_valid = torch.arange(P, device=uf.device)[None, :] < train_counts[:, None]
        # candidate negatives = all - train - eval, excluded BY ID inside the
        # streaming pass; pad slots become -1, never a real id
        banned = torch.cat(
            [torch.where(p_valid, train_items, -1),
             torch.where(t_valid, ev_items, -1)],
            dim=1,
        )  # [Bu, P+T]
        if self.counts_impl in ("kernel", "bucketed"):
            loc, msk = bucket_banned_ids_device(
                banned, I, self._counts_tile, self._bucket_w[split]
            )
            engine = (streaming_counts_kernel if self.counts_impl == "kernel"
                      else streaming_counts_bucketed)
            position_t = engine(
                uf, item_factors, item_bias, ref_scores=s_eval,
                banned_local=loc, banned_valid=msk, item_block=self._counts_tile,
            )
        else:
            position_t = streaming_counts(
                uf, item_factors, item_bias, ref_scores=s_eval,
                banned_ids=banned, item_block=self.item_block,
            )
        # catalog size, NOT the table height
        num_neg = self.data.num_items - train_counts - ev_counts
        return metrics_from_positions(position_t, s_eval, ev_counts, num_neg, self.k)

    def _eval_split(self, split, uf_all, item_factors, item_bias) -> MeanMetrics:
        U = self.data.num_users
        per_user = []
        for start in range(0, U, self.user_block):
            idx, in_range = block_ids(start, self.user_block, U)
            ids = torch.as_tensor(idx, device=self.device)
            m = self._eval_block(split, uf_all[ids], item_factors, item_bias, ids)
            m = m._replace(valid=m.valid & torch.as_tensor(in_range, device=self.device))
            per_user.append(m)
        return mean_metrics(concat_metrics(per_user))

    @torch.no_grad()
    def _factors(self, params):
        uf, item_factors, item_bias = self.model.factored_eval(params)
        # strip any model-side row padding so pad rows cannot enter counts
        uf = uf[: self.data.num_users].detach()
        item_factors = item_factors[: self.data.num_items].detach()
        if item_bias is not None:
            item_bias = item_bias[: self.data.num_items].detach()
        return uf, item_factors, item_bias

    def evaluate(self, params, frozen) -> Dict[str, float]:
        """Metrics for validation (if present) and test, with the
        reference's results-dict schema.  ``params`` maps names to tensors
        (``fit`` passes its state's params); ``None`` scores the model's
        own parameters."""
        del frozen
        uf, item_factors, item_bias = self._factors(params)
        t = self._eval_split("test", uf, item_factors, item_bias)
        v = (self._eval_split("val", uf, item_factors, item_bias)
             if self._val_items is not None else None)
        return split_record(t, v)

    def print_epoch(self, epoch, total_epochs, mean_loss, rec) -> None:
        print_epoch_block(self.k, epoch, total_epochs, mean_loss, rec)

    def store_recommendation(self, params, frozen, path: str,
                             exact: bool = False) -> None:
        """Plain top-k TSV (`user\\titem\\tscore`, train items excluded —
        the Evaluator.store_recommendation protocol, Evaluator.py:225-239)
        without the [U, I] matrix, through the serving engine's
        segment-max pipeline (``RecServer``, kernel K3).  ``exact=True``
        scores stage 1 in fp32 (the dumped ranking is then the true fp32
        top-k); the default bf16 stage 1 relies on the fp32 rescore and the
        ``oversample=4`` segment margin.  The rows go through the native
        parallel writer (``data/native.py::write_recs_tsv``, scores as
        %.9g) when the host library is available, else through Python."""
        from fashionvisualexpl_tpu_torch.data.native import write_recs_tsv

        users, ids, vals = self._topk_rows(params, frozen, exact=exact)
        if not write_recs_tsv(path, users, ids, vals):
            with open(path, "w") as out:
                out.writelines(
                    f"{u}\t{ids[r, j]}\t{vals[r, j]}\n"
                    for r, u in enumerate(users)
                    for j in range(self.k)
                )

    def _topk_rows(self, params, frozen, exact: bool = False):
        """Top-k (users [U], ids [U, k], vals [U, k]) numpy arrays for every
        user, served by ``RecServer`` from ``params`` without writing them
        into the model."""
        from fashionvisualexpl_tpu_torch.serve import RecServer

        srv = RecServer(
            self.model, self.data, k=self.k,
            # this evaluator's memory budget, and a wide displacement margin
            # for the bf16 candidate stage
            item_block=self.item_block, oversample=4,
            stage1_dtype="fp32" if exact else "bf16",
            history=(self._train_items.cpu().numpy(),
                     self._train_counts.cpu().numpy()),
            device=self.device,
        )
        srv.refresh(params, frozen)
        U = self.data.num_users
        all_users, all_ids, all_vals = [], [], []
        for start in range(0, U, self.user_block):
            users = np.arange(start, min(start + self.user_block, U), dtype=np.int32)
            ids, vals = srv.query(users)
            all_users.append(users)
            all_ids.append(ids)
            all_vals.append(vals)
        return (np.concatenate(all_users), np.concatenate(all_ids),
                np.concatenate(all_vals))

    def store_recommendation_attention(self, params, frozen, path: str,
                                       attention_fn) -> None:
        raise NotImplementedError(
            "the factored attention dump is not ported: AttentiveFashion, the "
            "one model with attention dumps, has no factored_eval and dumps "
            "through the dense Evaluator"
        )

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
