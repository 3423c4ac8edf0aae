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

With a ``mesh`` (``core/mesh.py``; every rank of the model axis calls
``evaluate`` with the same whole params) the catalog pads to the model-axis
multiple with -inf bias and each model rank counts over its own item rows
(``sharded_streaming_counts``: K2 per shard on the kernel engine), the
counts summed over ``model``; the top-k dumps merge each shard's list by an
all-gather and one small top-k (``sharded_streaming_topk_and_counts``).
"""

from __future__ import annotations

from typing import Dict, Optional

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
    filter_items_topk,
    streaming_counts,
    streaming_counts_bucketed,
    streaming_topk_and_counts,
)

COUNTS_IMPLS = ("auto", "mask", "bucketed", "kernel")


def _shard_offset(mesh, item_factors):
    from fashionvisualexpl_tpu_torch.core.mesh import MODEL_AXIS

    return mesh.axis_index(MODEL_AXIS) * item_factors.shape[0]


def sharded_streaming_counts(
    mesh, uf, item_factors, item_bias, ref_scores, banned_ids, item_block,
    impl: str = "mask", bucket_width: Optional[int] = None,
):
    """Distributed counts-only pass on one rank: ``item_factors`` /
    ``item_bias`` are this model rank's rows of the padded catalog (pad
    rows with -inf bias), ``uf``, ``ref_scores`` and ``banned_ids``
    (global ids, -1 pads) the whole user block.  Each rank counts over its
    rows; the >=-position counts are summed over ``model``.

    ``impl``: "mask" (id-mask scan at the rank's global offset), or
    "bucketed" / "kernel" (K2), which re-bucket the banned ids in
    SHARD-LOCAL coordinates (``banned - shard * rows``: other shards' ids
    and the pads fall outside [0, rows) and drop), so K2 itself takes no
    offset.  ``bucket_width`` must then be a host-probed width valid for
    every shard (``FactoredEvaluator`` probes it once)."""
    from fashionvisualexpl_tpu_torch.core.mesh import MODEL_AXIS, psum

    rows = item_factors.shape[0]
    offset = _shard_offset(mesh, item_factors)
    if impl == "mask":
        counts = streaming_counts(uf, item_factors, item_bias, ref_scores=ref_scores,
                                  banned_ids=banned_ids, item_block=item_block,
                                  item_offset=offset)
    else:
        if bucket_width is None:
            raise ValueError(f"impl {impl!r} needs a host-probed bucket_width")
        loc, msk = bucket_banned_ids_device(banned_ids.to(torch.int64) - offset, rows,
                                            item_block, bucket_width)
        engine = streaming_counts_kernel if impl == "kernel" else streaming_counts_bucketed
        counts = engine(uf, item_factors, item_bias, ref_scores=ref_scores,
                        banned_local=loc, banned_valid=msk, item_block=item_block)
    return psum(counts, mesh, MODEL_AXIS)


def sharded_streaming_topk_and_counts(
    mesh, uf, item_factors, item_bias, k, ref_scores, banned_ids, item_block,
):
    """Distributed streaming pass on one rank (arguments as for
    ``sharded_streaming_counts``): the rank's top-k over its rows with its
    global offset, the [m, Bu, k] lists all-gathered over ``model`` and
    merged by one top-k over [Bu, m * k], the counts summed.  Returns
    (vals [Bu, k], ids [Bu, k], counts or None)."""
    from fashionvisualexpl_tpu_torch.core.mesh import MODEL_AXIS, all_gather, psum

    tv, ti, counts = streaming_topk_and_counts(
        uf, item_factors, item_bias, k, ref_scores=ref_scores, banned_ids=banned_ids,
        item_block=item_block, item_offset=_shard_offset(mesh, item_factors))
    Bu = tv.shape[0]
    all_tv = all_gather(tv, mesh, MODEL_AXIS).transpose(0, 1).reshape(Bu, -1)
    all_ti = all_gather(ti, mesh, MODEL_AXIS).transpose(0, 1).reshape(Bu, -1)
    merged_v, pos = torch.topk(all_tv, k, dim=1)
    merged_i = torch.take_along_dim(all_ti, pos, dim=1)
    if counts is not None:
        counts = psum(counts, mesh, MODEL_AXIS)
    return merged_v, merged_i, counts


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
        f32, over a ``mesh`` too (the module docstring; each shard
        re-buckets the banned ids in its own coordinates, with one probed
        bucket width for every shard)."""
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
        self.mesh = mesh
        if self.mesh is not None:
            from fashionvisualexpl_tpu_torch.core.mesh import MODEL_AXIS

            self._m = self.mesh.shape[MODEL_AXIS]
            self._mesh_rows = -(-data.num_items // self._m)  # rows per shard

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
        self._bucket_w = {}

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
            if self.mesh is None:
                self._bucket_w = {
                    split: banned_bucket_width(b, data.num_items, self._counts_tile)
                    for split, b in banned_np.items()
                }
            else:  # one width for every shard's shard-local ids
                rows = self._mesh_rows
                self._bucket_w = {
                    split: max(banned_bucket_width(b - s * rows, rows, self._counts_tile)
                               for s in range(self._m))
                    for split, b in banned_np.items()
                }

    @torch.no_grad()
    def _eval_block(self, split, uf, item_factors, item_bias, user_ids,
                    shard=None) -> PerUserMetrics:
        """Per-user metrics for one user block, streaming over items (over
        a mesh: this rank's ``shard`` = (item rows, bias) of the padded
        catalog; the whole tables score the eval items)."""
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
        if shard is not None:
            position_t = sharded_streaming_counts(
                self.mesh, uf, shard[0], shard[1], s_eval, banned,
                self.item_block if self.counts_impl == "mask" else self._counts_tile,
                impl=self.counts_impl, bucket_width=self._bucket_w.get(split))
        elif self.counts_impl in ("kernel", "bucketed"):
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

    def _eval_split(self, split, uf_all, item_factors, item_bias, shard=None) -> MeanMetrics:
        U = self.data.num_users
        per_user = []
        for start in range(0, U, self.user_block):
            idx, in_range = block_ids(start, self.user_block, U)
            ids = torch.as_tensor(idx, device=self.device)
            m = self._eval_block(split, uf_all[ids], item_factors, item_bias, ids, shard)
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
        shard = self._shard(item_factors, item_bias) if self.mesh is not None else None
        t = self._eval_split("test", uf, item_factors, item_bias, shard)
        v = (self._eval_split("val", uf, item_factors, item_bias, shard)
             if self._val_items is not None else None)
        return split_record(t, v)

    def _shard(self, item_factors, item_bias):
        """This model rank's (rows, bias) of the catalog padded to the
        axis multiple, the pad rows with -inf bias: they score -inf, so
        they never satisfy a >= count nor enter a top-k."""
        from fashionvisualexpl_tpu_torch.core.mesh import MODEL_AXIS

        rows, I = self._mesh_rows, self.data.num_items
        pad = rows * self._m - I
        ib = (item_bias if item_bias is not None
              else torch.zeros(I, dtype=item_factors.dtype, device=item_factors.device))
        iv = torch.nn.functional.pad(item_factors, (0, 0, 0, pad))
        ib = torch.nn.functional.pad(ib, (0, pad), value=float("-inf"))
        lo = self.mesh.axis_index(MODEL_AXIS) * rows
        return iv[lo:lo + rows].contiguous(), ib[lo:lo + rows].contiguous()

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
        if self.mesh is not None and not self.mesh.is_primary:
            return  # every rank computes (collectives); the primary writes
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
        into the model; over a mesh by the distributed streaming pass
        (``sharded_streaming_topk_and_counts``, train items filtered)."""
        if self.mesh is not None:
            return self._sharded_topk_rows(params)
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

    @torch.no_grad()
    def _sharded_topk_rows(self, params):
        uf_all, item_factors, item_bias = self._factors(params)
        iv, ib = self._shard(item_factors, item_bias)
        U = self.data.num_users
        k_big = self.k + self._train_items.shape[1]
        all_ids, all_vals = [], []
        for start in range(0, U, self.user_block):
            idx, _ = block_ids(start, self.user_block, U)
            ids = torch.as_tensor(idx, device=self.device)
            tv, ti, _ = sharded_streaming_topk_and_counts(
                self.mesh, uf_all[ids], iv, ib, k_big, None, None, self.item_block)
            vals, top = filter_items_topk(tv, ti, self._train_items[ids],
                                          self._train_counts[ids], self.k)
            n = min(self.user_block, U - start)
            all_ids.append(top[:n].cpu().numpy())
            all_vals.append(vals[:n].cpu().numpy())
        return (np.arange(U, dtype=np.int32), np.concatenate(all_ids),
                np.concatenate(all_vals))

    def store_recommendation_attention(self, params, frozen, path: str,
                                       attention_fn) -> None:
        """Attention-augmented top-k TSV (Evaluator.py:241-259):
        `user\titem\tscore\talpha_color\talpha_edges\talpha_class`,
        without the [U, I] score matrix: the top-k comes from the serving
        engine (``_topk_rows``: ``RecServer``, K3), then the attention
        weights per user block from ``attention_fn(params, frozen,
        user_ids, ctx) -> [B, I, 3]``, the dense ``Evaluator``'s contract,
        with ``ctx`` the model's ``precompute_eval`` (computed once).
        Memory is [user_block, I, 3] a block.  Over a mesh every rank
        computes and the primary writes."""
        users, ids, vals = self._topk_rows(params, frozen)
        ctx = self.model.precompute_eval(params)
        if self.mesh is not None and not self.mesh.is_primary:
            return
        with open(path, "w") as out:
            for start in range(0, len(users), self.user_block):
                rows = slice(start, start + self.user_block)
                user_ids = torch.as_tensor(users[rows], device=self.device).long()
                top = torch.as_tensor(ids[rows], device=self.device).long()
                att = torch.take_along_dim(attention_fn(params, frozen, user_ids, ctx),
                                           top[:, :, None], dim=1).cpu().numpy()
                out.writelines(
                    f"{u}\t{i}\t{s}\t{a[0]}\t{a[1]}\t{a[2]}\n"
                    for u, row_ids, row_vals, row_att in zip(users[rows], ids[rows],
                                                             vals[rows], att)
                    for i, s, a in zip(row_ids, row_vals, row_att))

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
