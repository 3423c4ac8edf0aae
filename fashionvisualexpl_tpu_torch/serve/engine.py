"""Low-latency recommendation serving (port of
``fashionvisualexpl_tpu/serve/engine.py``).

- **refresh(params=None, frozen=None)** builds the device-resident index once
  per model publish from the factored user/item matrices
  (``model.factored_eval(params)``): a given parameter mapping, or the
  model's own parameters when ``params`` is None.
- **query(user_ids)** answers a batch in three stages:
  1. *segment-max candidate generation*: catalog scores max-pooled over
     ``seg``-item segments, then an exact top-k over the seg-times smaller
     [B, S] segment matrix; all items of each winning segment become
     candidates (ranking segments by max provably recovers the true top-m
     items within the top-m segments).  The default bf16 stage 1 is the
     fused CUDA kernel of ``ops/segmax.py`` on the card; the fp32 and int8
     (``quantized``) stage 1 are plain torch block scans, as the JAX package
     leaves them to XLA.
  2. *exact fp32 rescore* of the candidates, gathered segment-wise from a
     segment-major copy of the item matrix.
  3. the per-user history filter (by id: no [U, I] mask is built) and the
     final top-k.

Models without ``factored_eval`` (AttentiveFashion) take the direct path:
``refresh`` keeps a copy of the params and the model's ``precompute_eval``
context, and ``query`` scores the whole catalog with ``predict_user_block``,
bans the history ids by a scatter to -inf (pad slots dropped) and takes
the top-k (JAX ``_direct_query``).

Batches pad to power-of-two buckets from 8, as in the JAX package, so both
serve the same shapes.  ``approx_max_k(recall_target=1.0)`` there is exact,
and is ``torch.topk`` here.

Not ported yet: the ``mesh`` (sharded) path and the TPU-only
``segmax_kernel`` / ``segmax_transposed`` knobs (Mosaic layout matters).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.data.interactions import Interactions, pad_lists
from fashionvisualexpl_tpu_torch.ops.segmax import segmax_scores
from fashionvisualexpl_tpu_torch.ops.topk import OUT_OF_RANGE_ID

# fp32 products must stay fp32 on the card (the rescore is the served
# ranking): no TF32 in cuBLAS.  This is PyTorch's default; stated here.
torch.backends.cuda.matmul.allow_tf32 = False

_NEG_INF = float("-inf")


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: returns (q [N, D] int8,
    scale [N] fp32) with x ~= q * scale[:, None]."""
    scale = x.abs().amax(dim=1).clamp_min(1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _int8_scores(qu: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Exact int32 qu @ qi.T through ``torch._int_mm``.  Its shape rules
    (more than 16 rows; inner and outer sizes multiples of 8) are met by
    zero padding, which adds exact zeros: qi arrives padded to multiples of
    8 from refresh(); the user side pads here."""
    B, D = qu.shape
    rows, Dp = max(24, _pad_to(B, 8)), qi.shape[1]
    if rows != B or Dp != D:
        qu = F.pad(qu, (0, Dp - D, 0, rows - B))
    return torch._int_mm(qu, qi.T)[:B]


class RecServer:
    """Index-and-query recommendation server.

    Parameters
    ----------
    model : a model with ``factored_eval()`` (e.g. ``BPRMF``), served by
        the three stages above, or with ``predict_user_block`` and
        ``precompute_eval`` (e.g. ``AttentiveFashion``), served directly;
        the stage options below apply to the first kind only.
    data : Interactions — supplies each user's train history for exclusion
        (train items are never served); with ``history`` given, only its
        ``num_users`` and ``num_items`` are read.
    k : recommendations per query.
    item_block : item-axis block for the fp32 / int8 block scans (the bf16
        kernel walks the whole catalog in one launch).
    quantized : int8 candidate generation.
    oversample : candidates come from the top ``oversample * (k + P)``
        segments (clamped to the catalog), P the history width.
    seg : segment width of the max-pool (catalog items per segment).
    superseg : >1 selects segments hierarchically when S >= 4096.
    max_batch : larger queries are answered in chunks of this size.
    rescore_chunk : users per stage-2 gather (bounds its buffer).
    history : optional (padded_train_items [U, P], train_counts [U]) arrays,
        overriding the pad of ``data.training_list``.
    stage1_dtype : "bf16" (the kernel; displacement absorbed by the
        oversample margin and the fp32 rescore) or "fp32" (exact candidates).
    device : where the index lives and queries run; ``None`` is the CUDA
        card (raises without one).
    """

    def __init__(
        self,
        model,
        data: Interactions,
        k: int = 20,
        item_block: int = 65536,
        quantized: bool = False,
        oversample: int = 2,
        seg: int = 32,
        superseg: int = 1,
        max_batch: int = 4096,
        rescore_chunk: int = 128,
        history: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        stage1_dtype: str = "bf16",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if stage1_dtype not in ("bf16", "fp32"):
            raise ValueError(f"stage1_dtype must be bf16|fp32, got {stage1_dtype}")
        self._factored = hasattr(model, "factored_eval")
        if not (self._factored or hasattr(model, "predict_user_block")):
            raise NotImplementedError(
                "RecServer serves factored models (factored_eval) or models "
                "with predict_user_block"
            )
        self._stage1_dtype = (
            torch.bfloat16 if stage1_dtype == "bf16" else torch.float32
        )
        self._superseg = superseg
        self.model = model
        self.data = data
        self.k = k
        self.quantized = quantized
        self.oversample = oversample
        self.seg = min(seg, data.num_items)
        self.max_batch = max_batch
        # block must hold whole segments
        self.item_block = max(self.seg, (item_block // self.seg) * self.seg)

        if history is not None:
            train_padded, train_counts = history
        else:
            train_padded, train_counts = pad_lists(data.training_list, pad_value=0)
        self._train_items = torch.as_tensor(
            np.asarray(train_padded, np.int32), device=self.device
        )  # [U, P]
        self._train_counts = torch.as_tensor(
            np.asarray(train_counts, np.int32), device=self.device
        )  # [U]
        self._P = int(train_padded.shape[1])
        if k > data.num_items:
            raise ValueError(f"k={k} exceeds catalog size {data.num_items}")
        # static block geometry: the catalog pads (at refresh) to a whole
        # number of blocks, each a whole number of segments
        I = data.num_items
        self._blk = min(self.item_block, _pad_to(I, self.seg))
        self._padded_items = _pad_to(I, self._blk)
        segments = self._padded_items // self.seg
        self._k_seg = min(
            segments, max(self.oversample * (k + self._P), -(-k // self.seg))
        )
        # rescore chunking splits power-of-two batch buckets evenly
        self.rescore_chunk = 1 << (max(1, rescore_chunk) - 1).bit_length()
        self._index = None  # set by refresh()

    # --- index build -----------------------------------------------------

    @torch.no_grad()
    def refresh(self, params=None, frozen=None) -> None:
        """(Re)build the serving index once per model publish, off the query
        path, from ``params`` (name -> tensor, e.g. ``fit``'s
        ``best_params``; JAX's ``refresh(params, frozen)``) or, when None,
        the model's current weights.  ``frozen`` is unused (models hold
        their own).  The index is a copy: later training steps do not
        change what is served until the next refresh.  A model without
        ``factored_eval`` keeps the params and its ``precompute_eval``
        context."""
        del frozen
        U, I = self.data.num_users, self.data.num_items
        dev = self.device
        if not self._factored:
            params = {k: v.detach().clone() for k, v in
                      self.model.params_or_own(params).items()}
            self._index = {"banned": self._train_items,
                           "banned_counts": self._train_counts,
                           "params": params,
                           "ctx": self.model.precompute_eval(params)}
            return
        uf, iv, ib = self.model.factored_eval(params)
        uf = uf[:U].detach().to(dev, torch.float32).clone()
        iv = iv[:I].detach().to(dev, torch.float32)
        ib = None if ib is None else ib[:I].detach().to(dev, torch.float32)
        seg, D = self.seg, iv.shape[1]
        Ip = self._padded_items
        S = Ip // seg
        iv_pad = F.pad(iv, (0, 0, 0, Ip - I))
        index = {
            "banned": self._train_items,
            "banned_counts": self._train_counts,
            "uf": uf,
            # stage-2 rescore copy, segment-major: all `seg` rows of one
            # candidate segment in one contiguous gather row
            "iv_seg": iv_pad.reshape(S, seg * D),
        }
        if not self.quantized:
            index["iv_cand"] = iv_pad.to(self._stage1_dtype)
        ib_pad = None if ib is None else F.pad(ib, (0, Ip - I))
        index["ib_pad"] = ib_pad
        index["ib_seg"] = None if ib_pad is None else ib_pad.reshape(S, seg)
        # bias + validity folded into one vector: pad items carry a large
        # negative so the fused segmax kernel stays branch-free
        valid = torch.arange(Ip, device=dev) < I
        index["ib_cand"] = torch.where(
            valid,
            ib_pad if ib_pad is not None else torch.zeros(Ip, device=dev),
            -1e30,
        )
        if self.quantized:
            q_items, s_items = quantize_rows(iv)
            # rows pad to the block geometry and, for torch._int_mm, each
            # block's rows and D to multiples of 8 (exact zeros)
            n_blocks, blk = Ip // self._blk, self._blk
            q = F.pad(q_items, (0, _pad_to(D, 8) - D, 0, Ip - I))
            q = q.reshape(n_blocks, blk, -1)
            index["q_items"] = F.pad(q, (0, 0, 0, _pad_to(blk, 8) - blk))
            index["s_items"] = F.pad(s_items, (0, Ip - I))
        self._index = index

    # --- query stages ----------------------------------------------------

    def _candidates(self, index, uf):
        """Stage 1: candidate ids [B, k_seg*seg] and segment ids [B, k_seg]
        via segment-max streaming."""
        I = self.data.num_items
        seg, blk, Ip = self.seg, self._blk, self._padded_items
        n_blocks = Ip // blk
        if not self.quantized and self._stage1_dtype == torch.bfloat16:
            segmax = segmax_scores(
                uf.to(torch.bfloat16), index["iv_cand"], index["ib_cand"], seg
            )
            return self._ids_from_segments(segmax, seg, I)

        B = uf.shape[0]
        ib_pad = index["ib_pad"]
        valid = torch.arange(Ip, device=uf.device) < I
        if self.quantized:
            qu, su = quantize_rows(uf)
        parts = []
        for b in range(n_blocks):
            lo, hi = b * blk, (b + 1) * blk
            if self.quantized:
                acc = _int8_scores(qu, index["q_items"][b])[:, :blk]
                s = acc.float() * su[:, None] * index["s_items"][None, lo:hi]
            else:
                s = uf @ index["iv_cand"][lo:hi].T
            if ib_pad is not None:
                s = s + ib_pad[None, lo:hi]
            s = torch.where(valid[None, lo:hi], s, _NEG_INF)
            parts.append(s.view(B, blk // seg, seg).amax(dim=2))
        return self._ids_from_segments(torch.cat(parts, dim=1), seg, I)

    def _ids_from_segments(self, segmax, seg, I):
        B = segmax.shape[0]
        seg_ids = self._select_segments(segmax)  # [B, k_seg]
        cand = (
            seg_ids[:, :, None] * seg
            + torch.arange(seg, device=segmax.device)[None, None, :]
        ).reshape(B, -1)  # [B, k_seg*seg]
        return torch.where(cand < I, cand, OUT_OF_RANGE_ID), seg_ids

    def _select_segments(self, segmax):
        """Top-k_seg segment ids from a [B, S] segment-max matrix.

        For large S (>= 4096) and ``superseg`` > 1, select hierarchically:
        max-pool segments into super-segments, take the top super-segments,
        then select within the winners' pools.  The super-segment holding
        the i-th best segment ranks <= i by super-max, so the top-k_seg
        super-segments contain the top-k_seg segments."""
        B, S = segmax.shape
        k_seg = self._k_seg
        R2 = self._superseg
        if S < 4096 or R2 <= 1:  # flat selection
            return torch.topk(segmax, k_seg, dim=1).indices
        S2 = -(-S // R2)
        sm = F.pad(segmax, (0, S2 * R2 - S), value=_NEG_INF)
        super_max = sm.view(B, S2, R2).amax(dim=2)  # [B, S2]
        sup_ids = torch.topk(super_max, min(k_seg, S2), dim=1).indices
        pool = (
            sup_ids[:, :, None] * R2
            + torch.arange(R2, device=segmax.device)[None, None, :]
        ).reshape(B, -1)  # candidate segment ids; pad ones carry -inf
        pool_vals = torch.take_along_dim(sm, pool, dim=1)
        pos = torch.topk(pool_vals, k_seg, dim=1).indices
        # clamp so a pad id can never index out of the segment tables
        return torch.take_along_dim(pool, pos, dim=1).clamp_max(S - 1)

    def _rescore(self, index, uf, ti, seg_ids):
        """Stage 2: fp32 scores of the candidate set, item vectors gathered
        segment-wise from the segment-major copy, in chunks of
        ``rescore_chunk`` users to bound the [chunk, k_seg*seg, D] buffer."""
        D = uf.shape[1]
        ib_seg = index["ib_seg"]
        out = []
        for lo in range(0, uf.shape[0], self.rescore_chunk):
            hi = lo + self.rescore_chunk
            uf_c, ti_c, seg_c = uf[lo:hi], ti[lo:hi], seg_ids[lo:hi]
            b = uf_c.shape[0]
            cand = index["iv_seg"][seg_c].view(b, -1, D)  # [b, k_seg*seg, D]
            s = torch.bmm(cand, uf_c[:, :, None]).squeeze(2)
            if ib_seg is not None:
                s = s + ib_seg[seg_c].view(b, -1)
            out.append(torch.where(ti_c == OUT_OF_RANGE_ID, _NEG_INF, s))
        return torch.cat(out)

    def _filtered_topk(self, s, ti, banned, counts):
        """Stage 3: drop each user's train items by id, exact final top-k."""
        valid_b = (
            torch.arange(banned.shape[1], device=banned.device)[None, :]
            < counts[:, None]
        )
        is_banned = (
            (ti[:, :, None] == banned[:, None, :]) & valid_b[:, None, :]
        ).any(dim=2)
        s = s.masked_fill(is_banned, _NEG_INF)
        kk = min(self.k, s.shape[1])
        vals, pos = torch.topk(s, kk, dim=1)
        ids = torch.take_along_dim(ti, pos, dim=1)
        if kk < self.k:
            vals = F.pad(vals, (0, self.k - kk), value=_NEG_INF)
            ids = F.pad(ids, (0, self.k - kk), value=OUT_OF_RANGE_ID)
        return vals, ids

    def _direct_query(self, index, dev_ids):
        """Scores of the whole catalog by ``predict_user_block``; history
        ids set to -inf by a scatter whose pad slots go to an extra column
        I that is dropped; the exact top-k."""
        I = self.data.num_items
        scores = self.model.predict_user_block(
            dev_ids, index["ctx"], params=index["params"])[:, :I]
        banned = index["banned"][dev_ids]
        counts = index["banned_counts"][dev_ids]
        P = banned.shape[1]
        valid = torch.arange(P, device=banned.device)[None, :] < counts[:, None]
        drop = torch.where(valid, banned, I).long()
        scores = F.pad(scores, (0, 1)).scatter_(1, drop, _NEG_INF)[:, :I]
        return torch.topk(scores, self.k, dim=1)

    @torch.inference_mode()
    def _run_query(self, dev_ids):
        """(vals, ids) device tensors for one padded id bucket."""
        index = self._index
        if not self._factored:
            return self._direct_query(index, dev_ids)
        uf = index["uf"][dev_ids]
        ti, seg_ids = self._candidates(index, uf)
        s = self._rescore(index, uf, ti, seg_ids)
        return self._filtered_topk(
            s, ti, index["banned"][dev_ids], index["banned_counts"][dev_ids]
        )

    # --- public query surface --------------------------------------------

    def query(self, user_ids) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (ids int32, scores float32) for a batch of user ids.
        Batches pad to power-of-two buckets from 8; oversize batches chunk
        at ``max_batch``."""
        if self._index is None:
            raise RuntimeError("RecServer.refresh() not called")
        # validate range BEFORE the int32 cast: a wide-dtype input (e.g.
        # int64 holding 2**32) would otherwise wrap to a small in-range
        # value and silently serve the wrong user
        user_ids = np.asarray(user_ids).reshape(-1)
        if user_ids.size and (
            user_ids.min() < 0 or user_ids.max() >= self.data.num_users
        ):
            bad = user_ids[(user_ids < 0) | (user_ids >= self.data.num_users)][0]
            raise ValueError(
                f"user id {bad} out of range [0, {self.data.num_users})"
            )
        user_ids = user_ids.astype(np.int32)
        if user_ids.size == 0:
            return (
                np.zeros((0, self.k), np.int32),
                np.zeros((0, self.k), np.float32),
            )
        if user_ids.size > self.max_batch:
            parts = [
                self.query(user_ids[s : s + self.max_batch])
                for s in range(0, user_ids.size, self.max_batch)
            ]
            return (
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
            )
        n = user_ids.size
        bucket = max(8, 1 << (n - 1).bit_length())
        padded = np.zeros(bucket, np.int64)
        padded[:n] = user_ids
        vals, ids = self._run_query(torch.from_numpy(padded).to(self.device))
        ids = ids.to(torch.int32).cpu().numpy()
        vals = vals.cpu().numpy()
        return ids[:n], vals[:n]

    def query_user(self, user_id: int) -> List[Tuple[int, float]]:
        ids, vals = self.query([user_id])
        return [(int(i), float(v)) for i, v in zip(ids[0], vals[0])]
