"""Gradient-x-input explanation utilities (port of
``fashionvisualexpl_tpu/explain/grads.py``).

Attributions for all of a user's positive items in bucketed fixed-shape
blocks (reference src/recommender/models/GradFashion.py:269-302 +
src/recommender/Evaluator.py:261-275), plus the review-join analysis of
src/get_explanations.py.

No pandas: a table is ``utils/frames.py``'s, a mapping column name ->
numpy column, in column order.  ``join_reviews`` reproduces pandas' inner
merge on (USER_ID, ITEM_ID) (left rows in order, each with its right
matches in order; clashing non-key columns suffixed ``_x`` / ``_y``) and
``sort_values``'s order, ties included (``frames.nargsort``: numpy's
unstable quicksort over the reversed column for a descending sort).
``read_tsv`` / ``write_tsv`` stand in for ``read_csv`` / ``to_csv``
(tab-separated, a header row; ``frames.read_csv`` / ``frames.write_csv``
for the types, the missing values and the quoting).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.utils import frames as fr

Table = Dict[str, np.ndarray]
COLUMNS = ("USER_ID", "ITEM_ID", "COLOR", "EDGES")
KEYS = ("USER_ID", "ITEM_ID")


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length() if n > 1 else 1


def _positives(data, u: int) -> List[int]:
    return data.training_list[u] + data.validation_list[u] + data.test_list[u]


def batched_attributions(
    batch_fn: Callable,
    params,
    frozen,
    data,
    user_block: int = 512,
    device: DeviceLike = None,
) -> Dict[int, np.ndarray]:
    """Grad-x-input attributions for every (user, positive item) pair in
    bucketed fixed-shape blocks: each user's positive list is padded to the
    next power-of-two width, users are grouped by that width, and
    ``batch_fn(params, frozen, users [B], items [B, W]) -> [B, W, 2]`` runs
    on power-of-two user blocks (int32 ids on ``device``; ``None`` = the
    CUDA card).  Pad slots repeat the row's first item and the tail of a
    block repeats its last user; their results are dropped.  Every block is
    launched before any is read back.

    Returns {user: [n_pos, 2] float32} for users with at least one
    positive."""
    dev = resolve_device(device)
    per_user: Dict[int, Sequence[int]] = {}
    buckets: Dict[int, list] = {}
    for u in range(data.num_users):
        pos = _positives(data, u)
        if not pos:
            continue
        per_user[u] = pos
        buckets.setdefault(_pow2(len(pos)), []).append(u)
    if not per_user:
        return {}

    # one vectorized ragged -> padded pass (pad slots repeat the first item)
    uids = np.fromiter(per_user.keys(), np.int64, len(per_user))
    lens = np.fromiter((len(v) for v in per_user.values()), np.int64, len(per_user))
    total = int(lens.sum())
    flat = np.fromiter(itertools.chain.from_iterable(per_user.values()), np.int32, total)
    offs = np.cumsum(lens) - lens
    rr = np.repeat(np.arange(len(uids)), lens)
    cc = np.arange(total) - np.repeat(offs, lens)
    dense_ids = np.zeros((len(uids), int(lens.max())), np.int32)
    dense_ids[rr, cc] = flat
    valid = np.arange(dense_ids.shape[1])[None, :] < lens[:, None]
    dense_ids = np.where(valid, dense_ids, dense_ids[:, :1])
    row_of = {int(u): i for i, u in enumerate(uids)}

    pending = []
    with torch.no_grad():
        for width, users in sorted(buckets.items()):
            urows = np.fromiter((row_of[u] for u in users), np.int64, len(users))
            for s in range(0, len(users), user_block):
                chunk = users[s:s + user_block]
                B = _pow2(min(len(chunk), user_block))
                idx = np.minimum(np.arange(B), len(chunk) - 1)
                u_arr = torch.as_tensor(np.asarray(chunk, np.int32)[idx], device=dev)
                i_arr = torch.as_tensor(dense_ids[urows[s:s + user_block][idx], :width],
                                        device=dev)
                pending.append((chunk, batch_fn(params, frozen, u_arr, i_arr)))
    out: Dict[int, np.ndarray] = {}
    for chunk, g_dev in pending:
        g = g_dev.cpu().numpy()
        for r, u in enumerate(chunk):
            out[u] = g[r, :len(per_user[u])].astype(np.float32)
    return out


def _per_user(grads_fn: Callable, params, frozen, data, device) -> Dict[int, np.ndarray]:
    """The per-user loop: ``grads_fn(params, frozen, user, items) ->
    [len(items), 2]``, items int32 on ``device``."""
    dev = resolve_device(device)
    out = {}
    for u in range(data.num_users):
        pos = _positives(data, u)
        if pos:
            with torch.no_grad():
                g = grads_fn(params, frozen, u, torch.tensor(pos, dtype=torch.int32,
                                                             device=dev))
            out[u] = g.cpu().numpy()
    return out


def write_grads_tsv(
    path: str,
    data,
    params,
    frozen,
    grads_fn: Optional[Callable] = None,
    batch_grads_fn: Optional[Callable] = None,
    user_block: int = 512,
    device: DeviceLike = None,
) -> None:
    """Gradient-attribution TSV (reference Evaluator.py:261-275 format):
    ``user\\titem\\tcolor_attr\\tedges_attr`` for every positive (train +
    validation + test) item of each user, in user order.  With
    ``batch_grads_fn`` the bucketed engine runs (``batched_attributions``);
    otherwise the per-user ``grads_fn(params, frozen, user, items) ->
    [len(items), 2]``."""
    if batch_grads_fn is not None:
        att = batched_attributions(batch_grads_fn, params, frozen, data,
                                   user_block=user_block, device=device)
    elif grads_fn is not None:
        att = _per_user(grads_fn, params, frozen, data, device)
    else:
        raise ValueError("one of grads_fn / batch_grads_fn is required")
    with open(path, "w") as out:
        for u in sorted(att):
            g = att[u]
            for i, item in enumerate(_positives(data, u)):
                out.write(f"{u}\t{item}\t{g[i, 0]}\t{g[i, 1]}\n")


def explanation_table(model, params, frozen, data, batched: bool = True) -> Table:
    """{USER_ID, ITEM_ID, COLOR, EDGES} columns (int64, int64, float64,
    float64, as the JAX package's DataFrame holds them) of the grad-x-input
    attributions of every (user, positive item) pair: the content of
    ``store_recommendation_grads``.  ``batched`` uses the bucketed engine
    over ``model.feature_attributions_block``; ``False`` the per-user
    ``model.feature_attributions``."""
    if batched:
        att = batched_attributions(
            lambda p, f, u, i: model.feature_attributions_block(u, i, params=p),
            params, frozen, data, device=model.device)
    else:
        att = _per_user(lambda p, f, u, i: model.feature_attributions(u, i, params=p),
                        params, frozen, data, model.device)
    users, items, grads = [], [], []
    for u in sorted(att):
        pos = _positives(data, u)
        users += [u] * len(pos)
        items += pos
        grads.append(att[u].astype(np.float64))
    g = np.concatenate(grads) if grads else np.zeros((0, 2))
    return {"USER_ID": np.asarray(users, np.int64), "ITEM_ID": np.asarray(items, np.int64),
            "COLOR": g[:, 0].copy(), "EDGES": g[:, 1].copy()}


def join_reviews(grads: Mapping[str, np.ndarray], reviews: Mapping[str, np.ndarray],
                 top_n: int = 50) -> Tuple[Table, Table]:
    """The get_explanations.py analysis (get_explanations.py:17-37): join the
    attributions with the review table on (USER_ID, ITEM_ID), drop USER,
    ASIN, TIME and CATEGORY where present, add DIFF = COLOR - EDGES, and
    return the top-N color-driven (DIFF descending) and edge-driven (DIFF
    ascending) rows."""
    merged = fr.merge_inner(grads, reviews, on=KEYS)
    for col in ("USER", "ASIN", "TIME", "CATEGORY"):
        merged.pop(col, None)
    merged["DIFF"] = merged["COLOR"] - merged["EDGES"]
    color_driven = fr.take(merged, fr.nargsort(merged["DIFF"], False)[:top_n])
    edge_driven = fr.take(merged, fr.nargsort(merged["DIFF"], True)[:top_n])
    return color_driven, edge_driven


def read_tsv(path: str, names: Optional[Sequence[str]] = None) -> Table:
    """A tab-separated file as columns: the first row is the header unless
    ``names`` are given."""
    if names is None:
        return fr.read_csv(path, sep="\t")
    return dict(zip(names, fr.read_csv(path, sep="\t", header=False).values()))


def write_tsv(table: Mapping[str, np.ndarray], path: str) -> None:
    """``to_csv(path, sep="\\t", index=False)`` of a table."""
    fr.write_csv(table, path, sep="\t")
