"""Interaction dataset loading (port of ``fashionvisualexpl_tpu/data/interactions.py``).

Drop-in compatible with the reference's file formats: per-split TSVs
`trainingset.tsv` / `validationset.tsv` / `testset.tsv` with rows
``user\titem\t[time\trating]``, and user/item counts taken from the
`stats_after_downloading` info file.

Host-side numpy only, so every array here is bit-equal to the JAX
package's (``tests/test_torch_interactions.py``):

- ``train_pairs``: all (user, item) training interactions as one [N, 2] array;
- ``padded_pos`` / ``pos_counts``: per-user sorted positive items padded to a
  common width with strictly-increasing out-of-range sentinels.

``read_split_tsv`` parses through the native host library
(``data/native.py``: mmap'd, multithreaded) when it is available, and
through the pure-Python loop otherwise; both give the same pairs.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fashionvisualexpl_tpu_torch.core.config import TrainConfig


def read_split_tsv(path: str, use_native: bool = True) -> List[Tuple[int, int]]:
    """Read (user, item) pairs from a reference-format split TSV, through
    the native parser when ``use_native`` and the library is available
    (the Python loop takes minutes at 10^7+ rows), else in Python."""
    if use_native:
        from fashionvisualexpl_tpu_torch.data.native import parse_interactions_tsv

        try:
            parsed = parse_interactions_tsv(path)
        except (OSError, RuntimeError):
            parsed = None  # the Python loop raises the error, if any
        if parsed is not None:
            users, items, _ = parsed
            return list(zip(users.tolist(), items.tolist()))
    pairs: List[Tuple[int, int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            pairs.append((int(parts[0]), int(parts[1])))
    return pairs


def read_counts_from_info(path: str) -> Tuple[int, int]:
    """Parse user/item counts from the stats file (line index 2 holds
    `...: num_users`, line index 3 `...: num_items`)."""
    with open(path) as f:
        lines = f.readlines()
    num_users = int(lines[2].split(": ")[1])
    num_items = int(lines[3].split(": ")[1])
    return num_users, num_items


def pairs_to_user_lists(
    pairs: Sequence[Tuple[int, int]], num_users: int
) -> List[List[int]]:
    """Group item ids by user, insertion order preserved."""
    lists: List[List[int]] = [[] for _ in range(num_users)]
    for u, i in pairs:
        lists[u].append(i)
    return lists


def pad_sorted_positives(
    user_lists: Sequence[Sequence[int]], num_items: int, width: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """(padded [U, P] int32, counts [U] int32): row u holds u's unique
    positives sorted ascending, then ``num_items + slot`` pads so the whole
    row is strictly increasing (the negative sampler's binary search needs
    it)."""
    uniq = [sorted(set(row)) for row in user_lists]
    counts = np.array([len(r) for r in uniq], dtype=np.int32)
    if width is None:
        width = max(1, int(counts.max()) if len(counts) else 1)
    if counts.max(initial=0) > width:
        raise ValueError(f"width {width} < max positives {counts.max()}")
    padded = np.zeros((len(uniq), width), dtype=np.int32)
    pad_base = np.arange(width, dtype=np.int32) + num_items
    for u, row in enumerate(uniq):
        c = len(row)
        padded[u, :c] = row
        padded[u, c:] = pad_base[: width - c] + c
    return padded, counts


def multi_hot(user_lists: Sequence[Sequence[int]], num_items: int) -> np.ndarray:
    """Dense [U, I] bool membership matrix (train-mask / test-mask for eval)."""
    m = np.zeros((len(user_lists), num_items), dtype=bool)
    for u, row in enumerate(user_lists):
        if row:
            m[u, list(row)] = True
    return m


def pad_lists(
    user_lists: Sequence[Sequence[int]], pad_value: int, width: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ragged per-user lists to [U, W] with `pad_value`; also return counts."""
    counts = np.array([len(r) for r in user_lists], dtype=np.int32)
    if width is None:
        width = max(1, int(counts.max()) if len(counts) else 1)
    out = np.full((len(user_lists), width), pad_value, dtype=np.int32)
    for u, row in enumerate(user_lists):
        out[u, : len(row)] = row[:width] if len(row) > width else row
    return out, counts


@dataclass
class Interactions:
    """Loaded interaction dataset with its derived fixed-shape structures."""

    num_users: int
    num_items: int
    training_list: List[List[int]]
    validation_list: List[List[int]]  # empty lists when no validation split
    test_list: List[List[int]]

    # derived, computed in __post_init__
    train_pairs: np.ndarray = field(init=False)  # [N, 2] int32
    padded_pos: np.ndarray = field(init=False)  # [U, P] int32, strictly increasing
    pos_counts: np.ndarray = field(init=False)  # [U] int32

    def __post_init__(self):
        # a duplicate (user, item) training row would misalign the sampler's
        # per-user runs with the user-major train_pairs layout; the
        # reference trains straight through such rows, so dedupe each row
        # here (first-seen order kept) with a warning instead of refusing
        n_raw = sum(len(row) for row in self.training_list)
        deduped = [list(dict.fromkeys(row)) for row in self.training_list]
        n_dedup = sum(len(row) for row in deduped)
        if n_dedup != n_raw:
            warnings.warn(
                f"dropped {n_raw - n_dedup} duplicate (user, item) training "
                "interactions (first occurrence kept); the reference would "
                "train through them, weighting those pairs more heavily",
                stacklevel=2,
            )
            self.training_list = deduped
        pairs = [
            (u, i) for u, row in enumerate(self.training_list) for i in row
        ]
        self.train_pairs = (
            np.array(pairs, dtype=np.int32)
            if pairs
            else np.zeros((0, 2), dtype=np.int32)
        )
        self.padded_pos, self.pos_counts = pad_sorted_positives(
            self.training_list, self.num_items
        )

    @property
    def num_train(self) -> int:
        return int(self.train_pairs.shape[0])

    @property
    def has_validation(self) -> bool:
        return any(len(r) > 0 for r in self.validation_list)

    def steps_per_epoch(self, batch_size: int) -> int:
        """floor(num_train / batch) batches per epoch, remainder dropped."""
        return self.num_train // batch_size

    @classmethod
    def load(cls, cfg: TrainConfig) -> "Interactions":
        """Load from the reference's on-disk layout."""
        paths = cfg.paths
        num_users, num_items = read_counts_from_info(
            paths.dataset_info(cfg.dataset)
        )
        train = pairs_to_user_lists(
            read_split_tsv(paths.training_set(cfg.dataset)), num_users
        )
        val_path = paths.validation_set(cfg.dataset)
        if cfg.validation and os.path.exists(val_path):
            val = pairs_to_user_lists(read_split_tsv(val_path), num_users)
        else:
            val = [[] for _ in range(num_users)]
        test = pairs_to_user_lists(
            read_split_tsv(paths.test_set(cfg.dataset)), num_users
        )
        return cls(num_users, num_items, train, val, test)

    @classmethod
    def from_lists(
        cls,
        training_list: Sequence[Sequence[int]],
        test_list: Sequence[Sequence[int]],
        num_items: int,
        validation_list: Optional[Sequence[Sequence[int]]] = None,
    ) -> "Interactions":
        num_users = len(training_list)
        if validation_list is None:
            validation_list = [[] for _ in range(num_users)]
        return cls(
            num_users,
            num_items,
            [list(r) for r in training_list],
            [list(r) for r in validation_list],
            [list(r) for r in test_list],
        )


def synthetic_interactions(
    num_users: int,
    num_items: int,
    interactions_per_user: int = 10,
    seed: int = 0,
    latent_dim: int = 8,
    validation: bool = True,
) -> Interactions:
    """Synthetic dataset with planted low-rank structure, split
    leave-one-out: last -> test, second-to-last -> validation, rest -> train.
    Same numpy draws as the JAX package, so the same dataset."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(num_users, latent_dim))
    V = rng.normal(size=(num_items, latent_dim))
    scores = U @ V.T + rng.gumbel(size=(num_users, num_items))
    order = np.argsort(-scores, axis=1)

    training, validation_l, test = [], [], []
    for u in range(num_users):
        items = order[u, :interactions_per_user].tolist()
        rng.shuffle(items)
        test.append([items[-1]])
        if validation and len(items) >= 3:
            validation_l.append([items[-2]])
            training.append(items[:-2])
        else:
            validation_l.append([])
            training.append(items[:-1])
    return Interactions.from_lists(training, test, num_items, validation_l)
