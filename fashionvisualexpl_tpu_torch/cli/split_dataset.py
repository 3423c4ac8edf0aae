"""Temporal leave-one-out splitter (port of
``fashionvisualexpl_tpu/cli/split_dataset.py``; reference
src/split_dataset.py:14-33).

Per user (sorted by timestamp ascending): last interaction -> test,
second-to-last -> validation (optional), rest -> train; implicit rating 1.0.
No pandas (``utils/frames.py``); the split TSVs are byte-equal to the JAX
tool's.

  python -m fashionvisualexpl_tpu_torch.cli.split_dataset --dataset amazon_baby
"""

from __future__ import annotations

import argparse
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from fashionvisualexpl_tpu_torch.core.config import Paths
from fashionvisualexpl_tpu_torch.utils import frames as fr


def _last_of_each(table: fr.Table) -> np.ndarray:
    """``groupby([0]).tail(1)``'s row positions: each user's last row, in
    row order (rows without a user dropped)."""
    last = {}
    for i, u in enumerate(np.asarray(table[0]).tolist()):
        if not fr.missing(u):
            last[u] = i
    return np.sort(np.fromiter(last.values(), np.int64, len(last)))


def _split(table: fr.Table, validation: bool):
    n = fr.n_rows(table)
    # the stable (user, time) sort (split_dataset.py:16)
    keys = list(zip(np.asarray(table[0]).tolist(), np.asarray(table[2]).tolist()))
    table = fr.take(table, np.asarray(sorted(range(n), key=keys.__getitem__), np.int64))
    is_test = np.zeros(n, bool)
    is_test[_last_of_each(table)] = True
    test = fr.drop_duplicates(fr.take(table, is_test))
    train = fr.take(table, ~is_test)
    for t in (train, test):
        t[3] = np.ones(fr.n_rows(t), np.float64)
    val = None
    if validation:
        is_val = np.zeros(fr.n_rows(train), bool)
        is_val[_last_of_each(train)] = True
        val = fr.drop_duplicates(fr.take(train, is_val))
        train = fr.take(train, ~is_val)
    return train, val, test


def split_interactions(rows: Sequence[Mapping], validation: bool = True
                       ) -> Tuple[List[dict], Optional[List[dict]], List[dict]]:
    """rows: dicts with [0]=user, [1]=item, [2]=time.  Returns (train, val,
    test) as row dicts with a rating column [3]=1.0; val is None without
    validation."""
    train, val, test = _split(fr.from_rows(rows), validation)
    return fr.to_rows(train), (None if val is None else fr.to_rows(val)), fr.to_rows(test)


def main(argv=None):
    p = argparse.ArgumentParser(description="Run dataset splitting.")
    p.add_argument("--dataset", nargs="?", default="amazon_baby")
    p.add_argument("--validation", type=lambda s: s not in ("0", "False"),
                   default=True)
    p.add_argument("--data_root", type=str, default="data")
    args = p.parse_args(argv)

    paths = Paths(root=args.data_root)
    table = fr.read_csv(paths.all_interactions(args.dataset), sep="\t", header=False)
    train, val, test = _split(table, args.validation)
    fr.write_csv(train, paths.training_set(args.dataset), sep="\t", header=False)
    fr.write_csv(test, paths.test_set(args.dataset), sep="\t", header=False)
    if val is not None:
        fr.write_csv(val, paths.validation_set(args.dataset), sep="\t", header=False)


if __name__ == "__main__":
    main()
