"""pandas-free tables for the offline dataset tools (``cli/build_amazon.py``,
``cli/split_dataset.py``, ``cli/logs_to_table.py``).

The JAX package's tools are pandas code; the port may not import pandas
(the card's machine has none).  A table here is a dict column name ->
numpy column, in column order, each column typed once, as pandas types a
DataFrame's column, and kept through filters, merges and sorts, so the
files written are byte-equal to ``to_csv``'s:

- ``from_rows`` is ``pd.DataFrame(records)``: the keys in order of first
  appearance; a column of ints is int64, of numbers float64 (a missing
  value or ``None`` among them NaN, so 2 is written ``2.0``), of bools
  bool, else object;
- ``read_csv`` is ``pd.read_csv`` (a header row, or columns 0, 1, ...
  with ``header=False``): a column is int64 if every cell is an integer,
  else float64 if every cell is a number or missing, else bool for
  True / False cells, else str; pandas' default NA strings ('', 'NA',
  'nan', 'null', 'None', ...) are missing.  Floats parse correctly rounded
  (Python's ``float``), where pandas' default C parser may land one ulp
  away;
- ``write_csv`` is ``to_csv(index=False)``: floats as numpy prints them,
  missing values empty, the ``csv`` module's minimal quoting, lines ended
  by a newline;
- ``nargsort`` is ``sort_values``' order for one column
  (``pandas.core.sorting.nargsort``: numpy's quicksort, over the reversed
  column for a descending sort, missing values last), ties included;
- ``merge_inner`` is ``pd.merge(how="inner")``: the left rows in order,
  each followed by its right matches in order;
- ``drop_duplicates``, ``unique`` and ``group_sizes`` are theirs
  (``groupby(col).size()``, keys sorted, missing keys dropped).
"""

from __future__ import annotations

import csv
import re
from typing import Dict, Hashable, List, Mapping, Optional, Sequence

import numpy as np

Table = Dict[Hashable, np.ndarray]

# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_INT = re.compile(r"[+-]?[0-9]+\Z")
_FLOAT = re.compile(r"[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?\Z|[+-]?inf\Z",
                    re.IGNORECASE)
_BOOL = {"True": True, "TRUE": True, "true": True,
         "False": False, "FALSE": False, "false": False}


def missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def isna(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype == object:
        return np.fromiter((missing(v) for v in col), bool, len(col))
    return np.zeros(len(col), bool)


def _is_bool(v) -> bool:
    return isinstance(v, (bool, np.bool_))


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not _is_bool(v)


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and not _is_bool(v)


def typed_column(values: Sequence) -> np.ndarray:
    """A column of Python values typed as pandas types it."""
    values = list(values)
    present = [v for v in values if not missing(v)]
    complete = len(present) == len(values)
    if present and complete and all(_is_bool(v) for v in present):
        return np.asarray(values, bool)
    if present and complete and all(_is_int(v) for v in present):
        return np.asarray(values, np.int64)
    if present and all(_is_number(v) for v in present):
        return np.asarray([np.nan if missing(v) else v for v in values], np.float64)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def from_rows(rows: Sequence[Mapping]) -> Table:
    """``pd.DataFrame(rows)``."""
    names: Dict[Hashable, None] = {}
    for r in rows:
        names.update(dict.fromkeys(r))
    return {n: typed_column([r.get(n) for r in rows]) for n in names}


def to_rows(table: Mapping[Hashable, np.ndarray]) -> List[dict]:
    """``df.to_dict("records")``: Python scalars, missing numbers NaN."""
    cols = {k: np.asarray(v).tolist() for k, v in table.items()}
    return [dict(zip(cols, vals)) for vals in zip(*cols.values())]


def n_rows(table: Mapping[Hashable, np.ndarray]) -> int:
    return len(next(iter(table.values()))) if table else 0


def take(table: Mapping[Hashable, np.ndarray], idx) -> Table:
    """The rows ``idx`` (indices or a boolean mask), types kept."""
    return {k: np.asarray(v)[idx] for k, v in table.items()}


def _read_column(cells: List[str]) -> np.ndarray:
    na = [c in NA_STRINGS for c in cells]
    vals = [c for c, m in zip(cells, na) if not m]
    if vals and not any(na) and all(_INT.match(c) for c in vals):
        return np.asarray([int(c) for c in cells], np.int64)
    if vals and all(_INT.match(c) or _FLOAT.match(c) for c in vals):
        return np.asarray([np.nan if m else float(c) for c, m in zip(cells, na)], np.float64)
    if vals and not any(na) and all(c in _BOOL for c in vals):
        return np.asarray([_BOOL[c] for c in cells], bool)
    return typed_column([np.nan if m else c for c, m in zip(cells, na)])


def read_csv(path: str, sep: str = ",", header: bool = True) -> Table:
    """``pd.read_csv(path, sep=sep)`` (``header=None`` with ``header=False``:
    columns 0, 1, ...); blank lines skipped, short rows padded missing."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    if header:
        names, rows = rows[0], rows[1:]
    else:
        names = list(range(max((len(r) for r in rows), default=0)))
    return {n: _read_column([r[j] if j < len(r) else "" for r in rows])
            for j, n in enumerate(names)}


def _cells(col: np.ndarray) -> List[str]:
    col = np.asarray(col)
    if col.dtype.kind == "f":
        return np.where(np.isnan(col), "", col.astype(str)).tolist()
    if col.dtype == object:
        return ["" if missing(v) else str(v) for v in col]
    return col.astype(str).tolist()


def write_csv(table: Mapping[Hashable, np.ndarray], path: str, sep: str = ",",
              header: bool = True) -> None:
    """``to_csv(path, sep=sep, index=False, header=header)``."""
    with open(path, "w", newline="") as f:
        if not table:
            f.write("\n")
            return
        w = csv.writer(f, delimiter=sep, lineterminator="\n")
        if header:
            w.writerow(list(table))
        w.writerows(zip(*(_cells(c) for c in table.values())))


def nargsort(col: np.ndarray, ascending: bool = True) -> np.ndarray:
    """``sort_values``' row order for one column (missing values last)."""
    col = np.asarray(col)
    mask = isna(col)
    idx = np.arange(len(col))
    non_nans, non_nan_idx = col[~mask], idx[~mask]
    if not ascending:
        non_nans, non_nan_idx = non_nans[::-1], non_nan_idx[::-1]
    order = non_nan_idx[non_nans.argsort(kind="quicksort")]
    if not ascending:
        order = order[::-1]
    return np.concatenate([order, np.nonzero(mask)[0]]).astype(np.int64)


def sort_by(table: Mapping[Hashable, np.ndarray], name: Hashable,
            ascending: bool = True) -> Table:
    """``df.sort_values(name, ascending=ascending)``."""
    return take(table, nargsort(table[name], ascending))


def drop_duplicates(table: Mapping[Hashable, np.ndarray],
                    subset: Optional[Sequence[Hashable]] = None) -> Table:
    """``df.drop_duplicates(subset)``: the first row of each value (tuple)
    of the ``subset`` columns (all of them by default), in order."""
    names = list(table) if subset is None else list(subset)
    seen, keep = set(), []
    for i, key in enumerate(zip(*(np.asarray(table[n]).tolist() for n in names))):
        key = tuple(None if missing(v) else v for v in key)
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return take(table, np.asarray(keep, np.int64))


def merge_inner(left: Mapping[Hashable, np.ndarray], right: Mapping[Hashable, np.ndarray],
                on) -> Table:
    """``pd.merge(left, right, on=on, how="inner")`` on one key column or a
    tuple / list of them (missing keys match each other): the left rows in
    order, each followed by its matches' right rows in order; the left
    columns, then the right ones but the keys; a non-key name in both
    becomes ``name_x`` and ``name_y``."""
    on = list(on) if isinstance(on, (list, tuple)) else [on]

    def keys(table):
        cols = [np.asarray(table[c]).tolist() for c in on]
        return [tuple(None if missing(v) else v for v in key) for key in zip(*cols)]

    matches: Dict[tuple, List[int]] = {}
    for j, key in enumerate(keys(right)):
        matches.setdefault(key, []).append(j)
    li, ri = [], []
    for i, key in enumerate(keys(left)):
        for j in matches.get(key, ()):
            li.append(i)
            ri.append(j)
    li, ri = np.asarray(li, np.int64), np.asarray(ri, np.int64)
    both = (set(left) & set(right)) - set(on)
    out: Table = {}
    for k, v in left.items():
        out[f"{k}_x" if k in both else k] = np.asarray(v)[li]
    for k, v in right.items():
        if k not in on:
            out[f"{k}_y" if k in both else k] = np.asarray(v)[ri]
    return out


def group_sizes(col: np.ndarray) -> Dict[Hashable, int]:
    """``groupby(col).size()`` as {key: rows}, keys sorted, missing keys
    dropped."""
    sizes: Dict[Hashable, int] = {}
    for v in np.asarray(col).tolist():
        if not missing(v):
            sizes[v] = sizes.get(v, 0) + 1
    return {k: sizes[k] for k in sorted(sizes)}


def unique(col: np.ndarray) -> list:
    """``Series.unique()``: values in order of first appearance (one
    missing value kept)."""
    seen: Dict[Hashable, None] = {}
    out = []
    for v in np.asarray(col).tolist():
        key = None if missing(v) else v
        if key not in seen:
            seen[key] = None
            out.append(v)
    return out
