"""Amazon-like dataset construction tools (port of
``fashionvisualexpl_tpu/cli/build_amazon.py``).

Ports of the reference's offline construction scripts (host-side, IO-bound
one-shot jobs, no device work), without pandas: tables are
``utils/frames.py``'s, typed as pandas types them, so every file written
is byte-equal to the JAX tool's, and the functions that return a
DataFrame there return a list of row dicts here, in the same order.

- build_urls: parse gzipped Amazon-2014 review/meta dumps, join reviews with
  image URLs, cap to the most-reviewed items, k-core filter, write all.tsv +
  image-URL CSV + stats (reference src/create_urls_amazon_like.py:40-119)
- remap_ids: USER/ASIN -> contiguous ids, write all_final/all_interactions/
  users/items TSVs, rename image files to item ids (reference
  src/create_user_item_amazon_like.py:15-56)
- check_k_core: per-user interaction-count distribution (reference
  src/check_k_core.py)
- copy_duplicates / copy_first_of_group: re-materialize duplicate
  images across ASINs sharing a URL (reference
  src/copy_duplicates_amazon_like.py, src/copy_first_of_each_duplicates_group.py)

  python -m fashionvisualexpl_tpu_torch.cli.build_amazon build_urls --dataset ...
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
from typing import Hashable, List, Mapping, Sequence

import numpy as np

from fashionvisualexpl_tpu_torch.core.config import Paths
from fashionvisualexpl_tpu_torch.utils import frames as fr
from fashionvisualexpl_tpu_torch.utils.io import ensure_dir


def _parse_gz(path: str, fields: List[str]) -> fr.Table:
    import ast

    rows = []
    with gzip.open(path, "rt") as f:
        for line in f:
            try:
                d = ast.literal_eval(line)
            except (ValueError, SyntaxError):
                continue
            rows.append({k: d.get(k) for k in fields})
    return fr.from_rows(rows)


def parse_amazon_gz(path: str, fields: List[str]) -> List[dict]:
    """Parse a gzipped Amazon-2014 dump (one Python-dict literal per line)
    into row dicts of ``fields`` (a missing field None)."""
    return fr.to_rows(_parse_gz(path, fields))


def _k_core(table: fr.Table, user_col: Hashable, item_col: Hashable, k: int) -> fr.Table:
    def keep(col):  # groupby(col).transform("size") >= k; a missing key drops
        sizes = fr.group_sizes(col)
        return np.fromiter((not fr.missing(v) and sizes[v] >= k
                            for v in np.asarray(col).tolist()), bool, len(col))

    while True:
        before = fr.n_rows(table)
        table = fr.take(table, keep(table[item_col]))
        table = fr.take(table, keep(table[user_col]))
        if fr.n_rows(table) == before:
            return table


def k_core_filter(rows: Sequence[Mapping], user_col: Hashable, item_col: Hashable,
                  k: int) -> List[dict]:
    """Iteratively drop items then users with < k interactions until stable
    (reference create_urls_amazon_like.py:80-92 applies one item pass then
    one user pass; iterating to a fixed point is what 'k-core' means)."""
    return fr.to_rows(_k_core(fr.from_rows(rows), user_col, item_col, k))


def _top_items(asins: np.ndarray, n: int) -> set:
    """``groupby("asin").size().sort_values(ascending=False).head(n).index``:
    pandas' default sort is numpy's quicksort, not stable, so which of the
    items tied at the cut stay is numpy's choice, reproduced here."""
    sizes = fr.group_sizes(asins)
    keys = list(sizes)
    order = fr.nargsort(np.asarray(list(sizes.values()), np.int64), ascending=False)
    return {keys[i] for i in order[:n]}


def build_urls(args):
    paths = Paths(root=args.data_root)
    ds = args.dataset
    reviews = _parse_gz(
        args.reviews_gz, ["reviewerID", "asin", "reviewText", "unixReviewTime"]
    )
    meta = _parse_gz(args.meta_gz, ["asin", "imUrl"])
    meta = fr.take(meta, ~fr.isna(meta["imUrl"]))
    df = fr.merge_inner(reviews, meta, on="asin")

    # top-N most-reviewed items (create_urls_amazon_like.py:74-78)
    top = _top_items(df["asin"], args.max_items)
    df = fr.take(df, np.fromiter((v in top for v in df["asin"].tolist()), bool,
                                 fr.n_rows(df)))
    df = _k_core(df, "reviewerID", "asin", args.k_core)

    ddir = ensure_dir(paths.data_dir(ds))
    names = {"reviewerID": "USER", "asin": "ASIN", "reviewText": "REVIEW",
             "unixReviewTime": "TIME"}
    df = {names.get(k, k): v for k, v in df.items()}
    fr.write_csv(df, os.path.join(ddir, "all.tsv"), sep="\t")
    urls = fr.drop_duplicates({k: df[k] for k in ("ASIN", "imUrl")}, ["ASIN"])
    fr.write_csv(urls, os.path.join(ddir, "all_items.csv"))
    n, users, items = fr.n_rows(df), _nunique(df["USER"]), _nunique(df["ASIN"])
    with open(paths.dataset_info(ds), "w") as f:
        f.write(
            f"interactions: {n}\n"
            f"----\n"
            f"users: {users}\n"
            f"items: {items}\n"
        )
    print(f"{n} interactions, {users} users, {items} items")


def _nunique(col: np.ndarray) -> int:
    return sum(1 for v in fr.unique(col) if not fr.missing(v))


def remap_ids(args):
    paths = Paths(root=args.data_root)
    ds = args.dataset
    ddir = paths.data_dir(ds)
    df = fr.read_csv(os.path.join(ddir, "all.tsv"), sep="\t")

    users = {u: i for i, u in enumerate(sorted(fr.unique(df["USER"])))}
    items = {a: i for i, a in enumerate(sorted(fr.unique(df["ASIN"])))}
    df["USER_ID"] = fr.typed_column([users[u] for u in df["USER"].tolist()])
    df["ITEM_ID"] = fr.typed_column([items[a] for a in df["ASIN"].tolist()])

    n = fr.n_rows(df)
    sparsity = 1 - n / (len(users) * len(items))
    print(
        f"{len(users)} users, {len(items)} items, {n} interactions, "
        f"sparsity {sparsity:.6f}"
    )

    fr.write_csv(df, paths.all_final(ds), sep="\t")
    fr.write_csv({k: df[k] for k in ("USER_ID", "ITEM_ID", "TIME")},
                 paths.all_interactions(ds), sep="\t", header=False)
    for table, path in (
        ({"USER": list(users), "USER_ID": list(users.values())}, paths.users(ds)),
        ({"ASIN": list(items), "ITEM_ID": list(items.values())}, paths.items(ds)),
    ):
        fr.write_csv({k: fr.typed_column(v) for k, v in table.items()}, path, sep="\t")
    with open(paths.dataset_info(ds), "w") as f:
        f.write(
            f"interactions: {n}\n----\n"
            f"users: {len(users)}\nitems: {len(items)}\n"
        )

    # rename image files ASIN.jpg -> ITEM_ID.jpg (create_user_item:51-56)
    img_dir = paths.images(ds)
    if os.path.isdir(img_dir) and args.rename_images:
        for fname in os.listdir(img_dir):
            stem, ext = os.path.splitext(fname)
            if stem in items:
                os.rename(
                    os.path.join(img_dir, fname),
                    os.path.join(img_dir, f"{items[stem]}{ext}"),
                )


def check_k_core(args):
    """The number of users with each interaction count, then the least."""
    paths = Paths(root=args.data_root)
    df = fr.read_csv(paths.all_interactions(args.dataset), sep="\t", header=False)
    counts = list(fr.group_sizes(df[0]).values())
    dist = {c: counts.count(c) for c in sorted(set(counts))}
    print("interactions\tusers")
    for c, u in dist.items():
        print(f"{c}\t{u}")
    print(f"min interactions per user: {min(counts)}")


def copy_duplicates(args):
    """Items sharing an image URL get a copy of the canonical image
    (copy_duplicates_amazon_like.py:23-32)."""
    paths = Paths(root=args.data_root)
    urls = fr.read_csv(os.path.join(paths.data_dir(args.dataset), "all_items.csv"))
    img_dir = paths.images(args.dataset)
    groups = {}
    for a, u in zip(urls["ASIN"].tolist(), urls["imUrl"].tolist()):
        if not fr.missing(u):
            groups.setdefault(u, []).append(a)
    for url in sorted(groups):
        asins = groups[url]
        present = [
            a for a in asins
            if os.path.exists(os.path.join(img_dir, f"{a}.jpg"))
        ]
        if not present:
            continue
        src = os.path.join(img_dir, f"{present[0]}.jpg")
        for a in asins:
            dst = os.path.join(img_dir, f"{a}.jpg")
            if not os.path.exists(dst):
                shutil.copyfile(src, dst)


def copy_first_of_group(args):
    """Copy the canonical (first-listed) member of each fdupes-style
    duplicates group into a `duplicates_dir` and record the list
    (copy_first_of_each_duplicates_group.py:12-32).  The input file is
    fdupes output: groups of `./name` lines separated by blank lines."""
    paths = Paths(root=args.data_root)
    base = paths.data_dir(args.dataset)
    suffix = "_final" if args.final else ""
    with open(os.path.join(base, "duplicates" + suffix)) as f:
        lines = f.read().split("\n")
    firsts, at_group_start = [], True
    for line in lines:
        if not line:
            at_group_start = True
            continue
        if at_group_start:
            firsts.append(line[2:] if line.startswith("./") else line)
            at_group_start = False
    with open(os.path.join(base, "first_of_each" + suffix), "w") as f:
        f.writelines(name + "\n" for name in firsts)
    out_dir = os.path.join(base, f"duplicates_dir{suffix}")
    os.makedirs(out_dir, exist_ok=True)
    img_dir = paths.images(args.dataset)
    for name in firsts:
        shutil.copy(os.path.join(img_dir, name), out_dir)
    print(f"copied {len(firsts)} canonical duplicates to {out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Amazon-like dataset tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build_urls")
    b.add_argument("--dataset", required=True)
    b.add_argument("--reviews_gz", required=True)
    b.add_argument("--meta_gz", required=True)
    b.add_argument("--max_items", type=int, default=50_000)
    b.add_argument("--k_core", type=int, default=5)
    b.add_argument("--data_root", default="data")
    b.set_defaults(fn=build_urls)

    r = sub.add_parser("remap_ids")
    r.add_argument("--dataset", required=True)
    r.add_argument("--data_root", default="data")
    r.add_argument("--rename_images", action="store_true")
    r.set_defaults(fn=remap_ids)

    k = sub.add_parser("check_k_core")
    k.add_argument("--dataset", required=True)
    k.add_argument("--data_root", default="data")
    k.set_defaults(fn=check_k_core)

    c = sub.add_parser("copy_duplicates")
    c.add_argument("--dataset", required=True)
    c.add_argument("--data_root", default="data")
    c.set_defaults(fn=copy_duplicates)

    g = sub.add_parser("copy_first_of_group")
    g.add_argument("--dataset", required=True)
    g.add_argument("--data_root", default="data")
    g.add_argument("--final", action="store_true",
                   help="operate on the *_final duplicates file")
    g.set_defaults(fn=copy_first_of_group)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
