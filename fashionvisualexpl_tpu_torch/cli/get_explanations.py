"""Explanation-join CLI (port of ``fashionvisualexpl_tpu/cli/get_explanations.py``;
reference src/get_explanations.py:17-41): join a gradient-attribution dump
with the review text and write the top-N color-driven and edge-driven
recommendation tables, ``color_reviews.tsv`` and ``edges_reviews.tsv``,
beside the dump.  No pandas (``explain/grads.py``).

  python -m fashionvisualexpl_tpu_torch.cli.get_explanations --dataset amazon_baby \\
      --rec grad_fashion --file best-grads-10-....tsv
"""

from __future__ import annotations

import argparse
import os

from fashionvisualexpl_tpu_torch.core.config import Paths
from fashionvisualexpl_tpu_torch.explain.grads import (
    COLUMNS,
    join_reviews,
    read_tsv,
    write_tsv,
)


def main(argv=None):
    p = argparse.ArgumentParser(description="Run logs to excel.")
    p.add_argument("--dataset", nargs="?", default="amazon_baby")
    p.add_argument("--rec", nargs="?", default="grad_fashion")
    p.add_argument("--file", nargs="?", required=True)
    p.add_argument("--top_n", type=int, default=50)
    p.add_argument("--data_root", default="data")
    p.add_argument("--results_root", default="results")
    args = p.parse_args(argv)

    paths = Paths(root=args.data_root, results_root=args.results_root)
    rdir = paths.results_dir(args.dataset, args.rec)
    grads = read_tsv(os.path.join(rdir, args.file), names=COLUMNS)
    reviews = read_tsv(paths.all_final(args.dataset))
    color_driven, edge_driven = join_reviews(grads, reviews, top_n=args.top_n)
    write_tsv(color_driven, os.path.join(rdir, "color_reviews.tsv"))
    write_tsv(edge_driven, os.path.join(rdir, "edges_reviews.tsv"))
    print(f"wrote color_reviews.tsv and edges_reviews.tsv to {rdir}")


if __name__ == "__main__":
    main()
