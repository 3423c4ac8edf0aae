"""Sweep-results aggregation (port of
``fashionvisualexpl_tpu/cli/logs_to_table.py``; the role of reference
src/logs_to_excel.py).

The reference scrapes stdout text with hardcoded line offsets
(logs_to_excel.py:26-53); this framework logs structured JSONL per run
(utils/io.py JsonlLogger), so aggregation is a join over records: one row
per run with its hyperparameters (parsed from the log filename tag) and the
best-epoch metrics, sorted by the chosen metric.  No pandas: the
aggregates are lists of row dicts (where the JAX tool returns a
DataFrame), and the tables written are byte-equal to its ``to_csv``
(``utils/frames.py``: a column missing from some rows, or holding None,
is a float column, so 2 is written ``2.0``).

  python -m fashionvisualexpl_tpu_torch.cli.logs_to_table --dataset amazon_baby \\
      --rec bprmf --metric ndcg_v

``--format reference`` instead ingests REFERENCE-format stdout capture
logs (the `{rec}-{dataset}*` files logs_to_excel.py globs): per
END-REGULARIZATION block it reads the best-epoch metric block at the
reference's own offsets (test values 7 lines above the marker, validation
10 — logs_to_excel.py:38-43) and parses hyperparameters from filename
segments (`...-lr0.001-emk128-...`) plus the positional --regs list, so
existing reference log archives aggregate without rerunning anything.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import warnings

from typing import List

from fashionvisualexpl_tpu_torch.core.config import Paths
from fashionvisualexpl_tpu_torch.utils import frames as fr


def parse_run_tag(filename: str):
    """log-batch_256-K_128-lr_0.001-reg_0.0.jsonl -> hyperparameter dict.

    Parts without '_' re-join the previous value with '-', so scientific
    notation survives (reg_1e-05 -> reg='1e-05', not '1e')."""
    tag = os.path.basename(filename)[len("log-"):-len(".jsonl")]
    out = {}
    last_key = None
    for part in tag.split("-"):
        if "_" in part:
            k, v = part.split("_", 1)
            out[k] = v
            last_key = k
        elif last_key is not None:
            out[last_key] += "-" + part
    return out


REF_METRICS = ("hr", "p", "r", "auc", "ndcg")


def scrape_reference_log(path: str, params_to_sort=("lr", "emk"),
                         regs=(0.0, 1e-05, 0.0001, 0.001, 0.01, 0.1)):
    """Parse one reference-format stdout log into sweep rows.

    Reproduces logs_to_excel.py:26-53 exactly: each regularization
    iteration ends with an 'END REGULARIZATION' line; counting back from
    it, the BEST-epoch metric block printed by BPRMF.py:176 sits so that
    its test-values line is content[-7] and its validation-values line is
    content[-10] (both of the form '\\t\\t%f\\t%f\\t%f\\t%f\\t%f' —
    Evaluator.py:194-201, fields 2..6 after a tab split).  Hyperparameters
    come from filename segments containing the param key
    ('bprmf-baby-lr0.001-emk128.log' -> lr=0.001, emk=128,
    logs_to_excel.py:44-48) and reg from the block's ordinal position in
    the --regs list the sweep was launched with."""
    with open(path) as f:
        lines = f.readlines()

    name_parts = os.path.basename(path).split("-")

    def _param(key):
        for s in name_parts:
            if key in s:
                tail = s.split(key, 1)[1]
                m = re.match(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", tail)
                if m:
                    txt = m.group(0)
                    return float(txt) if ("." in txt or "e" in txt.lower()) \
                        else int(txt)
        return None

    rows = []
    content = []
    reg_index = 0
    for line in lines:
        if line == "END REGULARIZATION\n":
            if len(content) < 10:
                content = []
                reg_index += 1
                continue
            test_res = [float(t) for t in content[-7].split("\t")[2:]]
            val_res = [float(v) for v in content[-10].split("\t")[2:]]
            row = {k: _param(k) for k in params_to_sort}
            if reg_index >= len(regs):
                # the reference would IndexError here (logs_to_excel.py:50)
                # — surface the mismatch instead of silently mislabeling
                # rows from a sweep launched with a different regs list
                warnings.warn(
                    f"{path}: {reg_index + 1} END-REGULARIZATION blocks but "
                    f"only {len(regs)} values in --regs — rows beyond the "
                    "list get reg=None; pass the sweep's actual --regs list"
                )
            row["reg"] = (
                regs[reg_index] if reg_index < len(regs) else None
            )
            row.update({m + "_v": v for m, v in zip(REF_METRICS, val_res)})
            row.update({m + "_t": v for m, v in zip(REF_METRICS, test_res)})
            rows.append(row)
            content = []
            reg_index += 1
        else:
            content.append(line)
    return rows


def _sorted(rows: List[dict], metric: str) -> List[dict]:
    """``pd.DataFrame(rows).sort_values(metric, ascending=False)`` when the
    metric is a column, as row dicts (every column in every row)."""
    table = fr.from_rows(rows)
    if metric in table:
        table = fr.sort_by(table, metric, ascending=False)
    return fr.to_rows(table)


def aggregate_reference(
    log_glob: str, metric: str = "ndcg_v",
    params_to_sort=("lr", "emk"),
    regs=(0.0, 1e-05, 0.0001, 0.001, 0.01, 0.1),
) -> List[dict]:
    rows = []
    for path in sorted(glob.glob(log_glob)):
        rows.extend(scrape_reference_log(path, params_to_sort, regs))
    return _sorted(rows, metric)


def aggregate(results_dir: str, metric: str = "ndcg_v") -> List[dict]:
    rows = []
    for path in glob.glob(os.path.join(results_dir, "log-*.jsonl")):
        records = [json.loads(l) for l in open(path) if l.strip()]
        with_metric = [r for r in records if metric in r]
        if not with_metric:
            continue
        best = max(with_metric, key=lambda r: r[metric])
        row = parse_run_tag(path)
        row.update(
            best_epoch=best["epoch"],
            **{k: v for k, v in best.items() if k != "epoch"},
        )
        rows.append(row)
    return _sorted(rows, metric)


def _write(rows: List[dict], out: str) -> None:
    """The table as the JAX tool writes it (``to_csv``), and on stdout
    tab-separated (the JAX tool prints pandas' ``to_string``)."""
    table = fr.from_rows(rows)
    fr.write_csv(table, out, sep="\t")
    print("\t".join(str(k) for k in table))
    for r in fr.to_rows(table):
        print("\t".join("" if fr.missing(v) else str(v) for v in r.values()))
    print(f"\nwrote {out}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Aggregate sweep logs to a table.")
    p.add_argument("--dataset", nargs="?", default="amazon_baby")
    p.add_argument("--rec", nargs="?", default="bprmf")
    p.add_argument("--metric", default="ndcg_v")
    p.add_argument("--results_root", default="results")
    p.add_argument("--out", default=None)
    p.add_argument(
        "--format", choices=("jsonl", "reference"), default="jsonl",
        help="'reference' scrapes reference-format stdout logs "
             "(logs_to_excel.py semantics) instead of this framework's JSONL",
    )
    p.add_argument(
        "--logs_glob", default=None,
        help="glob of reference stdout logs (--format reference); "
             "defaults to <results_root>/<rec>-<dataset>*",
    )
    p.add_argument(
        "--param_to_sort", nargs="+", default=["lr", "emk"],
        help="filename hyperparameter keys (--format reference)",
    )
    p.add_argument(
        "--regs", nargs="+", type=float,
        default=[0.0, 0.00001, 0.0001, 0.001, 0.01, 0.1],
        help="the sweep's regularization list, in launch order "
             "(--format reference)",
    )
    args = p.parse_args(argv)

    paths = Paths(results_root=args.results_root)
    rdir = paths.results_dir(args.dataset, args.rec)
    if args.format == "reference":
        pattern = args.logs_glob or os.path.join(
            args.results_root, f"{args.rec}-{args.dataset}*"
        )
        rows = aggregate_reference(
            pattern, args.metric, tuple(args.param_to_sort), tuple(args.regs)
        )
        out = args.out or os.path.join(
            args.results_root, f"{args.rec}_{args.dataset}.tsv"
        )
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        _write(rows, out)
        return
    rows = aggregate(rdir, args.metric)
    out = args.out or os.path.join(rdir, "sweep_table.tsv")
    _write(rows, out)


if __name__ == "__main__":
    main()
