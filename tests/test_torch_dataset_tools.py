"""Port dataset tools (``cli/split_dataset.py``, ``cli/build_amazon.py``,
``cli/logs_to_table.py`` over ``utils/frames.py``, no pandas) vs the JAX
package's pandas tools: a twin of each test of
``tests/test_dataset_tools.py``, run on the same inputs through the JAX
function and the port's.  Rows equal to the JAX DataFrame's
``to_dict("records")`` (NaN equal to NaN), in order; every file written
byte-equal.  Beyond the JAX tests: the top-N cut with items tied at the
cut (pandas sorts group sizes with numpy's unstable quicksort, and the port
takes the same items), review text holding a tab, a quote and a newline,
missing fields (a float column written ``123.0``), all-digit ASINs (read
back as integers, as pandas reads them), and a sweep column missing from
some runs (an int written ``2.0``)."""

import gzip
import json
import os

import numpy as np
import pandas as pd
import pytest

from fashionvisualexpl_tpu.cli import build_amazon as JA
from fashionvisualexpl_tpu.cli import logs_to_table as JL
from fashionvisualexpl_tpu.cli import split_dataset as JS
from fashionvisualexpl_tpu_torch.cli import build_amazon as PA
from fashionvisualexpl_tpu_torch.cli import logs_to_table as PL
from fashionvisualexpl_tpu_torch.cli import split_dataset as PS
from fashionvisualexpl_tpu_torch.utils import frames as fr


def norm(rows):
    """Row dicts with NaN made comparable."""
    return [{k: ("NaN" if isinstance(v, float) and v != v else v) for k, v in r.items()}
            for r in rows]


def records(df):
    return None if df is None else norm(df.to_dict("records"))


def tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


class _Args:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_split_temporal_leave_one_out():
    """Last interaction -> test, second-to-last -> val, rest -> train
    (reference split_dataset.py:16-33), as JAX splits them."""
    rows = [(u, 10 * u + t, 100 + t) for u in range(4) for t in range(5)]
    df = pd.DataFrame(rows)
    want = JS.split_interactions(df, validation=True)
    train, val, test = PS.split_interactions(df.to_dict("records"), validation=True)
    assert [norm(train), norm(val), norm(test)] == [records(w) for w in want]
    for u in range(4):
        assert [r[1] for r in test if r[0] == u] == [10 * u + 4]  # latest
        assert [r[1] for r in val if r[0] == u] == [10 * u + 3]  # second latest
        assert sorted(r[1] for r in train if r[0] == u) == [10 * u + t for t in range(3)]
    assert all(r[3] == 1.0 for r in train + test)

    train2, val2, test2 = PS.split_interactions(df.to_dict("records"), validation=False)
    assert val2 is None and len(train2) == 16
    jtrain2, _, jtest2 = JS.split_interactions(df, validation=False)
    assert [norm(train2), norm(test2)] == [records(jtrain2), records(jtest2)]


@pytest.mark.parametrize("validation", ["True", "0"])
def test_split_main_files_byte_equal(tmp_path, validation):
    """Unsorted rows with time ties (the stable sort keeps file order) and a
    user with one interaction, through both mains."""
    rng = np.random.default_rng(3)
    rows = [(int(u), int(i), int(t)) for u, i, t in zip(
        rng.integers(0, 9, 80), rng.integers(0, 50, 80), rng.integers(0, 6, 80))]
    rows.append((42, 7, 3))
    files = {}
    for side, main in (("jax", JS.main), ("port", PS.main)):
        root = tmp_path / side
        (root / "d").mkdir(parents=True)
        (root / "d" / "all_interactions.tsv").write_text(
            "".join(f"{u}\t{i}\t{t}\n" for u, i, t in rows))
        main(["--dataset", "d", "--data_root", str(root), "--validation", validation])
        files[side] = tree_bytes(root)
    assert files["port"] == files["jax"]
    assert len(files["port"]) == (4 if validation == "True" else 3)


def test_k_core_filter_fixed_point():
    # item 99 has one interaction; dropping it leaves user 3 with one -> drop
    df = pd.DataFrame({
        "u": [0, 0, 1, 1, 2, 2, 3, 3],
        "i": [10, 11, 10, 11, 10, 11, 11, 99],
    })
    out = PA.k_core_filter(df.to_dict("records"), "u", "i", k=2)
    assert norm(out) == records(JA.k_core_filter(df, "u", "i", k=2))
    assert 99 not in [r["i"] for r in out]
    assert 3 not in [r["u"] for r in out]
    assert {r["u"] for r in out} == {0, 1, 2}


def write_dumps(root, reviews, meta):
    rgz, mgz = os.path.join(root, "reviews.gz"), os.path.join(root, "meta.gz")
    with gzip.open(rgz, "wt") as f:
        for r in reviews:
            f.write(repr(r) + "\n")
        f.write("not a literal\n")  # skipped by both parsers
    with gzip.open(mgz, "wt") as f:
        for m in meta:
            f.write(repr(m) + "\n")
    return rgz, mgz


def build_both(tmp_path, reviews, meta, **kw):
    """build_urls then remap_ids through both tools on the same dumps; the
    port's tree (and what each printed) beside JAX's."""
    out = {}
    for side, mod in (("jax", JA), ("port", PA)):
        root = str(tmp_path / side)
        os.makedirs(root)
        rgz, mgz = write_dumps(root, reviews, meta)
        mod.build_urls(_Args(dataset="amz", reviews_gz=rgz, meta_gz=mgz,
                             data_root=root, **kw))
        mod.remap_ids(_Args(dataset="amz", data_root=root, rename_images=False))
        out[side] = tree_bytes(os.path.join(root, "amz"))
    return out


def test_build_urls_and_remap(tmp_path):
    root = str(tmp_path / "jax")
    reviews = [
        {"reviewerID": f"U{u}", "asin": f"A{i}", "reviewText": "nice",
         "unixReviewTime": 100 + u + i}
        for u in range(4) for i in range(3)
    ]
    meta = [{"asin": f"A{i}", "imUrl": f"http://x/{i}.jpg"} for i in range(3)]
    files = build_both(tmp_path, reviews, meta, max_items=100, k_core=2)
    assert files["port"] == files["jax"]
    all_tsv = pd.read_csv(os.path.join(root, "amz", "all.tsv"), sep="\t")
    assert len(all_tsv) == 12
    final = pd.read_csv(os.path.join(root, "amz", "all_final.tsv"), sep="\t")
    assert final.USER_ID.max() == 3 and final.ITEM_ID.max() == 2
    info = files["port"]["stats_after_downloading"].decode().splitlines()
    assert int(info[2].split(": ")[1]) == 4 and int(info[3].split(": ")[1]) == 3
    rgz = os.path.join(root, "reviews.gz")
    fields = ["reviewerID", "asin", "reviewText", "unixReviewTime"]
    assert norm(PA.parse_amazon_gz(rgz, fields)) == records(JA.parse_amazon_gz(rgz, fields))


def test_build_urls_review_text_and_missing_fields(tmp_path):
    """Review text with a tab, quotes and a newline (quoted by to_csv), a
    review without text or time (the time column then floats: 123.0), a
    meta row without an image URL (dropped) and an ASIN with two meta rows
    (both joined)."""
    texts = ['a\ttab', 'say "hi"', "two\nlines", "plain", 'mix "\t"', "NA"]
    reviews = [{"reviewerID": f"U{u}", "asin": f"A{i}", "reviewText": texts[(u + i) % 6],
                "unixReviewTime": 1_400_000_000 + 7 * u + i}
               for u in range(5) for i in range(4)]
    reviews[3] = {"reviewerID": "U0", "asin": "A3"}
    meta = [{"asin": f"A{i}", "imUrl": f"http://x/{i}.jpg"} for i in range(4)]
    meta += [{"asin": "A9"}, {"asin": "A2", "imUrl": "http://y/2.jpg"}]
    files = build_both(tmp_path, reviews, meta, max_items=100, k_core=2)
    assert files["port"] == files["jax"]
    assert b'"a\ttab"' in files["port"]["all.tsv"] and b".0\t" in files["port"]["all.tsv"]


@pytest.mark.parametrize("max_items", [3, 17, 30])
def test_build_urls_top_n_ties(tmp_path, max_items):
    """Items tied in review count across the top-N cut: 40 items of 3, 4 or
    5 reviews (more than numpy's quicksort sorts by insertion, so the tied
    items' order is not the stable one), all-digit ASINs (remap_ids then
    reads them as integers, as pandas does).  Which tied items stay is
    numpy's choice; both tools make the same one."""
    counts = np.random.default_rng(5).integers(3, 6, 40)
    reviews, u = [], 0
    for item, c in enumerate(counts):
        for j in range(c):
            reviews.append({"reviewerID": f"R{(u + 7 * j) % 60:02d}", "asin": f"0{item:02d}1",
                            "reviewText": f"r{u}", "unixReviewTime": 10 * u + j})
        u += 3
    meta = [{"asin": f"0{i:02d}1", "imUrl": f"http://x/{i}.jpg"} for i in range(len(counts))]
    files = build_both(tmp_path, reviews, meta, max_items=max_items, k_core=1)
    assert files["port"] == files["jax"]
    items = files["port"]["items.tsv"].decode().splitlines()
    assert len(items) == 1 + max_items and items[0] == "ASIN\tITEM_ID"
    kept = sorted(int(line.split("\t")[0]) // 10 for line in items[1:])
    cut = sorted(counts, reverse=True)[max_items - 1]
    assert sum(counts[kept] == cut) < sum(counts == cut)  # the cut splits a tie


def test_logs_aggregation(tmp_path):
    rdir = str(tmp_path)
    for reg, best in (("0.0", 0.3), ("0.01", 0.5)):
        path = os.path.join(rdir, f"log-batch_64-K_8-lr_0.01-reg_{reg}.jsonl")
        with open(path, "w") as f:
            for epoch, v in ((1, 0.1), (2, best), (3, best - 0.05)):
                f.write(json.dumps({"epoch": epoch, "ndcg_v": v}) + "\n")
    tag = PL.parse_run_tag(os.path.join(rdir, "log-batch_64-K_8-lr_0.01-reg_0.0.jsonl"))
    assert tag == {"batch": "64", "K": "8", "lr": "0.01", "reg": "0.0"}
    assert tag == JL.parse_run_tag(os.path.join(rdir, "log-batch_64-K_8-lr_0.01-reg_0.0.jsonl"))
    assert PL.parse_run_tag("log-reg_1e-05-lr_0.1.jsonl") == {"reg": "1e-05", "lr": "0.1"}
    rows = PL.aggregate(rdir, "ndcg_v")
    assert norm(rows) == records(JL.aggregate(rdir, "ndcg_v"))
    assert len(rows) == 2
    assert rows[0]["reg"] == "0.01"  # best first
    assert rows[0]["best_epoch"] == 2


def test_logs_main_files_byte_equal(tmp_path):
    """Both mains over the same results tree, with a metric missing from one
    run (its column floats: 2 -> 2.0) and tied best values."""
    files = {}
    for side, main in (("jax", JL.main), ("port", PL.main)):
        rdir = tmp_path / side / "results" / "rec_results" / "amz" / "bprmf"
        rdir.mkdir(parents=True)
        for n, (reg, best) in enumerate((("0.0", 0.5), ("0.1", 0.5), ("1e-05", 0.25))):
            with open(rdir / f"log-batch_64-K_8-lr_0.01-reg_{reg}.jsonl", "w") as f:
                for epoch, v in ((1, 0.1), (2, best)):
                    rec = {"epoch": epoch, "ndcg_v": v, "auc_v": 0.5 + 0.01 * n}
                    if n != 1:
                        rec["hits"] = 2
                    f.write(json.dumps(rec) + "\n")
        main(["--dataset", "amz", "--rec", "bprmf", "--metric", "ndcg_v",
              "--results_root", str(tmp_path / side / "results")])
        files[side] = tree_bytes(tmp_path / side)
    assert files["port"] == files["jax"]
    table = files["port"]["results/rec_results/amz/bprmf/sweep_table.tsv"].decode()
    assert "\t2.0\t" in table or table.rstrip().endswith("\t2.0") or "\t2.0\n" in table


def reference_log(epoch_block):
    best_v = [0.5, 0.4, 0.3, 0.9, 0.25]
    best_t = [0.45, 0.35, 0.28, 0.88, 0.22]
    log = (
        "ITERATION 1/2 WITH REGULARIZATION: 0.000000\n"
        "Start training...\n"
        + epoch_block([0.1] * 5, [0.1] * 5)  # a non-best epoch
        + "Training end...\n"
        "Store Best Model at Epoch 1\n"
        + epoch_block(best_v, best_t)
        + "End Store Best Model!\n"
        "Best Values for Each Metric:\nHR\tPrec\tRec\tAUC\tnDCG\n"
        "0.5\t0.4\t0.3\t0.9\t0.25\n\n"
        "END REGULARIZATION\n"
        "ITERATION 2/2 WITH REGULARIZATION: 0.010000\n"
        "Start training...\n"
        + epoch_block([0.2] * 5, [0.2] * 5)
        + "Training end...\n"
        "Store Best Model at Epoch 1\n"
        + epoch_block([0.2] * 5, [0.21] * 5)
        + "End Store Best Model!\n"
        "Best Values for Each Metric:\nHR\tPrec\tRec\tAUC\tnDCG\n"
        "0.2\t0.2\t0.2\t0.2\t0.2\n\n"
        "END REGULARIZATION\n"
    )
    return log, best_v, best_t


def test_reference_stdout_scrape(tmp_path):
    """--format reference: the best-epoch block at the reference's offsets,
    filename hyperparams, positional regs; the epoch blocks are the port's
    own ``print_epoch_block``'s, so the port's stdout stays scrapeable."""
    import contextlib
    import io
    import types

    from fashionvisualexpl_tpu_torch.eval.evaluator import print_epoch_block

    def epoch_block(vals_v, vals_t):
        rec = types.SimpleNamespace(
            metrics={**{m + "_v": v for m, v in zip(("hr", "p", "r", "auc", "ndcg"), vals_v)},
                     **{m + "_t": v for m, v in zip(("hr", "p", "r", "auc", "ndcg"), vals_t)}},
            train_time_s=1.0, eval_time_s=0.5,
        )
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            print_epoch_block(20, 1, 10, 0.123, rec)
        return buf.getvalue()

    log, best_v, best_t = reference_log(epoch_block)
    path = os.path.join(str(tmp_path), "bprmf-baby-lr0.001-emk128.log")
    with open(path, "w") as f:
        f.write(log)
    # a second log whose name lacks emk: that column floats with a None
    with open(os.path.join(str(tmp_path), "bprmf-baby-lr0.01.log"), "w") as f:
        f.write(log)

    rows = PL.scrape_reference_log(path, ("lr", "emk"), (0.0, 0.01))
    assert rows == JL.scrape_reference_log(path, ("lr", "emk"), (0.0, 0.01))
    assert len(rows) == 2
    r0 = rows[0]
    assert r0["lr"] == 0.001 and r0["emk"] == 128 and r0["reg"] == 0.0
    assert [r0[m + "_v"] for m in ("hr", "p", "r", "auc", "ndcg")] == best_v
    assert [r0[m + "_t"] for m in ("hr", "p", "r", "auc", "ndcg")] == best_t
    assert rows[1]["reg"] == 0.01 and rows[1]["hr_v"] == 0.2
    assert rows[1]["hr_t"] == 0.21

    pattern = os.path.join(str(tmp_path), "bprmf-baby*")
    got = PL.aggregate_reference(pattern, "ndcg_v", ("lr", "emk"), (0.0, 0.01))
    assert norm(got) == records(JL.aggregate_reference(pattern, "ndcg_v", ("lr", "emk"),
                                                       (0.0, 0.01)))
    assert len(got) == 4
    assert got[0]["ndcg_v"] == 0.25  # best-metric row sorts first
    outs = {}
    for side, main in (("jax", JL.main), ("port", PL.main)):
        out = str(tmp_path / f"{side}.tsv")
        main(["--format", "reference", "--logs_glob", pattern, "--out", out,
              "--regs", "0.0", "0.01"])
        outs[side] = open(out, "rb").read()
    assert outs["port"] == outs["jax"]


def test_copy_first_of_group(tmp_path):
    """fdupes-group parsing (copy_first_of_each_duplicates_group.py:
    group = consecutive ./lines, blank line separates; first of each
    copied), both tools on the same tree."""
    trees = {}
    for side, main in (("jax", JA.main), ("port", PA.main)):
        base = tmp_path / side / "data" / "dupes"
        img = base / "original" / "images"
        img.mkdir(parents=True)
        for name in ("a.jpg", "b.jpg", "c.jpg", "d.jpg", "e.jpg"):
            (img / name).write_bytes(name.encode())
        (base / "duplicates").write_text(
            "./a.jpg\n./b.jpg\n\n./c.jpg\n./d.jpg\n./e.jpg\n"
        )
        main(["copy_first_of_group", "--dataset", "dupes",
              "--data_root", str(tmp_path / side / "data")])
        trees[side] = tree_bytes(base)
        firsts = (base / "first_of_each").read_text().strip().split("\n")
        assert firsts == ["a.jpg", "c.jpg"]
        assert sorted(os.listdir(base / "duplicates_dir")) == ["a.jpg", "c.jpg"]
    assert trees["port"] == trees["jax"]


def test_copy_duplicates_and_check_k_core(tmp_path, capsys):
    """copy_duplicates on the same tree through both tools (all-digit ASINs
    read back as integers: the files they name lose their leading zero in
    both); check_k_core's counts."""
    trees = {}
    for side, main in (("jax", JA.main), ("port", PA.main)):
        base = tmp_path / side / "d"
        img = base / "original" / "images"
        img.mkdir(parents=True)
        (base / "all_items.csv").write_text(
            "ASIN,imUrl\n0100,http://u/1\n0200,http://u/1\n300,http://u/2\n"
            "400,http://u/2\n500,\n600,http://u/3\n")
        for name in ("100.jpg", "400.jpg", "0200.jpg"):
            (img / name).write_bytes(name.encode())
        (base / "all_interactions.tsv").write_text(
            "0\t1\t5\n0\t2\t6\n1\t1\t5\n2\t3\t1\n2\t1\t2\n2\t4\t2\n")
        main(["copy_duplicates", "--dataset", "d", "--data_root", str(tmp_path / side)])
        trees[side] = tree_bytes(base)
    assert trees["port"] == trees["jax"]
    assert sorted(k for k in trees["port"] if k.endswith(".jpg")) == [
        "original/images/0200.jpg", "original/images/100.jpg", "original/images/200.jpg",
        "original/images/300.jpg", "original/images/400.jpg"]
    capsys.readouterr()
    PA.main(["check_k_core", "--dataset", "d", "--data_root", str(tmp_path / "port")])
    out = capsys.readouterr().out.splitlines()
    assert out == ["interactions\tusers", "1\t1", "2\t1", "3\t1",
                   "min interactions per user: 1"]


def test_frames_match_pandas(tmp_path):
    """``utils/frames.py`` against pandas itself: DataFrame(records) typing
    and to_csv, read_csv typing (NA strings, digits, floats, bools), and
    sort_values' order with ties."""
    rows = [{"a": 1, "b": 0.5, "c": None, "d": "x", "t": True},
            {"a": 2, "e": 3, "c": 0.01, "d": None, "t": False},
            {"a": 3, "b": 1, "d": 'q"\tz', "t": True}]
    got = str(tmp_path / "p.tsv")
    fr.write_csv(fr.from_rows(rows), got, sep="\t")
    want = pd.DataFrame(rows).to_csv(sep="\t", index=False)
    assert open(got, newline="").read() == want
    src = tmp_path / "in.csv"
    src.write_text("i,f,s,n,b,z\n007,1.5,NA,5,True,1e3\n12,,b,null,False,-2\n"
                   "-3,2,c,6,True,.5\n")
    table, df = fr.read_csv(str(src)), pd.read_csv(src)
    assert list(table) == list(df.columns)
    assert norm(fr.to_rows(table)) == records(df)
    assert [str(table[c].dtype) for c in ("i", "f", "n", "b", "z")] == [
        str(df[c].dtype) for c in ("i", "f", "n", "b", "z")]
    vals = np.random.default_rng(0).integers(0, 4, 300)
    for dtype in (np.int64, np.float64):
        col = vals.astype(dtype)
        if dtype is np.float64:
            col[::7] = np.nan
        for asc in (True, False):
            want = pd.DataFrame({"v": col}).sort_values("v", ascending=asc).index.to_numpy()
            np.testing.assert_array_equal(fr.nargsort(col, asc), want)
