"""Port explanations (``explain/grads.py``, ``store_recommendation_grads``
of both evaluators, ``cli/get_explanations.py``) vs the JAX package and its
pandas, on the CPU, from JAX's GradFashion params carried across.

- ``batched_attributions`` (ragged positives over several power-of-two
  buckets, users without positives, blocks cut by ``user_block``) and the
  per-user path, both against JAX's batched engine (to which
  ``tests/test_grad_fashion.py`` pins JAX's per-user path): per user rtol
  1e-5, atol 1e-6 (JAX's pin);
- ``write_grads_tsv`` and both evaluators' ``store_recommendation_grads``:
  the same (user, item) rows in the same order as JAX's file, values rtol
  1e-5, atol 1e-6; ``explanation_table``: JAX's DataFrame's columns and
  dtypes, ids equal, values rtol 1e-5, atol 1e-6;
- ``join_reviews`` against JAX's pandas version: equal columns, rows and
  order, on tie-free DIFF and on tie-storm DIFF (pandas' quicksort order on
  ties is reproduced, NaN last), with clashing column names and dropped
  columns; ``read_tsv`` / ``write_tsv`` byte-equal to pandas' ``read_csv``
  / ``to_csv`` round trip where pandas parses the decimals exactly;
- ``get_explanations``: the JAX CLI's two files with equal columns, ids
  and reviews in the same order, values rtol 1e-12 (pandas' C parser may
  land an ulp away from the correctly rounded value)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fashionvisualexpl_tpu.data.features import synthetic_features
from fashionvisualexpl_tpu.data.interactions import Interactions as JInteractions
from fashionvisualexpl_tpu.eval.evaluator import Evaluator as JEvaluator
from fashionvisualexpl_tpu.explain import grads as jgrads
from fashionvisualexpl_tpu.models.grad_fashion import GradFashion as JGradFashion
from fashionvisualexpl_tpu_torch.data.interactions import Interactions
from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator
from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
from fashionvisualexpl_tpu_torch.explain import grads as tgrads
from fashionvisualexpl_tpu_torch.models.convert import grad_fashion_from_jax

ATT_TOL = dict(rtol=1e-5, atol=1e-6)
U, I = 70, 90


def ragged_lists(seed=0):
    """Training lists of 0 ... 40 items (several buckets, some users with no
    positive at all), one validation and one test item for most users."""
    rng = np.random.default_rng(seed)
    train, val, test = [], [], []
    for u in range(U):
        n = int(rng.integers(0, 41)) if u % 9 else 0
        items = rng.choice(I, n + 2, replace=False).tolist()
        empty = u % 9 == 0 and u % 2 == 0
        train.append(items[:n])
        val.append([] if empty else items[n:n + 1])
        test.append([] if empty else items[n + 1:])
    return train, test, val


@pytest.fixture(scope="module")
def case():
    lists = ragged_lists()
    jdata = JInteractions.from_lists(*lists[:2], I, lists[2])
    data = Interactions.from_lists(*lists[:2], I, lists[2])
    color = synthetic_features(I, 12, seed=1)
    edges = synthetic_features(I, 20, seed=2)
    jm = JGradFashion(U, I, color, edges, embed_k=8, embed_d=4, embed_color=5, embed_edges=6)
    params, frozen = jm.init(jax.random.PRNGKey(3))
    model = grad_fashion_from_jax({k: np.asarray(v) for k, v in params.items()}, color,
                                  edges, device="cpu")
    return jdata, data, jm, params, frozen, model


def block_fn(model):
    return lambda p, f, users, items: model.feature_attributions_block(users, items, params=p)


@pytest.mark.parametrize("user_block", [4, 512])
def test_batched_attributions_match_jax(case, user_block):
    jdata, data, jm, params, frozen, model = case
    want = jgrads.batched_attributions(jm.feature_attributions_block, params, frozen, jdata,
                                       user_block=user_block)
    got = tgrads.batched_attributions(block_fn(model), None, None, data,
                                      user_block=user_block, device="cpu")
    assert sorted(got) == sorted(want)
    assert 0 not in got and len({len(v) for v in got.values()}) > 8  # ragged, empty
    for u in want:
        assert got[u].dtype == np.float32
        np.testing.assert_allclose(got[u], want[u], err_msg=str(u), **ATT_TOL)


def read_grads(path):
    rows = [line.split("\t") for line in open(path).read().strip().split("\n")]
    return (np.array([[int(r[0]), int(r[1])] for r in rows]),
            np.array([[float(r[2]), float(r[3])] for r in rows]))


def assert_same_grads_file(got_path, want_path):
    got_ids, got = read_grads(got_path)
    want_ids, want = read_grads(want_path)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got, want, **ATT_TOL)


@pytest.mark.parametrize("engine", ["batched", "per_user"])
def test_write_grads_tsv_matches_jax(case, engine, tmp_path):
    jdata, data, jm, params, frozen, model = case
    # JAX's batched engine (tests/test_grad_fashion.py pins its per-user
    # loop to it; run eagerly here that loop takes ~50 s)
    jgrads.write_grads_tsv(str(tmp_path / "jax.tsv"), jdata, params, frozen,
                           batch_grads_fn=jm.feature_attributions_block)
    kw = ({"batch_grads_fn": block_fn(model)} if engine == "batched" else
          {"grads_fn": lambda p, f, u, i: model.feature_attributions(u, i, params=p)})
    tgrads.write_grads_tsv(str(tmp_path / "port.tsv"), data, None, None, device="cpu", **kw)
    assert_same_grads_file(tmp_path / "port.tsv", tmp_path / "jax.tsv")
    n = sum(len(a) + len(b) + len(c) for a, b, c in zip(data.training_list,
                                                         data.validation_list, data.test_list))
    assert len(open(tmp_path / "port.tsv").read().strip().split("\n")) == n
    with pytest.raises(ValueError, match="grads_fn"):
        tgrads.write_grads_tsv(str(tmp_path / "x.tsv"), data, None, None, device="cpu")


@pytest.mark.parametrize("evaluator", ["dense", "factored"])
def test_store_recommendation_grads_matches_jax(case, evaluator, tmp_path):
    jdata, data, jm, params, frozen, model = case
    JEvaluator(jm, jdata, k=5).store_recommendation_grads(
        params, frozen, str(tmp_path / "jax.tsv"), batch_grads_fn=jm.feature_attributions_block)
    ev = (Evaluator if evaluator == "dense" else FactoredEvaluator)(model, data, k=5)
    doubled = {k: v.detach() * 2 for k, v in model.named_parameters()}
    ev.store_recommendation_grads(doubled, None, str(tmp_path / "port.tsv"),
                                  batch_grads_fn=block_fn(model))
    JEvaluator(jm, jdata, k=5).store_recommendation_grads(
        {k: v * 2 for k, v in params.items()}, frozen, str(tmp_path / "jax2.tsv"),
        batch_grads_fn=jm.feature_attributions_block)
    assert_same_grads_file(tmp_path / "port.tsv", tmp_path / "jax2.tsv")
    ev.store_recommendation_grads(None, None, str(tmp_path / "own.tsv"),
                                  grads_fn=lambda p, f, u, i: model.feature_attributions(u, i))
    assert_same_grads_file(tmp_path / "own.tsv", tmp_path / "jax.tsv")


@pytest.mark.parametrize("batched", [True, False])
def test_explanation_table_matches_jax(case, batched):
    jdata, data, jm, params, frozen, model = case
    want = jgrads.explanation_table(jm, params, frozen, jdata)  # batched, as above
    got = tgrads.explanation_table(model, None, None, data, batched=batched)
    assert list(got) == list(want.columns) == list(tgrads.COLUMNS)
    for col in want.columns:
        assert got[col].dtype == want[col].dtype, col
    for col in ("USER_ID", "ITEM_ID"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy())
    for col in ("COLOR", "EDGES"):
        np.testing.assert_allclose(got[col], want[col].to_numpy(), **ATT_TOL)


def review_tables(seed, ties):
    """(grads, reviews) as column mappings: duplicate keys on both sides,
    keys missing on either side, a clashing column name (X), columns the
    join drops (TIME, ASIN), and DIFF with ties (and a NaN) or tie-free."""
    rng = np.random.default_rng(seed)
    n, m = 300, 260
    g = {"USER_ID": rng.integers(0, 30, n), "ITEM_ID": rng.integers(0, 12, n)}
    if ties:
        g["COLOR"] = rng.integers(0, 5, n) * 0.5
        g["EDGES"] = rng.integers(0, 5, n) * 0.25
        g["COLOR"][7] = np.nan
    else:
        g["COLOR"], g["EDGES"] = rng.normal(size=n), rng.normal(size=n)
    g["X"] = rng.random(n)
    r = {"ITEM_ID": rng.integers(0, 12, m), "USER_ID": rng.integers(0, 30, m),
         "REVIEW": np.array([f"review {i}, \"quoted\"" for i in range(m)], dtype=object),
         "TIME": rng.integers(0, 9, m), "X": rng.random(m),
         "ASIN": np.array([f"B{i:05d}" for i in range(m)], dtype=object)}
    return g, r


@pytest.mark.parametrize("ties", [False, True], ids=["tie-free", "ties"])
@pytest.mark.parametrize("top_n", [5, 50, 10_000])
def test_join_reviews_matches_pandas(ties, top_n):
    g, r = review_tables(seed=top_n, ties=ties)
    want = jgrads.join_reviews(pd.DataFrame(g), pd.DataFrame(r), top_n=top_n)
    got = tgrads.join_reviews(g, r, top_n=top_n)
    for a, b in zip(got, want):
        assert list(a) == list(b.columns)
        assert "TIME" not in a and "ASIN" not in a and "X_x" in a and "X_y" in a
        for col in b.columns:
            np.testing.assert_array_equal(a[col], b[col].to_numpy(), err_msg=col)
    if ties:
        assert len(set(got[0]["DIFF"][:5].tolist())) < 5  # the order on ties was tested


def test_read_and_write_tsv_round_trip_as_pandas(tmp_path):
    g, r = review_tables(seed=1, ties=True)
    table = tgrads.join_reviews(g, r, top_n=40)[0]
    tgrads.write_tsv(table, str(tmp_path / "port.tsv"))
    pd.DataFrame(table).to_csv(tmp_path / "pandas.tsv", sep="\t", index=False)
    assert open(tmp_path / "port.tsv").read() == open(tmp_path / "pandas.tsv").read()
    back = tgrads.read_tsv(str(tmp_path / "port.tsv"))
    want = pd.read_csv(tmp_path / "port.tsv", sep="\t")
    assert list(back) == list(want.columns)
    for col in want.columns:
        if want[col].dtype.kind in "if":
            assert back[col].dtype == want[col].dtype, col
            np.testing.assert_allclose(back[col], want[col].to_numpy(), rtol=1e-12)
        else:
            assert back[col].tolist() == want[col].tolist(), col


def test_get_explanations_writes_the_jax_files(tmp_path):
    """``tests/test_cli.py::test_cli_get_explanations``'s input through both
    CLIs."""
    from fashionvisualexpl_tpu.cli.get_explanations import main as jmain
    from fashionvisualexpl_tpu_torch.cli.get_explanations import main

    root = str(tmp_path)
    os.makedirs(os.path.join(root, "mini"))
    with open(os.path.join(root, "mini", "all_final.tsv"), "w") as f:
        f.write("USER_ID\tITEM_ID\tREVIEW\n")
        for u in range(3):
            for i in range(4):
                f.write(f"{u}\t{i}\treview u{u} i{i}\n")
    outs = {}
    for name, fn in (("jax", jmain), ("port", main)):
        rdir = os.path.join(root, name, "rec_results", "mini", "grad_fashion")
        os.makedirs(rdir)
        with open(os.path.join(rdir, "grads.tsv"), "w") as f:
            for u in range(3):
                for i in range(4):
                    f.write(f"{u}\t{i}\t{0.1 * (i - u)}\t{0.05 * u}\n")
        fn(["--dataset", "mini", "--rec", "grad_fashion", "--file", "grads.tsv",
            "--top_n", "5", "--data_root", root, "--results_root", os.path.join(root, name)])
        outs[name] = rdir
    for fname in ("color_reviews.tsv", "edges_reviews.tsv"):
        got = pd.read_csv(os.path.join(outs["port"], fname), sep="\t")
        want = pd.read_csv(os.path.join(outs["jax"], fname), sep="\t")
        assert list(got.columns) == list(want.columns) == [
            "USER_ID", "ITEM_ID", "COLOR", "EDGES", "REVIEW", "DIFF"]
        assert len(got) == 5
        for col in ("USER_ID", "ITEM_ID", "REVIEW"):
            assert got[col].tolist() == want[col].tolist(), (fname, col)
        for col in ("COLOR", "EDGES", "DIFF"):
            np.testing.assert_allclose(got[col], want[col], rtol=1e-12, atol=1e-15)


def test_attributions_run_on_the_models_device(case):
    """Ids go to the device given; without one they go to the card, which
    raises here."""
    _, data, _, _, _, model = case
    seen = []

    def fn(p, f, users, items):
        seen.append((users.device.type, items.dtype))
        return model.feature_attributions_block(users, items)

    tgrads.batched_attributions(fn, None, None, data, device="cpu")
    assert set(seen) == {("cpu", torch.int32)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tgrads.batched_attributions(fn, None, None, data)
