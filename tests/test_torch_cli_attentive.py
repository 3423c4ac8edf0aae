"""Port CLI with ``--rec attentive_fashion`` (``cli/train_rec.py``,
``cli/serve_rec.py``) on the JAX package's synthetic dataset with edge
images, ``--device cpu``.

The port's run writes the file set of the JAX CLI's run (both attention
dumps included, U x k rows each, six columns whose weights sum to 1);
``--batch_eval 7`` blocks the item encoding without changing the metrics
(``tests/test_cli.py::test_cli_batch_eval_honored``); ``serve_rec`` serves
the best params through the direct path, with the best dump's scores
(also after ``--train_path packed``, whose run writes the same file set);
``--streamed`` (the edge stack built as a memmap beside the tiffs, the
streamed trainer) writes the same file set, its metrics those of
``fit_streamed`` over the tiffs' stack in memory (rtol 1e-6), and
``serve_rec --streamed`` serves its best dump; ``--compute_dtype bfloat16``
on the generic, packed and streamed paths writes the same file set and
serves its best dump."""

import glob
import os
import pickle
import re

import numpy as np
import pytest

from fashionvisualexpl_tpu.cli import train_rec as jcli
from fashionvisualexpl_tpu.data.synthetic_dataset import make_synthetic_dataset_on_disk
from fashionvisualexpl_tpu_torch.cli import train_rec as pcli
from fashionvisualexpl_tpu_torch.cli.serve_rec import serve

U, K_TOP = 16, 4


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("af_cli"))
    make_synthetic_dataset_on_disk(root, num_users=U, num_items=20, interactions_per_user=5,
                                   cnn_dim=16, edge_hw=(16, 16), with_images=True)
    return root


def _argv(root, results, extra=(), device=True):
    return ["--rec", "attentive_fashion", "--dataset", "synthetic", "--data_root", root,
            "--results_root", os.path.join(root, results), "--epochs", "2",
            "--batch_size", "16", "--top_k", str(K_TOP), "--embed_k", "8",
            "--attention_layers", "4", "1", "--edge_hw", "8", "8",
            "--eval_user_block", "8", "--verbose", "1", *extra,
            *(["--device", "cpu"] if device else [])]


def _files(root, results):
    base = os.path.join(root, results)
    out = {}
    for path in glob.glob(os.path.join(base, "rec_results", "**", "*"), recursive=True) + \
            glob.glob(os.path.join(base, "rec_model_weights", "*", "*", "*")):
        rel = os.path.relpath(path, base)
        if os.path.isfile(path) or "rec_model_weights" in rel:
            out[re.sub(r"best-(att-)?recs-\d+-", r"best-\1recs-E-", rel)] = path
    return out


def _rows(path, cols):
    lines = open(path).read().strip().split("\n")
    assert len(lines) == U * K_TOP
    rows = [line.split("\t") for line in lines]
    assert {len(r) for r in rows} == {cols}
    return rows


def _metrics(root, results):
    (pkl,) = glob.glob(os.path.join(root, results, "rec_results", "synthetic",
                                    "attentive_fashion", "results-metrics-*.pkl"))
    return pickle.load(open(pkl, "rb"))


@pytest.fixture(scope="module")
def jax_run(dataset_dir):
    jcli.train(_argv(dataset_dir, "jax", ("--streaming_eval",), device=False))
    return _files(dataset_dir, "jax")


def test_cli_writes_the_jax_file_set(dataset_dir, jax_run):
    pcli.train(_argv(dataset_dir, "port", ("--streaming_eval",)))
    port = _files(dataset_dir, "port")
    assert sorted(port) == sorted(jax_run)
    assert sum("att-recs" in n for n in port) == 2
    for name, path in port.items():
        if name.endswith(".tsv"):
            cols = 6 if "att-recs" in name else 3
            rows = _rows(path, cols)
            _rows(jax_run[name], cols)
            if cols == 6:
                alphas = np.asarray([[float(x) for x in r[3:]] for r in rows])
                np.testing.assert_allclose(alphas.sum(1), 1.0, rtol=1e-5)
    got, want = _metrics(dataset_dir, "port"), _metrics(dataset_dir, "jax")
    assert sorted(got) == sorted(want) == [1, 2]
    for e in got:
        assert sorted(got[e]) == sorted(want[e])
        assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in got[e].values())
    ckpt = [p for n, p in port.items() if "ckpt-" in n]
    assert len(ckpt) == 1 and sorted(os.listdir(ckpt[0])) == ["1", "2", "best-state"]


def test_cli_batch_eval_leaves_metrics_unchanged(dataset_dir):
    pcli.train(_argv(dataset_dir, "be-all"))
    pcli.train(_argv(dataset_dir, "be-7", ("--batch_eval", "7")))
    a, b = _metrics(dataset_dir, "be-all"), _metrics(dataset_dir, "be-7")
    for e in a:
        for k in a[e]:
            np.testing.assert_allclose(b[e][k], a[e][k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_cli_serve_from_checkpoint(dataset_dir):
    pcli.train(_argv(dataset_dir, "serve"))
    base = os.path.join(dataset_dir, "serve")
    (ckpt,) = glob.glob(os.path.join(base, "rec_model_weights", "synthetic",
                                     "attentive_fashion", "ckpt-*"))
    (best,) = glob.glob(os.path.join(base, "rec_results", "synthetic", "attentive_fashion",
                                     "best-recs-*"))
    out = os.path.join(base, "served.tsv")
    serve(_argv(dataset_dir, "serve") + ["--ckpt", ckpt, "--users", "all", "--output", out])
    served = _rows(out, 3)
    dumped = _rows(best, 3)
    assert [r[:2] for r in served] == [r[:2] for r in dumped]
    np.testing.assert_allclose([float(r[2]) for r in served],
                               [float(r[2]) for r in dumped], rtol=1e-5, atol=1e-7)


def test_cli_streamed_writes_the_jax_file_set_and_serves(dataset_dir, jax_run):
    """``--streamed``: the JAX CLI's file set (which ``--streamed`` leaves
    as it is) and both attention dumps; the edge stack built beside the
    tiffs; the metrics of ``fit_streamed`` on the same config over the
    tiffs' stack in memory; ``serve_rec --streamed`` from the checkpoint
    serves the best dump's recommendations."""
    from fashionvisualexpl_tpu_torch.core.config import Paths, TrainConfig
    from fashionvisualexpl_tpu_torch.data.features import (
        load_class_onehot,
        load_color_histograms,
    )
    from fashionvisualexpl_tpu_torch.data.interactions import Interactions
    from fashionvisualexpl_tpu_torch.data.pipeline import load_edge_image_stack
    from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
    from fashionvisualexpl_tpu_torch.train.streamed import ArrayFeatureStore, fit_streamed

    argv = _argv(dataset_dir, "streamed", ("--streamed",))
    pcli.train(argv)
    paths = Paths(root=dataset_dir)
    stack = np.load(paths.edges_stack("synthetic"), mmap_mode="r")
    edges = load_edge_image_stack(paths.edges_dir("synthetic"), 20, hw=(8, 8))
    np.testing.assert_array_equal(stack, edges)
    port = _files(dataset_dir, "streamed")
    assert sorted(port) == sorted(jax_run)
    for name, path in port.items():
        if name.endswith(".tsv"):
            rows = _rows(path, 6 if "att-recs" in name else 3)
            if "att-recs" in name:
                alphas = np.asarray([[float(x) for x in r[3:]] for r in rows])
                np.testing.assert_allclose(alphas.sum(1), 1.0, rtol=1e-5)
    # the same run in process, the edge stack in memory
    cfg = TrainConfig(dataset="synthetic", batch_size=16, epochs=2, top_k=K_TOP, verbose=1,
                      lr=0.001, reg=0.0, paths=paths)
    data = Interactions.load(cfg)
    inputs = (load_color_histograms(paths, "synthetic"), edges,
              load_class_onehot(paths, "synthetic"))
    model = AttentiveFashion(U, 20, *inputs, embed_k=8, attention_layers=(4, 1),
                             batch_eval=128, host_features=True, device="cpu")
    _, _, want, _ = fit_streamed(model, data, cfg, ArrayFeatureStore(*inputs),
                                 evaluator=Evaluator(model, data, k=K_TOP, user_block=8))
    got = _metrics(dataset_dir, "streamed")
    assert sorted(got) == sorted(want) == [1, 2]
    for e in got:
        assert sorted(got[e]) == sorted(want[e])
        for k in got[e]:
            np.testing.assert_allclose(got[e][k], want[e][k], rtol=1e-6, err_msg=k)
    base = os.path.join(dataset_dir, "streamed")
    (ckpt,) = glob.glob(os.path.join(base, "rec_model_weights", "synthetic",
                                     "attentive_fashion", "ckpt-*"))
    (best,) = glob.glob(os.path.join(base, "rec_results", "synthetic", "attentive_fashion",
                                     "best-recs-*"))
    out = os.path.join(base, "served.tsv")
    serve(argv + ["--ckpt", ckpt, "--users", "all", "--output", out])
    served, dumped = _rows(out, 3), _rows(best, 3)
    assert [r[:2] for r in served] == [r[:2] for r in dumped]
    np.testing.assert_allclose([float(r[2]) for r in served],
                               [float(r[2]) for r in dumped], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("extra", [(), ("--train_path", "packed"), ("--streamed",)],
                         ids=["generic", "packed", "streamed"])
def test_cli_bf16_writes_the_jax_file_set_and_serves(dataset_dir, jax_run, extra):
    """``--compute_dtype bfloat16`` on the generic, packed and streamed
    paths: the JAX CLI's file set (the dtype names no file), both attention
    dumps, metrics in [0, 1], and ``serve_rec`` from the checkpoint gives
    the best dump's recommendations."""
    results = "bf16-" + "-".join(a.strip("-") for a in extra)
    argv = _argv(dataset_dir, results, ("--compute_dtype", "bfloat16", "--streaming_eval",
                                        *extra))
    pcli.train(argv)
    port = _files(dataset_dir, results)
    assert sorted(port) == sorted(jax_run)
    for name, path in port.items():
        if name.endswith(".tsv"):
            rows = _rows(path, 6 if "att-recs" in name else 3)
            if "att-recs" in name:
                alphas = np.asarray([[float(x) for x in r[3:]] for r in rows])
                np.testing.assert_allclose(alphas.sum(1), 1.0, rtol=1e-5)
    metrics = _metrics(dataset_dir, results)
    assert sorted(metrics) == [1, 2]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for m in metrics.values()
               for v in m.values())
    base = os.path.join(dataset_dir, results)
    (ckpt,) = glob.glob(os.path.join(base, "rec_model_weights", "synthetic",
                                     "attentive_fashion", "ckpt-*"))
    (best,) = glob.glob(os.path.join(base, "rec_results", "synthetic", "attentive_fashion",
                                     "best-recs-*"))
    out = os.path.join(base, "served.tsv")
    serve(argv + ["--ckpt", ckpt, "--users", "all", "--output", out])
    served, dumped = _rows(out, 3), _rows(best, 3)
    assert [r[:2] for r in served] == [r[:2] for r in dumped]
    np.testing.assert_allclose([float(r[2]) for r in served],
                               [float(r[2]) for r in dumped], rtol=1e-5, atol=1e-7)


def test_cli_packed_path_writes_the_file_set_and_serves(dataset_dir):
    """``--train_path packed`` (float8 moments, rows padded to 128): the
    file set of the generic run, both attention dumps, and ``serve_rec``
    from its checkpoint gives the best dump's recommendations."""
    extra = ("--train_path", "packed", "--moment_dtype", "float8", "--row_align", "128")
    pcli.train(_argv(dataset_dir, "packed", extra))
    pcli.train(_argv(dataset_dir, "generic"))
    port = _files(dataset_dir, "packed")
    assert sorted(port) == sorted(_files(dataset_dir, "generic"))
    for name, path in port.items():
        if name.endswith(".tsv"):
            rows = _rows(path, 6 if "att-recs" in name else 3)
            if "att-recs" in name:
                alphas = np.asarray([[float(x) for x in r[3:]] for r in rows])
                np.testing.assert_allclose(alphas.sum(1), 1.0, rtol=1e-5)
    metrics = _metrics(dataset_dir, "packed")
    assert sorted(metrics) == [1, 2]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for m in metrics.values()
               for v in m.values())
    base = os.path.join(dataset_dir, "packed")
    (ckpt,) = glob.glob(os.path.join(base, "rec_model_weights", "synthetic",
                                     "attentive_fashion", "ckpt-*"))
    (best,) = glob.glob(os.path.join(base, "rec_results", "synthetic", "attentive_fashion",
                                     "best-recs-*"))
    out = os.path.join(base, "served.tsv")
    serve(_argv(dataset_dir, "packed") + ["--ckpt", ckpt, "--users", "all", "--output", out])
    served, dumped = _rows(out, 3), _rows(best, 3)
    assert [r[:2] for r in served] == [r[:2] for r in dumped]
    np.testing.assert_allclose([float(r[2]) for r in served],
                               [float(r[2]) for r in dumped], rtol=1e-5, atol=1e-7)
