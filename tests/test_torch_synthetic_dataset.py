"""Port dataset writer (``data/synthetic_dataset.py``) and profiling
utilities (``utils/profiling.py``) on the CPU.

- ``write_reference_layout`` / ``make_synthetic_dataset_on_disk``: the tree
  on disk byte-equal to the JAX package's for the same seed and options
  (every split TSV, feature matrix, per-item file and edge tiff), and the
  port's ``train_rec`` reads it;
- ``StepTimer`` as ``tests/test_api_surface.py::test_step_timer``;
  ``annotate`` labels a range in a ``torch.profiler`` capture; ``trace``
  writes a Chrome trace file holding that label."""

import json
import os
import time

import pytest

from fashionvisualexpl_tpu.data import synthetic_dataset as JD
from fashionvisualexpl_tpu_torch.data import synthetic_dataset as PD
from fashionvisualexpl_tpu_torch.utils import profiling as P


def tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("kw", [
    {},
    dict(num_users=17, num_items=23, interactions_per_user=5, seed=3, cnn_dim=32,
         cnn_model="resnet50", output_layer="avg_pool", num_classes=4, edge_hw=(8, 12),
         spatial=(3, 5)),
    dict(seed=1, with_images=False),
], ids=["defaults", "options", "no-images"])
def test_synthetic_dataset_tree_byte_equal(tmp_path, kw):
    roots = {}
    for side, mod in (("jax", JD), ("port", PD)):
        root = str(tmp_path / side)
        paths, data = mod.make_synthetic_dataset_on_disk(root, dataset="syn", **kw)
        assert paths.root == root and paths.results_root == os.path.join(root, "results")
        roots[side] = (root, data)
    got, want = (tree_bytes(roots[s][0]) for s in ("port", "jax"))
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    jdata, pdata = roots["jax"][1], roots["port"][1]
    assert pdata.training_list == jdata.training_list
    assert pdata.test_list == jdata.test_list
    assert len(want) >= 9 + 2 * jdata.num_items  # the matrices, splits and per-item files


def test_train_rec_reads_the_written_dataset(tmp_path):
    """The port's CLI trains VBPR on the port's dataset writer's files."""
    from fashionvisualexpl_tpu_torch.cli.train_rec import train

    root = str(tmp_path)
    paths, data = PD.make_synthetic_dataset_on_disk(root, dataset="syn", with_images=False)
    train(["--rec", "vbpr", "--dataset", "syn", "--data_root", root, "--results_root",
           paths.results_root, "--epochs", "1", "--embed_k", "4", "--embed_d", "2",
           "--batch_size", "32", "--device", "cpu"])
    rdir = os.path.join(paths.results_root, "rec_results", "syn", "vbpr")
    dumps = [f for f in os.listdir(rdir) if f.startswith("best-recs-")]
    assert len(dumps) == 1
    with open(os.path.join(rdir, dumps[0])) as f:
        assert len(f.readlines()) == data.num_users * 20  # --top_k's default


def test_step_timer():
    t = P.StepTimer()
    time.sleep(0.01)
    t.lap("a")
    time.sleep(0.02)
    t.lap("b")
    t.lap("a")
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["b"]["total_s"] >= 0.015
    assert s["a"]["mean_s"] == pytest.approx(s["a"]["total_s"] / 2)


def test_trace_and_annotate(tmp_path):
    import torch

    logdir = str(tmp_path / "trace")
    with P.trace(logdir) as prof:
        with P.annotate("score_block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert "score_block" in {e.key for e in prof.key_averages()}
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "score_block" for e in events)
