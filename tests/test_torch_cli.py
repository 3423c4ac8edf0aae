"""Port CLI (``cli/train_rec.py``, ``cli/serve_rec.py``,
``cli/get_explanations.py``) on a synthetic dataset in the reference's
on-disk layout, with ``--device cpu``.

The port's run writes the file set of one JAX CLI run on the same dataset:
the same names (the best epoch in ``best-recs-<E>`` is each run's own: the
two packages draw different inits), the same TSV format and row counts, the
same JSONL and results-pickle keys, and the checkpoint directory of the
same name.  Resume, the regularization sweep and serving from the
checkpoint run end to end; so do ``--train_path packed`` runs (the same
file set, resume byte-identical, the moment and row flags honoured);
so do ``--rec vbpr`` and ``--rec grad_fashion``, generic and packed with
fused frozen columns (the JAX run's file set, GradFashion's two grads
dumps with one row of two finite attributions per positive, ``serve_rec``
giving the best dump's recommendations), and ``get_explanations`` on a
GradFashion dump (the JAX CLI's rows); so does ``--rec acf`` over
per-item [H, W, C] spatial maps (generic with ``--acf_exact_eval
--acf_exact_train``, packed with the maps fused or read by id; the JAX
run's file set, ``serve_rec`` giving the best dump's recommendations);
so does ``--rec comp_vbpr`` with every family (the CNN on the edge tiffs)
and ablated to semantic + texture on the packed engine (the JAX run's
file set, ``serve_rec`` giving the best dump's recommendations);
``validate_args`` gives the JAX parser's messages; the options of later
slices raise; without ``--device`` and without a card the CLI raises."""

import glob
import json
import os
import pickle
import re
import shutil

import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.cli import train_rec as jcli
from fashionvisualexpl_tpu.data.synthetic_dataset import make_synthetic_dataset_on_disk
from fashionvisualexpl_tpu_torch.cli import train_rec as pcli
from fashionvisualexpl_tpu_torch.cli.serve_rec import serve

U, K_TOP = 20, 5


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset_on_disk(root, num_users=U, num_items=24, interactions_per_user=6,
                                   cnn_dim=16, with_images=False)
    return root


def _argv(root, results, extra=(), device=True):
    return ["--rec", "bprmf", "--dataset", "synthetic", "--data_root", root,
            "--results_root", os.path.join(root, results), "--epochs", "2",
            "--batch_size", "16", "--top_k", str(K_TOP), "--embed_k", "8",
            "--eval_user_block", "8", "--verbose", "1", *extra,
            *(["--device", "cpu"] if device else [])]


def _files(root, results):
    """{normalized relative name: path} of a run's results and weights."""
    out = {}
    base = os.path.join(root, results)
    for path in glob.glob(os.path.join(base, "rec_results", "**", "*"), recursive=True) + \
            glob.glob(os.path.join(base, "rec_model_weights", "*", "*", "*")):
        rel = os.path.relpath(path, base)
        if os.path.isfile(path) or "rec_model_weights" in rel:
            out[re.sub(r"best-(recs|grads)-\d+-", r"best-\1-E-", rel)] = path
    return out


@pytest.fixture(scope="module")
def jax_run(dataset_dir):
    jcli.train(_argv(dataset_dir, "jax", ("--streaming_eval",), device=False))
    return _files(dataset_dir, "jax")


def _check_tsv(path, rows):
    lines = open(path).read().strip().split("\n")
    assert len(lines) == rows
    for line in lines:
        u, i, s = line.split("\t")
        int(u), int(i), float(s)
    return lines


@pytest.mark.parametrize("streaming", [False, True], ids=["dense", "streaming"])
def test_cli_writes_the_jax_file_set(dataset_dir, jax_run, streaming):
    results = f"port-{int(streaming)}"
    pcli.train(_argv(dataset_dir, results, ("--streaming_eval",) if streaming else ()))
    port = _files(dataset_dir, results)
    assert sorted(port) == sorted(jax_run)
    for name, path in port.items():
        if name.endswith(".tsv"):
            _check_tsv(path, U * K_TOP)
            _check_tsv(jax_run[name], U * K_TOP)
        elif name.endswith(".jsonl"):
            got = [json.loads(line) for line in open(path)]
            want = [json.loads(line) for line in open(jax_run[name])]
            assert [sorted(r) for r in got] == [sorted(r) for r in want]
            assert all(0.0 <= r[m] <= 1.0 for r in got for m in r if m[-2:] in ("_v", "_t"))
        elif name.endswith(".pkl"):
            got, want = (pickle.load(open(p, "rb")) for p in (path, jax_run[name]))
            assert sorted(got) == sorted(want) == [1, 2]
            assert all(sorted(got[e]) == sorted(want[e]) for e in got)
    ckpt = [p for n, p in port.items() if "ckpt-" in n]
    assert len(ckpt) == 1 and sorted(os.listdir(ckpt[0])) == ["1", "2", "best-state"]


def test_cli_reg_sweep(dataset_dir):
    pcli.train(_argv(dataset_dir, "sweep", ("--list_of_regs", "0.0", "0.01")))
    rdir = os.path.join(dataset_dir, "sweep", "rec_results", "synthetic", "bprmf")
    assert len(glob.glob(os.path.join(rdir, "results-metrics-*reg_0.0.pkl"))) == 1
    assert len(glob.glob(os.path.join(rdir, "results-metrics-*reg_0.01.pkl"))) == 1
    assert len(glob.glob(os.path.join(rdir, "recs-2-*.tsv"))) == 2


def _resume_matches_uninterrupted(dataset_dir, results, packed=()):
    common = ("--verbose", "2", "--streaming_eval", *packed)
    rdir = os.path.join(dataset_dir, results, "rec_results", "synthetic", "bprmf")
    pcli.train(_argv(dataset_dir, results, common) + ["--epochs", "4"])
    full = open(glob.glob(os.path.join(rdir, "recs-4-*.tsv"))[0]).read()
    shutil.rmtree(os.path.join(dataset_dir, results))
    pcli.train(_argv(dataset_dir, results, common))
    pcli.train(_argv(dataset_dir, results, common) + ["--epochs", "4", "--resume"])
    assert open(glob.glob(os.path.join(rdir, "recs-4-*.tsv"))[0]).read() == full


def test_cli_resume_matches_uninterrupted(dataset_dir):
    """Interrupted at epoch 2 and resumed to 4 (``--verbose 2`` puts a
    checkpoint at the cut): the final dump is byte-identical to an
    uninterrupted 4-epoch run's."""
    _resume_matches_uninterrupted(dataset_dir, "resume")


def test_cli_packed_resume_matches_uninterrupted(dataset_dir):
    """The same on the packed path, with bf16 moments in 128-aligned rows."""
    _resume_matches_uninterrupted(dataset_dir, "resume-packed", (
        "--train_path", "packed", "--moment_dtype", "bfloat16", "--row_align", "128"))


@pytest.mark.parametrize("flags", [
    ("--moment_dtype", "float32"),
    ("--moment_dtype", "float8", "--row_align", "128", "--lazy_catchup", "0"),
], ids=["fp32", "fp8-aligned-no-catchup"])
def test_cli_packed_path_writes_the_jax_file_set(dataset_dir, jax_run, flags):
    """``--train_path packed``: the JAX run's file set, the flags reaching
    the packed state, and ``serve_rec`` from its checkpoint gives the best
    dump's recommendations."""
    from fashionvisualexpl_tpu_torch.core.checkpoint import STATE_FILE

    results = "packed-" + flags[1]
    pcli.train(_argv(dataset_dir, results, ("--streaming_eval", "--train_path", "packed",
                                            *flags)))
    port = _files(dataset_dir, results)
    assert sorted(port) == sorted(jax_run)
    for name, path in port.items():
        if name.endswith(".tsv"):
            _check_tsv(path, U * K_TOP)
    (ckpt,) = [p for n, p in port.items() if "ckpt-" in n]
    saved = torch.load(os.path.join(ckpt, "2", STATE_FILE), weights_only=True)
    assert saved["moment_dtype"] == flags[1]
    assert saved["inner/user_pmv"].shape[1] == (128 if "128" in flags else 8 + 16 + 1)
    base = os.path.join(dataset_dir, results)
    (best,) = glob.glob(os.path.join(base, "rec_results", "synthetic", "bprmf", "best-recs-*"))
    out = os.path.join(base, "served.tsv")
    serve(["--rec", "bprmf", "--dataset", "synthetic", "--data_root", dataset_dir,
           "--results_root", base, "--embed_k", "8", "--top_k", str(K_TOP), "--ckpt", ckpt,
           "--device", "cpu", "--users", "all", "--output", out])
    served, dumped = _check_tsv(out, U * K_TOP), _check_tsv(best, U * K_TOP)
    assert [r.split("\t")[:2] for r in served] == [r.split("\t")[:2] for r in dumped]


def test_cli_serve_from_checkpoint(dataset_dir):
    pcli.train(_argv(dataset_dir, "serve"))
    base = os.path.join(dataset_dir, "serve")
    (ckpt,) = glob.glob(os.path.join(base, "rec_model_weights", "synthetic", "bprmf", "ckpt-*"))
    (best,) = glob.glob(os.path.join(base, "rec_results", "synthetic", "bprmf", "best-recs-*"))
    common = ["--rec", "bprmf", "--dataset", "synthetic", "--data_root", dataset_dir,
              "--results_root", base, "--embed_k", "8", "--top_k", str(K_TOP),
              "--ckpt", ckpt, "--device", "cpu"]
    out = os.path.join(base, "served.tsv")
    serve(common + ["--users", "0,3,5", "--output", out])
    lines = _check_tsv(out, 3 * K_TOP)
    assert sorted({int(line.split("\t")[0]) for line in lines}) == [0, 3, 5]
    # the best params' recommendations: the dense best-recs dump's rows
    dumped = {(int(r[0]), int(r[1])): float(r[2]) for r in
              (line.split("\t") for line in open(best).read().strip().split("\n"))}
    for line in lines:
        u, i, s = line.split("\t")
        np.testing.assert_allclose(float(s), dumped[(int(u), int(i))], rtol=1e-5)
    out_q = os.path.join(base, "served_q.tsv")
    serve(common + ["--users", "0,3,5", "--output", out_q, "--quantized"])
    assert [line.split("\t")[:2] for line in _check_tsv(out_q, 3 * K_TOP)] == [
        line.split("\t")[:2] for line in lines]
    out_all = os.path.join(base, "served_all.tsv")
    serve(common + ["--users", "all", "--output", out_all])
    _check_tsv(out_all, U * K_TOP)


@pytest.mark.parametrize("argv", [
    ["--rec", "acf", "--acf_exact_train", "--train_path", "packed"],
    ["--rec", "bprmf", "--streamed"],
    ["--rec", "attentive_fashion", "--streamed", "--mesh_data", "2"],
    ["--rec", "comp_vbpr", "--activated_components", "1", "1"],
    ["--rec", "acf", "--layers_component", "4", "2"],
    ["--moment_dtype", "float8", "--mesh_model", "2"],
])
def test_validate_args_gives_the_jax_messages(argv):
    with pytest.raises(SystemExit) as jerr:
        jcli.validate_args(jcli.parse_args(argv))
    with pytest.raises(SystemExit) as perr:
        pcli.validate_args(pcli.parse_args(argv))
    assert str(perr.value) == str(jerr.value)


def test_packed_help_says_what_the_port_runs():
    """The packed flags' help names the port's one-device packed path and
    none of the JAX package's mesh or speed-up claims."""
    actions = {a.dest: a.help for a in pcli.build_parser()._actions}
    for dest in ("train_path", "moment_dtype", "row_align"):
        text = " ".join(actions[dest].split())
        assert "over the mesh" not in text and "2.5x" not in text, (dest, text)
        assert "TPU" not in text and "XLA" not in text, (dest, text)
    train_path = " ".join(actions["train_path"].split())
    assert "BPRMF and attentive_fashion on one device" in train_path
    assert "27.1 ms against 14.8 ms" in train_path


@pytest.mark.parametrize("extra,msg", [
    (("--train_path", "packed", "--mesh_data", "2", "--moment_dtype", "float8"),
     "float8 is single-device only"),
    (("--mesh_data", "2"), "needs 2 ranks, the process group has 1"),
])
def test_options_of_later_slices_raise(dataset_dir, extra, msg):
    """The mesh runs under torchrun (``tests/test_torch_multihost.py``); the
    refusals JAX has stay: float8 moments over a mesh, and a mesh that is
    not the world size."""
    with pytest.raises(SystemExit, match=msg):
        pcli.train(_argv(dataset_dir, "never", ()) + list(extra))
    assert not os.path.exists(os.path.join(dataset_dir, "never"))


def test_streamed_run_writes_the_resident_file_set_over_one_edge_stack(tmp_path):
    """``train_rec --rec attentive_fashion --streamed`` (8x8 edges): the
    file set of the resident run (its plain and attention dumps, metrics,
    log and checkpoints; ``--streamed`` changes only how the steps read
    their inputs; ``test_torch_cli_attentive.py`` holds that set to the JAX
    CLI's), the edge stack written once beside the tiffs and read as a
    memmap (a second run reuses it, with the same metrics), and a stack of
    another shape refused."""
    from fashionvisualexpl_tpu_torch.core.config import Paths

    root = str(tmp_path)
    make_synthetic_dataset_on_disk(root, num_users=12, num_items=14, interactions_per_user=4,
                                   cnn_dim=16, edge_hw=(12, 12), with_images=True)
    argv = ["--rec", "attentive_fashion", "--dataset", "synthetic", "--data_root", root,
            "--epochs", "2", "--batch_size", "8", "--top_k", "3", "--embed_k", "4",
            "--attention_layers", "4", "1", "--edge_hw", "8", "8", "--eval_user_block", "8",
            "--verbose", "1", "--device", "cpu"]
    pcli.train(argv + ["--results_root", os.path.join(root, "resident")])
    pcli.train(argv + ["--streamed", "--results_root", os.path.join(root, "port")])
    stack = Paths(root=root).edges_stack("synthetic")
    mtime = os.path.getmtime(stack)
    assert np.load(stack, mmap_mode="r").shape == (14, 8, 8, 1)
    port = _files(root, "port")
    want = {re.sub(r"best-att-recs-\d+-", "best-att-recs-E-", n)
            for n in _files(root, "resident")}
    assert {re.sub(r"best-att-recs-\d+-", "best-att-recs-E-", n) for n in port} == want
    assert sum("att-recs" in n for n in port) == 2
    pcli.train(argv + ["--streamed", "--results_root", os.path.join(root, "again")])
    assert os.path.getmtime(stack) == mtime

    def metrics(results):
        (pkl,) = glob.glob(os.path.join(root, results, "rec_results", "synthetic",
                                        "attentive_fashion", "results-metrics-*.pkl"))
        return pickle.load(open(pkl, "rb"))

    a, b = metrics("port"), metrics("again")
    assert sorted(a) == sorted(metrics("resident")) == [1, 2]
    for e in a:
        for k in a[e]:
            np.testing.assert_allclose(b[e][k], a[e][k], rtol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="remove it to rebuild"):
        pcli.train(argv + ["--streamed", "--edge_hw", "4", "4",
                           "--results_root", os.path.join(root, "other")])


def test_no_device_without_a_card_raises(dataset_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcli.train(_argv(dataset_dir, "nocard", device=False))


# --- VBPR and GradFashion ---------------------------------------------------

VISUAL = {"vbpr": ("--embed_d", "3"),
          "grad_fashion": ("--embed_d", "3", "--embed_color", "4", "--embed_edges", "5")}


def _visual_argv(root, results, rec, extra=(), device=True):
    return _argv(root, results, ("--streaming_eval", *extra), device) + [
        "--rec", rec, *VISUAL[rec]]


@pytest.fixture(scope="module")
def jax_visual_runs(dataset_dir):
    for rec in VISUAL:
        jcli.train(_visual_argv(dataset_dir, f"jax-{rec}", rec, device=False))
    return {rec: _files(dataset_dir, f"jax-{rec}") for rec in VISUAL}


def _positives(root):
    """[(user, item)] of every train, validation and test row, in the
    grads dump's order (user, then train, validation, test)."""
    from fashionvisualexpl_tpu_torch.core.config import Paths

    paths, rows = Paths(root=root), {}
    for split in (paths.training_set, paths.validation_set, paths.test_set):
        for line in open(split("synthetic")).read().strip().split("\n"):
            u, i = line.split("\t")[:2]
            rows.setdefault(int(u), []).append(int(i))
    return [(u, i) for u in sorted(rows) for i in rows[u]]


def _check_grads(path, pairs):
    lines = open(path).read().strip().split("\n")
    assert [tuple(map(int, line.split("\t")[:2])) for line in lines] == pairs
    vals = np.array([[float(x) for x in line.split("\t")[2:]] for line in lines])
    assert vals.shape == (len(pairs), 2) and np.isfinite(vals).all()


@pytest.mark.parametrize("train_path", ["generic", "packed"])
@pytest.mark.parametrize("rec", list(VISUAL))
def test_cli_visual_models_write_the_jax_file_set(dataset_dir, jax_visual_runs, rec,
                                                  train_path):
    """``--rec vbpr`` / ``grad_fashion`` (packed: fused frozen columns,
    the default): the JAX run's file set, dumps of U x k rows, the grads
    dumps, metrics in [0, 1]; ``serve_rec`` from the checkpoint gives the
    best dump's recommendations."""
    results = f"{rec}-{train_path}"
    pcli.train(_visual_argv(dataset_dir, results, rec, ("--train_path", train_path)))
    port = _files(dataset_dir, results)
    assert sorted(port) == sorted(jax_visual_runs[rec])
    pairs = _positives(dataset_dir)
    for name, path in port.items():
        if "grads-" in name:
            _check_grads(path, pairs)
        elif name.endswith(".tsv"):
            _check_tsv(path, U * K_TOP)
        elif name.endswith(".jsonl"):
            got = [json.loads(line) for line in open(path)]
            assert all(0.0 <= r[m] <= 1.0 for r in got for m in r if m[-2:] in ("_v", "_t"))
    if rec == "grad_fashion":
        assert sum("grads-" in name for name in port) == 2
    base = os.path.join(dataset_dir, results)
    (ckpt,) = [p for n, p in port.items() if "ckpt-" in n]
    (best,) = glob.glob(os.path.join(base, "rec_results", "synthetic", rec, "best-recs-*"))
    out = os.path.join(base, "served.tsv")
    serve(_visual_argv(dataset_dir, results, rec)
          + ["--ckpt", ckpt, "--users", "all", "--output", out])
    served, dumped = _check_tsv(out, U * K_TOP), _check_tsv(best, U * K_TOP)
    assert [r.split("\t")[:2] for r in served] == [r.split("\t")[:2] for r in dumped]


def test_cli_get_explanations_on_a_grad_fashion_dump(dataset_dir, jax_visual_runs):
    """The port's best grads dump joined with a review table by both
    CLIs: the same rows in the same order."""
    import pandas as pd

    from fashionvisualexpl_tpu.cli.get_explanations import main as jmain
    from fashionvisualexpl_tpu_torch.cli.get_explanations import main

    pcli.train(_visual_argv(dataset_dir, "explain", "grad_fashion"))
    pairs = _positives(dataset_dir)
    reviews = os.path.join(dataset_dir, "synthetic", "all_final.tsv")
    with open(reviews, "w") as f:
        f.write("USER_ID\tITEM_ID\tREVIEW\tTIME\n")
        for n, (u, i) in enumerate(pairs[::2]):
            f.write(f"{u}\t{i}\treview {n}\t{n}\n")
    rdir = os.path.join(dataset_dir, "explain", "rec_results", "synthetic", "grad_fashion")
    (dump,) = glob.glob(os.path.join(rdir, "best-grads-*"))
    outs = {}
    for name, fn in (("jax", jmain), ("port", main)):
        root = os.path.join(dataset_dir, f"explain-{name}")
        odir = os.path.join(root, "rec_results", "synthetic", "grad_fashion")
        os.makedirs(odir, exist_ok=True)
        shutil.copy(dump, odir)
        fn(["--dataset", "synthetic", "--file", os.path.basename(dump), "--top_n", "7",
            "--data_root", dataset_dir, "--results_root", root])
        outs[name] = odir
    for fname in ("color_reviews.tsv", "edges_reviews.tsv"):
        got = pd.read_csv(os.path.join(outs["port"], fname), sep="\t")
        want = pd.read_csv(os.path.join(outs["jax"], fname), sep="\t")
        assert list(got.columns) == list(want.columns) == [
            "USER_ID", "ITEM_ID", "COLOR", "EDGES", "REVIEW", "DIFF"]
        assert len(got) == 7
        for col in ("USER_ID", "ITEM_ID", "REVIEW"):
            assert got[col].tolist() == want[col].tolist(), (fname, col)
        for col in ("COLOR", "EDGES", "DIFF"):
            np.testing.assert_allclose(got[col], want[col], rtol=1e-12, atol=1e-15)
    os.remove(reviews)


# --- ACF ------------------------------------------------------------------

ACF_FLAGS = ("--rec", "acf", "--max_user_pos", "3", "--layers_component", "4", "1",
             "--layers_item", "4", "1", "--streaming_eval")


@pytest.fixture(scope="module")
def acf_dataset(dataset_dir):
    """The dataset with per-item 2x2x5 spatial maps ([H, W, C] .npy files,
    the extractor's layout) under ``cnn_features_split_dir``."""
    from fashionvisualexpl_tpu_torch.core.config import Paths

    sdir = Paths(root=dataset_dir).cnn_features_split_dir("synthetic", "vgg19", "fc2")
    os.makedirs(sdir, exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(24):
        np.save(os.path.join(sdir, f"{i}.npy"), rng.normal(size=(2, 2, 5)).astype(np.float32))
    return dataset_dir


@pytest.fixture(scope="module")
def jax_acf_run(acf_dataset):
    jcli.train(_argv(acf_dataset, "jax-acf", device=False)
               + [*ACF_FLAGS, "--acf_exact_eval", "--acf_exact_train"])
    return _files(acf_dataset, "jax-acf")


ACF_RUNS = {"exact": ("--acf_exact_eval", "--acf_exact_train"),
            "packed-fused": ("--train_path", "packed"),
            "packed-by-id": ("--train_path", "packed", "--fused_frozen", "0",
                             "--moment_dtype", "bfloat16")}


@pytest.mark.parametrize("run", list(ACF_RUNS))
def test_cli_acf_writes_the_jax_file_set(acf_dataset, jax_acf_run, run):
    """``--rec acf``: the JAX run's file set, dumps of U x k rows, metrics
    in [0, 1]; ``serve_rec`` from the checkpoint gives the best dump's
    recommendations."""
    results = f"acf-{run}"
    argv = _argv(acf_dataset, results) + [*ACF_FLAGS, *ACF_RUNS[run]]
    pcli.train(argv)
    port = _files(acf_dataset, results)
    assert sorted(port) == sorted(jax_acf_run)
    for name, path in port.items():
        if name.endswith(".tsv"):
            _check_tsv(path, U * K_TOP)
        elif name.endswith(".jsonl"):
            got = [json.loads(line) for line in open(path)]
            assert len(got) == 2
            assert all(0.0 <= r[m] <= 1.0 for r in got for m in r if m[-2:] in ("_v", "_t"))
    base = os.path.join(acf_dataset, results)
    (ckpt,) = [p for n, p in port.items() if "ckpt-" in n]
    (best,) = glob.glob(os.path.join(base, "rec_results", "synthetic", "acf", "best-recs-*"))
    out = os.path.join(base, "served.tsv")
    serve(argv + ["--ckpt", ckpt, "--users", "all", "--output", out])
    served, dumped = _check_tsv(out, U * K_TOP), _check_tsv(best, U * K_TOP)
    assert [r.split("\t")[:2] for r in served] == [r.split("\t")[:2] for r in dumped]


# --- CompVBPR ---------------------------------------------------------------

COMP_RUNS = {"all-families": ("--activated_components", "1", "1", "1", "1",
                              "--weight_components", "0.4", "0.2", "0.2", "0.2",
                              "--streaming_eval"),
             "ablated-packed": ("--activated_components", "1", "0", "0", "1",
                                "--train_path", "packed")}


@pytest.fixture(scope="module")
def comp_dataset(tmp_path_factory):
    """The reference layout with every family CompVBPR reads: vgg19 fc2
    features, color histograms, 16x16 edge tiffs, texture features."""
    root = str(tmp_path_factory.mktemp("comp"))
    make_synthetic_dataset_on_disk(root, num_users=U, num_items=24, interactions_per_user=6,
                                   cnn_dim=16, edge_hw=(16, 16), with_images=True)
    return root


def _comp_argv(root, results, extra, device=True):
    return _argv(root, results, ("--embed_d", "3", "--edge_hw", "12", "12", *extra),
                 device) + ["--rec", "comp_vbpr"]


@pytest.fixture(scope="module")
def jax_comp_run(comp_dataset):
    """The JAX CLI's file set for --rec comp_vbpr (the ablated run: the
    families change no file name)."""
    jcli.train(_comp_argv(comp_dataset, "jax-comp", COMP_RUNS["ablated-packed"][:5],
                          device=False))
    return _files(comp_dataset, "jax-comp")


@pytest.mark.parametrize("run", list(COMP_RUNS))
def test_cli_comp_vbpr_writes_the_jax_file_set(comp_dataset, jax_comp_run, run):
    """``--rec comp_vbpr`` with every family (the CNN on 12x12 edges,
    streaming evaluation) and ablated to semantic + texture on the packed
    engine: the JAX run's file set, dumps of U x k rows, metrics in [0, 1];
    ``serve_rec`` from the checkpoint gives the best dump's
    recommendations."""
    results = f"comp-{run}"
    argv = _comp_argv(comp_dataset, results, COMP_RUNS[run])
    pcli.train(argv)
    port = _files(comp_dataset, results)
    assert sorted(port) == sorted(jax_comp_run)
    for name, path in port.items():
        if name.endswith(".tsv"):
            _check_tsv(path, U * K_TOP)
        elif name.endswith(".jsonl"):
            got = [json.loads(line) for line in open(path)]
            assert len(got) == 2
            assert all(0.0 <= r[m] <= 1.0 for r in got for m in r if m[-2:] in ("_v", "_t"))
    base = os.path.join(comp_dataset, results)
    (ckpt,) = [p for n, p in port.items() if "ckpt-" in n]
    (best,) = glob.glob(os.path.join(base, "rec_results", "synthetic", "comp_vbpr",
                                     "best-recs-*"))
    out = os.path.join(base, "served.tsv")
    serve(argv + ["--ckpt", ckpt, "--users", "all", "--output", out])
    served, dumped = _check_tsv(out, U * K_TOP), _check_tsv(best, U * K_TOP)
    assert [r.split("\t")[:2] for r in served] == [r.split("\t")[:2] for r in dumped]


def test_cli_comp_vbpr_bf16_raises(comp_dataset):
    with pytest.raises(NotImplementedError, match="ROADMAP: bf16 encoder towers"):
        pcli.train(_comp_argv(comp_dataset, "never-bf16", ("--compute_dtype", "bfloat16")))
    assert not os.path.exists(os.path.join(comp_dataset, "never-bf16"))
