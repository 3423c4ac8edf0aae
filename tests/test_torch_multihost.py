"""Port ``parallel/multihost.py`` and ``train_rec --mesh_data/--mesh_model``
on the CPU, over gloo: ranks spawned as fresh interpreters that form their
group through ``initialize_from_env`` (a ``file://`` coordinator, no TCP
port), all meshes' ranks started together (``tests/torch_mesh_ranks.py``).

- two processes equal one (the JAX package's ``tests/test_multihost.py``):
  a sharded VBPR epoch (``make_spmd_epoch_fn``, every rank drawing the
  global batch from the same seed) gives the same loss on every rank of a
  (2, 1) and a (2, 2) mesh and on one process, rtol 1e-5;
- ``train_rec --mesh_data 2 --mesh_model 2`` (generic, ``--streaming_eval``)
  and ``--mesh_data 1 --mesh_model 2 --train_path packed --moment_dtype
  bfloat16``: the primary writes the JAX CLI run's file set (checkpoints
  "1", "2" and "best-state" in the single-device layout), the metrics of
  each epoch those of the port's single-device run with the same flags
  (``tests/test_golden.py``'s tolerances), and ``serve_rec`` on one device
  from the mesh run's checkpoint serves the best dump's recommendations;
- ``initialize_from_env`` without a group to form, ``is_primary``,
  ``global_mesh`` against the world size, and the CLI's refusals of a mesh
  that is not the world size and of float8 moments or ``--streamed`` over
  a mesh."""

import glob
import os
import pickle

import numpy as np
import pytest

import torch_mesh_ranks as ranks
from fashionvisualexpl_tpu.cli import train_rec as jcli
from fashionvisualexpl_tpu.data.features import synthetic_features
from fashionvisualexpl_tpu.data.synthetic_dataset import make_synthetic_dataset_on_disk
from fashionvisualexpl_tpu.models.vbpr import VBPR as JVBPR
from fashionvisualexpl_tpu_torch.cli import train_rec as pcli
from fashionvisualexpl_tpu_torch.cli.serve_rec import serve
from fashionvisualexpl_tpu_torch.parallel import multihost

import jax

U, K_TOP = 20, 5
METRIC_TOL = dict(rtol=2e-3, atol=2e-4)
CLI_RUNS = {"mesh22": ((2, 2), ("--streaming_eval", "--mesh_data", "2", "--mesh_model", "2")),
            "packed12": ((1, 2), ("--streaming_eval", "--mesh_data", "1", "--mesh_model", "2",
                                  "--train_path", "packed", "--moment_dtype", "bfloat16"))}


def _argv(root, results, extra=(), device=True):
    return ["--rec", "bprmf", "--dataset", "synthetic", "--data_root", root,
            "--results_root", os.path.join(root, results), "--epochs", "2",
            "--batch_size", "16", "--top_k", str(K_TOP), "--embed_k", "8",
            "--eval_user_block", "8", "--verbose", "1", *extra,
            *(["--device", "cpu"] if device else [])]


def _files(base):
    """The run's result and weight files, the best epoch's number masked."""
    import re

    out = {}
    for path in glob.glob(os.path.join(base, "rec_results", "**", "*"), recursive=True) + \
            glob.glob(os.path.join(base, "rec_model_weights", "*", "*", "*")):
        rel = os.path.relpath(path, base)
        if os.path.isfile(path) or "rec_model_weights" in rel:
            out[re.sub(r"best-recs-\d+-", "best-recs-E-", rel)] = path
    return out


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset_on_disk(root, num_users=U, num_items=24, interactions_per_user=6,
                                   cnn_dim=16, with_images=False)
    return root


@pytest.fixture(scope="module")
def runs(dataset_dir, tmp_path_factory):
    """Every spawn of this file, started together."""
    feats = synthetic_features(128, 32, seed=0)
    params = {k: np.asarray(v) for k, v in
              JVBPR(64, 128, feats, embed_k=16, embed_d=4).init(jax.random.PRNGKey(0))[0].items()}
    data = {"U": 64, "I": 128, "ipu": 6, "seed": 0}
    jobs = {}
    for shape in ((1, 1), (2, 1), (2, 2), (1, 2)):
        wd = str(tmp_path_factory.mktemp(f"mh{shape[0]}x{shape[1]}"))
        names = []
        if shape != (1, 2):
            ranks.write_inputs(wd, "epoch", dict(fn="vbpr_epoch", model="vbpr", data=data),
                               **{f"p.{k}": v for k, v in params.items()}, **{"f.F": feats})
            names.append("epoch")
        for label, (sh, extra) in CLI_RUNS.items():
            if sh == shape:
                ranks.write_inputs(wd, label, dict(fn="cli_run",
                                                   argv=_argv(dataset_dir, label, extra)))
                names.append(label)
        jobs[shape] = (wd, names)
    return ranks.spawn_many(jobs, init="env")


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_processes_equal_one_process(runs, shape):
    one = float(runs[(1, 1)]["epoch"][0]["loss"])
    assert np.isfinite(one)
    for r in runs[shape]["epoch"]:
        np.testing.assert_allclose(float(r["loss"]), one, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_files(dataset_dir):
    jcli.train(_argv(dataset_dir, "jax", ("--streaming_eval",), device=False))
    return _files(os.path.join(dataset_dir, "jax"))


@pytest.mark.parametrize("label", list(CLI_RUNS))
def test_cli_over_mesh_writes_the_single_device_files(runs, dataset_dir, jax_files, label):
    shape, extra = CLI_RUNS[label]
    assert all(int(r["done"]) == 1 for r in runs[shape][label])
    base = os.path.join(dataset_dir, label)
    files = _files(base)
    assert sorted(files) == sorted(jax_files)
    (ckpt,) = [p for n, p in files.items() if "ckpt-" in n]
    assert sorted(os.listdir(ckpt)) == ["1", "2", "best-state"]
    # the metrics of the port's single-device run with the same flags
    flags = [f for f in extra if f not in ("--mesh_data", "--mesh_model", "1", "2")]
    pcli.train(_argv(dataset_dir, f"{label}-single", flags))
    (got,) = glob.glob(os.path.join(base, "rec_results", "*", "*", "results-metrics-*.pkl"))
    (want,) = glob.glob(os.path.join(dataset_dir, f"{label}-single", "rec_results", "*", "*",
                                     "results-metrics-*.pkl"))
    got, want = (pickle.load(open(p, "rb")) for p in (got, want))
    assert sorted(got) == sorted(want) == [1, 2]
    for e in got:
        for k in want[e]:
            np.testing.assert_allclose(got[e][k], want[e][k], err_msg=f"{e} {k}", **METRIC_TOL)
    # one device serves from the primary's checkpoint: the best dump's rows
    out = os.path.join(base, "served.tsv")
    serve(["--rec", "bprmf", "--dataset", "synthetic", "--data_root", dataset_dir,
           "--results_root", base, "--embed_k", "8", "--top_k", str(K_TOP), "--ckpt", ckpt,
           "--device", "cpu", "--users", "all", "--output", out])
    (best,) = glob.glob(os.path.join(base, "rec_results", "*", "*", "best-recs-*"))
    served = [line.split("\t")[:2] for line in open(out).read().strip().split("\n")]
    dumped = [line.split("\t")[:2] for line in open(best).read().strip().split("\n")]
    assert served == dumped and len(served) == U * K_TOP


def test_single_process_bootstrap(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_from_env() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize_from_env() is False
    assert multihost.is_primary()
    assert multihost.global_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="mesh 2x2 != 1 devices"):
        multihost.global_mesh(2, 2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize_from_env()


@pytest.mark.parametrize("extra,msg", [
    (("--mesh_data", "2"), "needs 2 ranks, the process group has 1"),
    (("--mesh_model", "2", "--moment_dtype", "float8", "--train_path", "packed"),
     "float8 is single-device only"),
    (("--mesh_data", "2", "--streamed"), "--streamed is single-device"),
])
def test_cli_refuses_meshes_it_cannot_run(dataset_dir, extra, msg, monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=msg):
        pcli.train(_argv(dataset_dir, "never", extra))
    assert not os.path.exists(os.path.join(dataset_dir, "never"))
