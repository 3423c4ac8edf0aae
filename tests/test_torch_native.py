"""Port's native host data plane (``data/native.py``, its own copy of the
C++ source) against the JAX package's pure-Python paths, on the CPU.

Every case of ``tests/test_native.py`` is mirrored: parse (4 and 2
columns, an empty line and no trailing newline, a large file), the padded
positives (and the width error), the dump writer's round trip, the row
gather on 2-D and 4-D rows, the streamed store.  The references are JAX's
``read_split_tsv(path, use_native=False)``, ``pad_sorted_positives``,
``src[ids]`` and the Python dump format; JAX's native wrappers are never
called (they build ``native/libfvx_native.so`` in place).  Also: the source
is byte-equal to ``native/fvx_native.cpp``; the library lands in
``build/torch_kernels/`` under its hashed name, by rename, never in
``native/``; ids out of range raise on both routes; without the library
every caller takes its Python path.  All bit-equal."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.data.interactions import pad_sorted_positives as jpad
from fashionvisualexpl_tpu.data.interactions import read_split_tsv as jread
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu_torch.data import native as N
from fashionvisualexpl_tpu_torch.data.interactions import Interactions, read_split_tsv
from fashionvisualexpl_tpu_torch.data.pipeline import take_rows
from fashionvisualexpl_tpu_torch.train.streamed import ArrayFeatureStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    built = N.load_library()
    if built is None:
        pytest.skip("no g++: the native library cannot be built here")
    return built


@pytest.fixture
def no_library(monkeypatch):
    monkeypatch.setattr(N, "load_library", lambda: None)


def _write_tsv(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(str(x) for x in r) + "\n")


def test_source_is_the_jax_packages_source():
    with open(os.path.join(REPO, "native", "fvx_native.cpp"), "rb") as f:
        assert N.SOURCE.read_bytes() == f.read()


def test_library_builds_under_its_hashed_name_by_rename(lib):
    path = N.library_path()
    assert path.parent == N.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "torch_kernels")
    assert path.name.startswith("libfvx_native-") and path.suffix == ".so"
    assert path.exists() and lib._name == str(path)
    assert str(path.parent) != os.path.join(REPO, "native")
    # no temporary name is left behind
    assert not list(N.BUILD_DIR.glob("libfvx_native-*.tmp"))


def test_concurrent_builds_never_load_a_half_written_library(tmp_path):
    """Four processes build into one empty directory at once; each loads a
    whole library and parses with it."""
    tsv = tmp_path / "t.tsv"
    tsv.write_text("0\t5\n1\t7\n")
    script = (
        "import sys; from pathlib import Path; "
        "from fashionvisualexpl_tpu_torch.data import native as N; "
        f"N.BUILD_DIR = Path({str(tmp_path / 'b')!r}); "
        f"u, i, _ = N.parse_interactions_tsv({str(tsv)!r}); "
        "sys.exit(0 if (u.tolist(), i.tolist()) == ([0, 1], [5, 7]) else 1)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script], env=env, cwd=REPO)
             for _ in range(4)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0, 0, 0]
    built = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert built == [N.library_path().name]


def test_parse_matches_python(lib, tmp_path):
    rng = np.random.default_rng(0)
    rows = [(int(rng.integers(0, 50)), int(rng.integers(0, 80)),
             int(rng.integers(0, 10**9)), 1.0) for _ in range(500)]
    path = str(tmp_path / "train.tsv")
    _write_tsv(path, rows)
    before = N.parse_interactions_tsv.calls
    users, items, times = N.parse_interactions_tsv(path)
    assert N.parse_interactions_tsv.calls == before + 1
    want = jread(path, use_native=False)
    assert len(users) == len(want) == 500
    np.testing.assert_array_equal(users, [u for u, _ in want])
    np.testing.assert_array_equal(items, [i for _, i in want])
    np.testing.assert_array_equal(times, [r[2] for r in rows])
    assert read_split_tsv(path) == read_split_tsv(path, use_native=False) == want
    assert N.parse_interactions_tsv.calls == before + 2


def test_parse_two_column_and_trailing_newline(lib, tmp_path):
    path = str(tmp_path / "t.tsv")
    with open(path, "w") as f:
        f.write("0\t5\n1\t7\n\n2\t9")  # an empty line, no trailing newline
    users, items, times = N.parse_interactions_tsv(path)
    np.testing.assert_array_equal(users, [0, 1, 2])
    np.testing.assert_array_equal(items, [5, 7, 9])
    np.testing.assert_array_equal(times, [0, 0, 0])
    assert read_split_tsv(path) == jread(path, use_native=False) == [(0, 5), (1, 7), (2, 9)]


def test_large_file_parse(lib, tmp_path):
    """The chunked multithreaded parse keeps the file's order."""
    n = 200_000
    rng = np.random.default_rng(2)
    u, i, t = (rng.integers(0, hi, n) for hi in (1000, 2000, 10**9))
    path = str(tmp_path / "big.tsv")
    with open(path, "w") as f:
        f.writelines(f"{a}\t{b}\t{c}\n" for a, b, c in zip(u, i, t))
    users, items, times = N.parse_interactions_tsv(path)
    np.testing.assert_array_equal(users, u)
    np.testing.assert_array_equal(items, i)
    np.testing.assert_array_equal(times, t)
    assert read_split_tsv(path) == jread(path, use_native=False)


def test_missing_file_raises_on_both_routes(lib, tmp_path, monkeypatch):
    path = str(tmp_path / "absent.tsv")
    with pytest.raises(FileNotFoundError):
        N.parse_interactions_tsv(path)
    with pytest.raises(FileNotFoundError):
        read_split_tsv(path)
    monkeypatch.setattr(N, "load_library", lambda: None)
    with pytest.raises(FileNotFoundError):
        read_split_tsv(path)


def test_pad_positives_matches_python(lib):
    data = jsynth(40, 60, interactions_per_user=9, seed=1)
    padded_py, counts_py = jpad(data.training_list, data.num_items)
    before = N.pad_sorted_positives_native.calls
    for width in (padded_py.shape[1], None, padded_py.shape[1] + 3):
        padded_c, counts_c = N.pad_sorted_positives_native(
            data.train_pairs[:, 0], data.train_pairs[:, 1], data.num_users,
            data.num_items, width=width)
        want_p, want_c = jpad(data.training_list, data.num_items, width=width)
        np.testing.assert_array_equal(counts_c, want_c)
        np.testing.assert_array_equal(padded_c, want_p)
        assert padded_c.dtype == want_p.dtype and counts_c.dtype == want_c.dtype
    assert N.pad_sorted_positives_native.calls == before + 3


def test_pad_positives_width_error(lib):
    data = jsynth(10, 30, interactions_per_user=6, seed=2)
    width = int(np.bincount(data.train_pairs[:, 0]).max()) - 1
    with pytest.raises(ValueError, match="width"):
        jpad(data.training_list, data.num_items, width=width)
    with pytest.raises(ValueError, match="width"):
        N.pad_sorted_positives_native(data.train_pairs[:, 0], data.train_pairs[:, 1],
                                      data.num_users, data.num_items, width=width)


def _python_dump(path, users, ids, vals):
    """The Python writer's format (``store_recommendation``'s fallback)."""
    with open(path, "w") as out:
        out.writelines(f"{u}\t{ids[r, j]}\t{vals[r, j]}\n"
                       for r, u in enumerate(users) for j in range(ids.shape[1]))


def test_native_write_recs_tsv(lib, tmp_path):
    """The native writer against the Python writer: the same rows; scores
    round-trip float32 exactly (%.9g)."""
    rng = np.random.default_rng(0)
    n, k = 37, 5
    users = np.arange(n, dtype=np.int32)
    ids = rng.integers(0, 1000, (n, k)).astype(np.int32)
    vals = (rng.standard_normal((n, k)) * 100).astype(np.float32)
    vals[0, :3] = [0.0, -1e-38, 3.4028235e38]
    path, py = str(tmp_path / "recs.tsv"), str(tmp_path / "py.tsv")
    before = N.write_recs_tsv.calls
    assert N.write_recs_tsv(path, users, ids, vals)
    assert N.write_recs_tsv.calls == before + 1
    _python_dump(py, users, ids, vals)
    got = [line.split("\t") for line in open(path).read().strip().split("\n")]
    want = [line.split("\t") for line in open(py).read().strip().split("\n")]
    assert len(got) == len(want) == n * k
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_array_equal(np.asarray([r[2] for r in got], np.float32),
                                  np.asarray([r[2] for r in want], np.float32))
    np.testing.assert_array_equal(np.asarray([r[2] for r in got], np.float32),
                                  vals.reshape(-1))
    with pytest.raises(ValueError, match="shape mismatch"):
        N.write_recs_tsv(path, users[:-1], ids, vals)


@pytest.mark.parametrize("shape", [(50, 16), (40, 4, 4, 1)], ids=["2d", "4d"])
def test_native_gather_rows_matches_numpy(lib, shape, tmp_path):
    """The threaded gather == src[ids], from an array and from a memmap,
    into a new array and into a given one."""
    rng = np.random.default_rng(0)
    src = rng.random(shape).astype(np.float32)
    np.save(tmp_path / "src.npy", src)
    mm = np.load(tmp_path / "src.npy", mmap_mode="r")
    ids = rng.integers(0, shape[0], 33).astype(np.int32)
    before = N.gather_rows_native.calls
    np.testing.assert_array_equal(N.gather_rows_native(src, ids), src[ids])
    out = np.full((33,) + shape[1:], np.nan, np.float32)
    assert N.gather_rows_native(mm, ids, out=out) is out
    np.testing.assert_array_equal(out, src[ids])
    assert N.gather_rows_native.calls == before + 2
    with pytest.raises(ValueError, match="out must be"):
        N.gather_rows_native(src, ids, out=out[:5])
    # not a C-contiguous ndarray: None, the caller's fallback
    assert N.gather_rows_native(src[::2], ids[ids < shape[0] // 2]) is None
    assert N.gather_rows_native.calls == before + 2


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("bad", [-1, 50, 2**31 - 1], ids=["negative", "n_rows", "huge"])
def test_out_of_range_ids_raise_on_both_routes(lib, route, bad, monkeypatch):
    src = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)
    ids = np.asarray([0, bad, 4], np.int32)
    if route == "numpy":
        monkeypatch.setattr(N, "load_library", lambda: None)
    with pytest.raises(IndexError, match=r"outside \[0, 50\)"):
        N.gather_rows_native(src, ids)
    with pytest.raises(IndexError):
        take_rows(src, ids, np.empty((3, 3), np.float32))


def test_streamed_store_uses_native_gather(lib, tmp_path):
    """``ArrayFeatureStore.gather`` equals src[ids] with and without the
    library, from arrays and memmaps; with it, each modality's positives
    and negatives went through one native gather."""
    rng = np.random.default_rng(1)
    arrays = dict(color=rng.random((30, 8)).astype(np.float32),
                  edges=rng.random((30, 4, 4, 1)).astype(np.float32),
                  cls=rng.random((30, 5)).astype(np.float32))
    for name, a in arrays.items():
        np.save(tmp_path / f"{name}.npy", a)
    pos = rng.integers(0, 30, 10).astype(np.int32)
    neg = rng.integers(0, 30, 10).astype(np.int32)
    want = {f"{k}_{side}": arrays[src][ids] for side, ids in (("pos", pos), ("neg", neg))
            for k, src in (("col", "color"), ("img", "edges"), ("cls", "cls"))}
    for store in (ArrayFeatureStore(**arrays),
                  ArrayFeatureStore.from_memmap(*(str(tmp_path / f"{n}.npy")
                                                  for n in ("color", "edges", "cls")))):
        before = N.gather_rows_native.calls
        feats = store.gather(pos, neg)
        assert N.gather_rows_native.calls == before + 3
        assert sorted(feats) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(feats[k], want[k])
            assert feats[k].shape == (10,) + store.shapes(10)[k.split("_")[0]][1:]
        out = {k: np.full(shape, np.nan, np.float32) for k, shape in store.shapes(10).items()}
        for k, v in store.gather(pos, neg, out=out).items():
            np.testing.assert_array_equal(v, want[k])
            assert np.shares_memory(v, out[k.split("_")[0]])


def test_store_falls_back_to_numpy_where_the_jax_store_does(lib, no_library):
    rng = np.random.default_rng(2)
    color = rng.random((12, 3)).astype(np.float64)  # not float32: numpy in JAX too
    edges = rng.random((12, 2, 2, 1)).astype(np.float32)
    cls = rng.random((12, 2)).astype(np.float32)
    store = ArrayFeatureStore(color, edges, cls)
    ids = np.asarray([3, 0, 11], np.int32)
    feats = store.gather(ids, ids[::-1])
    np.testing.assert_array_equal(feats["col_pos"], color[ids].astype(np.float32))
    np.testing.assert_array_equal(feats["img_neg"], edges[ids[::-1]])


def test_without_the_library_every_caller_takes_python(no_library, tmp_path):
    path = str(tmp_path / "t.tsv")
    _write_tsv(path, [(0, 3, 7), (2, 1, 8)])
    assert N.parse_interactions_tsv(path) is None
    assert N.pad_sorted_positives_native(np.zeros(1), np.zeros(1), 1, 2) is None
    assert N.gather_rows_native(np.zeros((2, 2), np.float32), np.asarray([1])) is None
    assert N.write_recs_tsv(path, np.zeros(1), np.zeros((1, 1)), np.zeros((1, 1))) is False
    assert read_split_tsv(path) == [(0, 3), (2, 1)]


def test_interactions_load_is_bit_equal_on_both_routes(lib, tmp_path, monkeypatch):
    """``Interactions.load`` over the JAX package's synthetic dataset: the
    native parse and the Python loop give the same arrays."""
    from fashionvisualexpl_tpu.data.synthetic_dataset import make_synthetic_dataset_on_disk
    from fashionvisualexpl_tpu_torch.core.config import Paths, TrainConfig

    make_synthetic_dataset_on_disk(str(tmp_path), num_users=30, num_items=40,
                                   interactions_per_user=6, with_images=False)
    cfg = TrainConfig(dataset="synthetic", paths=Paths(root=str(tmp_path)))
    before = N.parse_interactions_tsv.calls
    native = Interactions.load(cfg)
    assert N.parse_interactions_tsv.calls > before
    monkeypatch.setattr(N, "load_library", lambda: None)
    python = Interactions.load(cfg)
    for name in ("train_pairs", "padded_pos", "pos_counts"):
        np.testing.assert_array_equal(getattr(native, name), getattr(python, name))
    assert native.test_list == python.test_list
    assert native.validation_list == python.validation_list


@pytest.mark.parametrize("route", ["native", "python"])
def test_factored_dump_goes_through_the_native_writer(lib, route, tmp_path, monkeypatch):
    """``FactoredEvaluator.store_recommendation``: the native writer (its
    counter rises) or, without the library, the Python one; the same ids
    and float32 scores either way."""
    from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
    from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF

    data = synthetic_interactions(12, 20, interactions_per_user=4, seed=3)
    model = BPRMF(12, 20, embed_k=4, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    ev = FactoredEvaluator(model, data, k=3, user_block=8)
    users, ids, vals = ev._topk_rows(None, None)
    if route == "python":
        monkeypatch.setattr(N, "load_library", lambda: None)
    before = N.write_recs_tsv.calls
    path = str(tmp_path / "recs.tsv")
    ev.store_recommendation(None, None, path)
    assert N.write_recs_tsv.calls == before + (route == "native")
    rows = [line.split("\t") for line in open(path).read().strip().split("\n")]
    assert [(int(r[0]), int(r[1])) for r in rows] == [
        (int(u), int(i)) for u, row in zip(users, ids) for i in row]
    np.testing.assert_array_equal(np.asarray([r[2] for r in rows], np.float32),
                                  vals.reshape(-1))
