"""Port row scatter-set (``ops/row_scatter.py``, K5's plain version) vs the
JAX package's ``scatter_rows_set(interpret=True)`` and the ``_oracle`` of
``tests/test_row_scatter.py`` (``.at[ids].set(mode="drop")`` with negative
ids routed out of range), bit for bit (tables compared as uint32).

Cases: the four of ``tests/test_row_scatter.py`` (random unique ids, ids
out of range and negative, a batch padded internally, the JAX wrapper's
off-TPU path), the packed rows' widths (ACF's included) with random bit
patterns, and
the in-place contract (the table itself is written and returned).  The
CUDA kernel is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.ops.row_scatter import scatter_rows_set as jscatter
from fashionvisualexpl_tpu_torch.ops import row_scatter as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oracle(table, ids, vals):
    ids = jnp.where(ids < 0, table.shape[0], ids)
    return table.at[ids].set(vals, mode="drop", unique_indices=True)


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _port(table, ids, vals, rows_per_step=16):
    t = torch.from_numpy(table.copy())
    before = S.scatter_rows_set.launches
    out = S.scatter_rows_set(t, torch.from_numpy(ids), torch.from_numpy(vals), rows_per_step)
    assert out is t  # in place, the table returned
    assert S.scatter_rows_set.launches == before  # the CPU takes the plain version
    return out.numpy()


def _case(name):
    rng = np.random.default_rng(0 if name != "internal-pad" else 1)
    if name == "random":
        table = rng.normal(size=(64, 16)).astype(np.float32)
        ids = rng.permutation(64)[:40].astype(np.int32)
        vals = rng.normal(size=(40, 16)).astype(np.float32)
        return table, ids, vals, 8
    if name == "drop":
        table = np.arange(32, dtype=np.float32).reshape(8, 4)
        ids = np.asarray([3, 8, 100, -1, 0], np.int32)
        return table, ids, -np.ones((5, 4), np.float32), 4
    table = rng.normal(size=(16, 8)).astype(np.float32)
    ids = np.asarray([5, 2, 11], np.int32)
    return table, ids, rng.normal(size=(3, 8)).astype(np.float32), 4


@pytest.mark.parametrize("name", ["random", "drop", "internal-pad"])
def test_scatter_matches_jax_interpret_and_oracle(name):
    table, ids, vals, rps = _case(name)
    jt, ji, jv = (jnp.asarray(a) for a in (table, ids, vals))
    want = jscatter(jt, ji, jv, rows_per_step=rps, interpret=True)
    got = _port(table, ids, vals, rps)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(_oracle(jt, ji, jv)))
    if name == "drop":  # row R-1 untouched: a negative id does not wrap
        np.testing.assert_array_equal(got[7], table[7])
        np.testing.assert_array_equal(got[[3, 0]], -np.ones((2, 4)))


def test_scatter_matches_the_jax_off_tpu_path():
    table = np.arange(32, dtype=np.float32).reshape(8, 4)
    ids = np.asarray([-1, 2], np.int32)
    vals = -np.ones((2, 4), np.float32)
    want = jscatter(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(vals))
    np.testing.assert_array_equal(_bits(_port(table, ids, vals)), _bits(want))


# BPRMF's rows, VBPR's and GradFashion's user rows (445, 297) and ACF's
# item rows (769 / 513 unfused at fp32 / bf16 moments, 25857 / 25601 /
# 25473 with the 7x7x512 spatial maps fused)
@pytest.mark.parametrize("width", [385, 388, 257, 259, 193, 195, 445, 297, 769, 513, 25857,
                                   25601, 25473])
def test_packed_row_widths_write_bits(width):
    rng = np.random.default_rng(width)

    def bits(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.float32)

    table, vals = bits(12, width), bits(6, width)
    ids = np.asarray([11, 2**30, 0, -5, 7, 3], np.int32)
    want = _oracle(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(vals))
    got = _port(table, ids, vals)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    untouched = [r for r in range(12) if r not in (11, 0, 7, 3)]
    np.testing.assert_array_equal(_bits(got[untouched]), _bits(table[untouched]))


def test_scatter_rejects_what_it_does_not_take():
    table = torch.zeros(4, 3)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="vals must be"):
        S.scatter_rows_set(table, ids, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="vals must be"):
        S.scatter_rows_set(table, ids, torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="int32"):
        S.scatter_rows_set(table, ids.long(), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="CUDA device"):
        S.bench_scatter(table_rows=8, dim=4, batch=4, reps=1, device="cpu")


def test_module_main_needs_a_card():
    """``python -m ...ops.row_scatter`` runs bench_scatter on the card; with
    none it fails and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "fashionvisualexpl_tpu_torch.ops.row_scatter"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "kernel_ms" not in proc.stdout
    assert "CUDA is not available" in proc.stderr
