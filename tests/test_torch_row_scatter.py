"""Port row scatter-set (``ops/row_scatter.py``, K5's plain version) vs the
JAX package's ``scatter_rows_set(interpret=True)`` and the ``_oracle`` of
``tests/test_row_scatter.py`` (``.at[ids].set(mode="drop")`` with negative
ids routed out of range), bit for bit (tables compared as uint32).

Cases: the four of ``tests/test_row_scatter.py`` (random unique ids, ids
out of range and negative, a batch padded internally, the JAX wrapper's
off-TPU path), the packed rows' widths (ACF's included) with random bit
patterns, and
the in-place contract (the table itself is written and returned).
``scatter_plan``'s route for every width the packed paths write at both
base alignments (a table view with a storage offset is only 4-byte
aligned), forced routes and the width threshold, what it refuses, and the
bulk geometry's fit in a block's shared memory.  The CUDA kernel is held
against this plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

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


# Every width the packed paths write (floats): BPRMF rows with fp32 / bf16 /
# fp8 moments (385 / 388 at row_align 1 / 4, 257 / 259, 193 / 195), VBPR's
# and GradFashion's user rows (445 fp32, 297 bf16) and item rows with their
# frozen columns fused (4484 / 4996 fp32, 4355 / 4867 bf16), ACF's item rows
# (769 / 513 unfused, 25857 / 25601 / 25473 fused), and the JAX bench's 384;
# with the route each takes between 16-byte-aligned tensors and into a
# table whose base is 4 bytes past a 16-byte boundary.
MAIN_WIDTHS = {
    385: ("bulk_lanes", "bulk_lanes"), 388: ("lanes16", "bulk_lanes"),
    257: ("bulk_lanes", "bulk_lanes"), 259: ("bulk_lanes", "bulk_lanes"),
    193: ("lanes4", "lanes4"), 195: ("lanes4", "lanes4"),
    445: ("bulk_lanes", "bulk_lanes"), 297: ("bulk_lanes", "bulk_lanes"),
    4484: ("bulk_store", "bulk_lanes"), 4996: ("bulk_store", "bulk_lanes"),
    4355: ("bulk_lanes", "bulk_lanes"), 4867: ("bulk_lanes", "bulk_lanes"),
    769: ("bulk_lanes", "bulk_lanes"), 513: ("bulk_lanes", "bulk_lanes"),
    25857: ("bulk_lanes", "bulk_lanes"), 25601: ("bulk_lanes", "bulk_lanes"),
    25473: ("bulk_lanes", "bulk_lanes"),
    384: ("lanes16", "bulk_lanes"),
}


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset4"])
@pytest.mark.parametrize("width", sorted(MAIN_WIDTHS))
def test_plan_routes_of_main_path_widths(width, aligned):
    table_ptr = 0x7F0000000000 if aligned else 0x7F0000000004
    plan = S.scatter_plan(width, table_ptr, 0x7F0000100000)
    assert plan.route == MAIN_WIDTHS[width][0 if aligned else 1]
    lanes = "lanes16" if width % 4 == 0 and aligned else "lanes4"
    assert plan.route.startswith("bulk") == (4 * width > S.LANES_MAX_BYTES[lanes])
    if plan.route.startswith("bulk"):
        assert plan.piece_bytes % 16 == 0 and 2 <= plan.param <= S.MAX_STAGES
        largest = S.BULK_GEOMETRY[plan.route][0]
        pieces = -(-4 * width // plan.piece_bytes)
        assert pieces == -(-4 * width // largest)  # as few as the largest piece allows
        assert (pieces >= 2) == (4 * width > largest)  # rows wider than it go in pieces
    else:  # loads enough for the whole row in one trip
        word = int(plan.route[len("lanes"):])
        assert plan.piece_bytes == 0 and plan.param in (2, 4, 8)  # two rows in flight
        assert 32 * plan.param >= 4 * width // word > 32 * plan.param // 2 or plan.param == 2


def test_plan_of_a_storage_offset_view():
    """A table view one float into its storage: its base is 4 bytes past a
    16-byte boundary, so no route may assume 16-byte rows; the plain version
    writing into the view still matches JAX, the storage's first float
    untouched."""
    rng = np.random.default_rng(3)
    R = 37
    for width, (_, offset_route) in MAIN_WIDTHS.items():
        buf = torch.from_numpy(_rand_bits(rng, 1, R * width + 1)[0])
        view = buf[1:].view(R, width)
        assert view.data_ptr() % 16 == (buf.data_ptr() + 4) % 16 == 4
        vals = torch.empty(5, width)
        assert S.scatter_plan(width, view.data_ptr(), vals.data_ptr()).route == offset_route
    table = view.numpy().copy()
    ids = np.asarray([36, 2**30, 0, -1, 17, R, 5], np.int32)
    vals = _rand_bits(rng, len(ids), width)
    first = buf[0].clone()
    want = _oracle(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(vals))
    got = S.scatter_rows_set(view, torch.from_numpy(ids), torch.from_numpy(vals))
    assert got is view
    np.testing.assert_array_equal(_bits(view.numpy()), _bits(want))
    assert torch.equal(buf[0].view(torch.int32), first.view(torch.int32))


@pytest.mark.parametrize("width,low,route,want", [
    (384, 8, None, "bulk_lanes"), (2, 0, None, "lanes4"), (3, 0, None, "lanes4"),
    (4, 0, None, "lanes16"), (1, 0, None, "lanes4"),
    (385, 0, "lanes", "lanes4"), (388, 0, "bulk", "bulk_store"), (193, 0, "bulk", "bulk_lanes"),
    (4484, 0, "lanes", "lanes16"), (4484, 12, "lanes", "lanes4"),
    (4484, 12, "bulk", "bulk_lanes"), (4996, 0, "bulk_lanes", "bulk_lanes"),
    (4996, 0, "lanes4", "lanes4"), (193, 0, "lanes4", "lanes4"), (1, 0, "bulk", "bulk_lanes"),
    (255, 0, None, "lanes4"), (256, 4, None, "lanes4"), (256, 0, None, "lanes16"),
    (257, 0, None, "bulk_lanes"), (260, 8, None, "bulk_lanes"), (512, 0, None, "lanes16"),
    (511, 0, None, "bulk_lanes"), (1024, 0, None, "lanes16"), (1023, 0, None, "bulk_lanes"),
    (1025, 0, None, "bulk_lanes"), (1028, 0, None, "bulk_store"), (1024, 4, None, "bulk_lanes"),
])
def test_plan_forced_and_threshold_routes(width, low, route, want):
    """A kind forced (``_route``: the card tests and the A/B script force the
    lanes at wide rows and the bulk copies at narrow ones), 4-byte words off
    16-byte rows or bases, bulk_lanes likewise, and the width thresholds
    (``LANES_MAX_BYTES``: 1 KB rows of 4-byte words, 4 KB of 16-byte
    ones)."""
    assert S.LANES_MAX_BYTES == {"lanes4": 1024, "lanes16": 4096}  # the rows above
    plan = S.scatter_plan(width, 0x1000 + low, 0x2000, route)
    assert plan.route == want
    assert S.scatter_plan(width, 0x5550 + low, 0x990, route) is plan  # cached by low bits


@pytest.mark.parametrize("width,table_ptr,route,match", [
    (0, 0, None, "width"), (2**28 + 1, 0, None, "width"),
    (16, 2, None, "4-byte"), (4484, 6, None, "4-byte"), (16, 0, "bogus", "unknown route"),
    (385, 0, "lanes16", "lanes16 cannot"), (386, 0, "lanes8", "unknown route"),
    (388, 4, "lanes16", "lanes16 cannot"), (388, 8, "lanes16", "lanes16 cannot"),
    (385, 0, "bulk_store", "bulk_store needs"),
    (388, 4, "bulk_store", "bulk_store needs"), (388, 8, "bulk_store", "bulk_store needs"),
    (4355, 0, "bulk_store", "bulk_store needs"), (4484, 8, "bulk_store", "bulk_store needs"),
    (25857, 0, "bulk_store", "bulk_store needs"), (2**22 + 1, 0, "lanes", "at most"),
])
def test_plan_refuses_what_the_kernel_cannot_take(width, table_ptr, route, match):
    with pytest.raises(ValueError, match=f"scatter_plan: .*{match}"):
        S.scatter_plan(width, table_ptr, 0, route)


def test_plan_refusal_names_the_vals_base_too():
    """The alignment that decides a route is that of both bases: a vals
    tensor 8 bytes off a 16-byte boundary refuses the 16-byte routes."""
    assert S.scatter_plan(192, 0x1000, 0x2008).route == "lanes4"
    assert S.scatter_plan(192, 0x1000, 0x2000).route == "lanes16"
    assert S.scatter_plan(4484, 0x1000, 0x2008).route == "bulk_lanes"
    with pytest.raises(ValueError, match="bulk_store needs"):
        S.scatter_plan(4484, 0x1000, 0x2008, "bulk_store")
    with pytest.raises(ValueError, match="4-byte"):
        S.scatter_plan(4484, 0x1000, 0x2001)


def test_plan_geometry_fits_the_card():
    """Every bulk plan: pieces of a multiple of 16 bytes, of nearly equal
    size, that cover the row, 2-16 stages, and a block's shared memory
    within the 227 KB a block may take."""
    for width in list(range(1, 3000, 7)) + list(range(3000, 40000, 997)) + [2**20, 2**28]:
        for low in (0, 4, 8, 12):
            plan = S.scatter_plan(width, low, 0, "bulk")
            row = 4 * width
            largest, stages = S.BULK_GEOMETRY[plan.route]
            pieces = -(-row // plan.piece_bytes)
            assert plan.piece_bytes % 16 == 0 and plan.piece_bytes <= largest
            assert (pieces - 1) * plan.piece_bytes < row <= pieces * plan.piece_bytes
            assert pieces == -(-row // largest)  # as few pieces as the largest allows
            assert plan.param == stages and 2 <= stages <= S.MAX_STAGES
            assert S.bulk_smem(plan) <= S.MAX_SMEM
            assert plan.route == ("bulk_store" if width % 4 == 0 and low == 0 else "bulk_lanes")


@pytest.mark.parametrize("route", [None, "lanes", "bulk", S.ScatterPlan("bulk_lanes", 4, 8192)])
def test_cpu_path_counts_no_launch_and_no_route(route):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(_rand_bits(rng, 9, 4484))
    ids = torch.tensor([0, 8, 2**30, -1], dtype=torch.int32)
    vals = torch.from_numpy(_rand_bits(rng, 4, 4484))
    want = table.clone()
    want[[0, 8]] = vals[:2]
    before = (S.scatter_rows_set.launches, sum(S.scatter_rows_set.routes.values()))
    got = S.scatter_rows_set(table, ids, vals, _route=route)
    assert (S.scatter_rows_set.launches, sum(S.scatter_rows_set.routes.values())) == before
    assert got is table and torch.equal(got.view(torch.int32), want.view(torch.int32))


def _rand_bits(rng, R, W):
    """A float32 array of random 32-bit patterns (NaNs, infs, denormals)."""
    return rng.integers(0, 2**32, (R, W), dtype=np.uint64).astype(np.uint32).view(np.float32)
