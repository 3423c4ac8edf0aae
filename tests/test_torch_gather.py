"""Port row gather (``ops/gather.py``, K4's plain version) vs the JAX
package's ``gather_rows(interpret=True)``, bit for bit (rows compared as
uint32, so NaN and denormal patterns count by their bits).

Cases: the JAX test's random ids, duplicates, a batch that is not a
multiple of ``rows_per_step`` (the TPU wrapper pads it internally), ids
outside [0, R) (the kernel wraps a negative id once and clamps the rest),
and every width the packed paths gather holding random bit patterns.
``gather_plan``'s route for each of those widths at both base alignments
(a table view with a storage offset is only 4-byte aligned), and what it
refuses.  The CUDA kernel is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.ops.gather import gather_rows as jgather
from fashionvisualexpl_tpu_torch.ops import gather as G


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _check(table, ids, rows_per_step=8):
    want = jgather(jnp.asarray(table), jnp.asarray(ids), rows_per_step=rows_per_step,
                   interpret=True)
    before = G.gather_rows.launches
    got = G.gather_rows(torch.from_numpy(table), torch.from_numpy(ids), rows_per_step)
    assert G.gather_rows.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(ids), table.shape[1])
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    return got


def _random_bits(rng, R, W):
    """A float32 table of random 32-bit patterns (NaNs, infs, denormals)."""
    return rng.integers(0, 2**32, (R, W), dtype=np.uint64).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("case", ["random", "duplicates", "internal-pad"])
def test_gather_matches_jax_interpret(case):
    rng = np.random.default_rng(0)
    if case == "random":  # tests/test_gather_kernel.py's geometry
        table = rng.normal(size=(64, 16)).astype(np.float32)
        ids = rng.integers(0, 64, 40).astype(np.int32)
    elif case == "duplicates":
        table = np.arange(32, dtype=np.float32).reshape(8, 4)
        ids = np.asarray([3, 3, 0, 7, 3], np.int32)
    else:  # 13 ids, groups of 8: the TPU wrapper pads 3 ids internally
        table = rng.normal(size=(20, 6)).astype(np.float32)
        ids = rng.integers(0, 20, 13).astype(np.int32)
    _check(table, ids)


def test_out_of_range_ids_wrap_once_then_clamp():
    """The rule pinned on the JAX kernel: a negative id wraps once (id + R),
    then the id is clamped into [0, R - 1].  So 2**30 and -1 read row R - 1,
    -R - 1 and below read row 0."""
    R = 6
    table = np.arange(R * 3, dtype=np.float32).reshape(R, 3)
    ids = np.asarray([1, 2**30, -1, 5, 7, -2, -6, -7, -100, 6, 2**31 - 1, -2**31, 12],
                     np.int32)
    got = _check(table, ids, rows_per_step=4)
    rows = got.numpy()[:, 0] / 3
    np.testing.assert_array_equal(rows, [1, 5, 5, 5, 5, 4, 0, 0, 0, 5, 5, 0, 5])


@pytest.mark.parametrize("width", [385, 388, 257, 259, 193, 195])
def test_packed_row_widths_copy_bits(width):
    """The packed rows' widths (fp32, bf16 and fp8 moments at K=128) with
    random bit patterns: every bit survives, pads included."""
    rng = np.random.default_rng(width)
    table = _random_bits(rng, 9, width)
    ids = np.asarray([0, 8, 4, 4, 2**30, 3, -1], np.int32)
    _check(table, ids)


def test_gather_rejects_what_it_does_not_take():
    table = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="int32"):
        G.gather_rows(table, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="float32"):
        G.gather_rows(table.double(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="2-D"):
        G.gather_rows(torch.zeros(4), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="no rows"):
        G.gather_rows(torch.zeros(0, 3), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA device"):
        G.bench_gather(table_rows=8, dim=4, batch=4, reps=1, device="cpu")


# Every width the packed paths gather (floats): BPRMF rows with fp32 / bf16
# / fp8 moments (385 / 388 at row_align 1 / 4, 257 / 259, 193 / 195), VBPR's
# and GradFashion's user rows (445 fp32, 297 bf16) and item rows with their
# frozen columns fused (4484 / 4996 fp32, 4355 / 4867 bf16), ACF's item rows
# at K=128 ([Gi | Pi | moments | tau]: 769 / 513 / 385 at fp32 / bf16 / fp8
# moments; with its 7x7x512 spatial maps fused 25857 / 25601 / 25473), and
# the JAX bench's 128; with the route each takes between 16-byte-aligned
# tensors and from a table whose base is 4 bytes past a 16-byte boundary.
MAIN_WIDTHS = {
    385: ("lanes4", "lanes4"), 388: ("lanes16", "lanes4"),
    257: ("lanes4", "lanes4"), 259: ("lanes4", "lanes4"),
    193: ("lanes4", "lanes4"), 195: ("lanes4", "lanes4"),
    445: ("lanes4", "lanes4"), 297: ("lanes4", "lanes4"),
    4484: ("bulk_store", "bulk_lanes"), 4996: ("bulk_store", "bulk_lanes"),
    4355: ("bulk_lanes", "bulk_lanes"), 4867: ("bulk_lanes", "bulk_lanes"),
    769: ("bulk_lanes", "bulk_lanes"), 513: ("bulk_lanes", "bulk_lanes"),
    25857: ("bulk_lanes", "bulk_lanes"), 25601: ("bulk_lanes", "bulk_lanes"),
    25473: ("bulk_lanes", "bulk_lanes"),
    128: ("lanes16", "lanes4"),
}


@pytest.mark.parametrize("width", sorted(MAIN_WIDTHS))
def test_main_path_widths_match_jax_bit_for_bit(width):
    """R=37, B=50 random bit patterns: the dedupe's 2**30 pads, negative ids
    (wrapped once, then clamped), the first and the last row."""
    rng = np.random.default_rng(width)
    R = 37
    table = _random_bits(rng, R, width)
    ids = rng.integers(0, R, 50).astype(np.int32)
    ids[:8] = [2**30, -1, -R, -R - 1, R - 1, 0, R, -5]
    ids[-10:] = 2**30
    _check(table, ids)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset4"])
@pytest.mark.parametrize("width", sorted(MAIN_WIDTHS))
def test_plan_routes_of_main_path_widths(width, aligned):
    table_ptr = 0x7F0000000000 if aligned else 0x7F0000000004
    plan = G.gather_plan(width, table_ptr, 0x7F0000100000)
    assert plan.route == MAIN_WIDTHS[width][0 if aligned else 1]
    if plan.route.startswith("bulk"):
        assert plan.piece_bytes % 16 == 0 and 2 <= plan.param <= G.MAX_STAGES
        largest = G.BULK_GEOMETRY[plan.route][0]
        pieces = -(-4 * width // plan.piece_bytes)
        assert pieces == -(-4 * width // largest)  # as few as the largest piece allows
        assert (pieces >= 2) == (4 * width > largest)  # rows wider than it go in pieces
    else:  # loads enough for the whole row in one trip
        word = int(plan.route[len("lanes"):])
        assert plan.piece_bytes == 0 and plan.param in (2, 4, 8, 16)
        assert 32 * plan.param >= 4 * width // word > 32 * plan.param // 2 or plan.param == 2


def test_plan_of_a_storage_offset_view():
    """A table view one float into its storage: its base is 4 bytes past a
    16-byte boundary, so no route may assume 16-byte rows; the plain version
    on the view still matches JAX."""
    rng = np.random.default_rng(3)
    R = 37
    for width, (_, offset_route) in MAIN_WIDTHS.items():
        buf = torch.from_numpy(_random_bits(rng, 1, R * width + 1)[0])
        view = buf[1:].view(R, width)
        assert view.data_ptr() % 16 == (buf.data_ptr() + 4) % 16 == 4
        out = torch.empty(50, width)
        assert G.gather_plan(width, view.data_ptr(), out.data_ptr()).route == offset_route
    ids = rng.integers(-R, R, 50).astype(np.int32)
    _check(view.numpy().copy(), ids)
    np.testing.assert_array_equal(
        _bits(G.gather_rows(view, torch.from_numpy(ids)).numpy()),
        _bits(jgather(jnp.asarray(view.numpy()), jnp.asarray(ids), interpret=True)))


@pytest.mark.parametrize("width,low,route,want", [
    (128, 8, None, "lanes4"), (2, 0, None, "lanes4"), (3, 0, None, "lanes4"),
    (385, 0, "bulk", "bulk_lanes"), (388, 0, "bulk", "bulk_store"),
    (4484, 0, "lanes", "lanes16"), (4484, 12, "lanes", "lanes4"),
    (4484, 12, "bulk", "bulk_lanes"), (4996, 0, "bulk_lanes", "bulk_lanes"),
    (1, 0, "bulk", "bulk_lanes"), (512, 0, None, "bulk_store"), (511, 0, None, "lanes4"),
    (513, 4, None, "bulk_lanes"), (510, 0, None, "lanes4"), (508, 0, None, "lanes16"),
])
def test_plan_forced_and_threshold_routes(width, low, route, want):
    """A kind forced (``_route``: the card tests and the A/B script force the
    lanes at wide rows and the bulk copies at narrow ones), 4-byte words off
    16-byte rows or bases, bulk_lanes likewise, and the width threshold
    (2048-byte rows)."""
    plan = G.gather_plan(width, 0x1000 + low, 0x2000, route)
    assert plan.route == want
    assert G.gather_plan(width, 0x5550 + low, 0x990, route) is plan  # cached by low bits


@pytest.mark.parametrize("width,table_ptr,route,match", [
    (0, 0, None, "width"), (2**28 + 1, 0, None, "width"),
    (16, 2, None, "4-byte"), (4484, 6, None, "4-byte"), (16, 0, "bogus", "unknown route"),
    (385, 0, "lanes16", "lanes16 cannot"), (386, 0, "lanes8", "unknown route"),
    (388, 4, "lanes16", "lanes16 cannot"), (388, 8, "lanes16", "lanes16 cannot"),
    (385, 0, "bulk_store", "bulk_store needs"),
    (388, 4, "bulk_store", "bulk_store needs"), (388, 8, "bulk_store", "bulk_store needs"),
    (4355, 0, "bulk_store", "bulk_store needs"), (4484, 8, "bulk_store", "bulk_store needs"),
    (2**22 + 1, 0, "lanes", "at most"),
])
def test_plan_refuses_what_the_kernel_cannot_take(width, table_ptr, route, match):
    with pytest.raises(ValueError, match=match):
        G.gather_plan(width, table_ptr, 0, route)


def test_plan_geometry_fits_the_card():
    """Every bulk plan: pieces of a multiple of 16 bytes, of nearly equal
    size, that cover the row, 2-16 stages, and a block's shared memory
    within the 227 KB a block may take."""
    for width in list(range(1, 3000, 7)) + list(range(3000, 40000, 997)) + [2**20, 2**28]:
        for low in (0, 4, 8, 12):
            plan = G.gather_plan(width, low, 0, "bulk")
            row = 4 * width
            largest, stages = G.BULK_GEOMETRY[plan.route]
            pieces = -(-row // plan.piece_bytes)
            assert plan.piece_bytes % 16 == 0 and plan.piece_bytes <= largest
            assert (pieces - 1) * plan.piece_bytes < row <= pieces * plan.piece_bytes
            assert pieces == -(-row // largest)  # as few pieces as the largest allows
            assert plan.param == stages and 2 <= stages <= G.MAX_STAGES
            assert G.bulk_smem(plan) <= G.MAX_SMEM
            assert plan.route == ("bulk_store" if width % 4 == 0 and low == 0 else "bulk_lanes")


def test_cpu_path_counts_no_launch_and_no_route():
    table = torch.from_numpy(_random_bits(np.random.default_rng(1), 9, 4484))
    ids = torch.tensor([0, 8, 2**30, -1], dtype=torch.int32)
    before = (G.gather_rows.launches, sum(G.gather_rows.routes.values()))
    got = G.gather_rows(table, ids, _route="lanes")
    assert (G.gather_rows.launches, sum(G.gather_rows.routes.values())) == before
    assert torch.equal(got.view(torch.int32), table.view(torch.int32)[[0, 8, 8, 8]])
