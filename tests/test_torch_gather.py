"""Port row gather (``ops/gather.py``, K4's plain version) vs the JAX
package's ``gather_rows(interpret=True)``, bit for bit (rows compared as
uint32, so NaN and denormal patterns count by their bits).

Cases: the JAX test's random ids, duplicates, a batch that is not a
multiple of ``rows_per_step`` (the TPU wrapper pads it internally), ids
outside [0, R) (the kernel wraps a negative id once and clamps the rest),
and the packed rows' odd widths holding random bit patterns.  The CUDA
kernel is held against this plain version on the card
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
