"""Row scatter-set (port of ``fashionvisualexpl_tpu/ops/row_scatter.py``, K5).

``table[ids[b]] = vals[b]`` in place for a float32 table [R, W], unique
int32 ids [B] and vals [B, W], by the hand-written CUDA kernel of
``csrc/row_scatter.cu`` (one warp per row, integer words: bits are copied,
never float values).  The packed LazyAdam step (``train/packed_generic.py``)
writes all its rows through it.

Semantics of ``.at[ids].set(vals, unique_indices=True, mode="drop")`` with
negative ids dropped as well:
- ids MUST be unique (two rows writing one id race; the packed engine's
  sort/segment dedupe guarantees it, as on the TPU); nothing checks it;
- ids >= R and ids < 0 (the dedupe's padding convention) are dropped.

The table is updated in place and returned, the role of the TPU kernel's
donated ``input_output_aliases``.  ``scatter_rows_set`` launches the kernel
for CUDA tensors (or raises) and takes the plain version
``scatter_rows_set_reference`` for CPU tensors only;
``scatter_rows_set.launches`` counts kernel launches.  ``bench_scatter``
times the kernel against ``Tensor.index_copy_`` on the card; ``python -m
fashionvisualexpl_tpu_torch.ops.row_scatter`` prints its result.
"""

from __future__ import annotations

import ctypes
import json
from typing import Tuple

import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.ops.gather import chained_ms, check_rows


def _check(table, ids, vals) -> None:
    check_rows(table, ids, "scatter_rows_set")
    want = (ids.shape[0], table.shape[1])
    if tuple(vals.shape) != want or vals.dtype != torch.float32 \
            or vals.device != table.device:
        raise ValueError(
            f"scatter_rows_set: vals must be {list(want)} float32 on {table.device}, "
            f"got {vals.dtype}{tuple(vals.shape)} on {vals.device}"
        )
    if table.shape[0] >= 2**31:
        raise ValueError("scatter_rows_set: tables of 2**31 rows or more")


def scatter_rows_set_reference(table, ids, vals) -> torch.Tensor:
    """Plain version, in place: the kept rows copied as int32 bits."""
    idx = ids.long()
    keep = (idx >= 0) & (idx < table.shape[0])
    table.view(torch.int32).index_copy_(0, idx[keep], vals.view(torch.int32)[keep])
    return table


def _library() -> ctypes.CDLL:
    from fashionvisualexpl_tpu_torch.ops.cuda_build import load_library

    lib = load_library("row_scatter")
    if not getattr(lib, "_fvx_typed", False):
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.fvx_scatter_rows_set.argtypes = [ptr] * 3 + [i64] * 3 + [ptr]
        lib.fvx_scatter_rows_set.restype = ctypes.c_int
        lib._fvx_typed = True
    return lib


@torch.no_grad()
def scatter_rows_set(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
                     rows_per_step: int = 16) -> torch.Tensor:
    """Write ``vals [B, W]`` into the rows ``ids [B]`` of ``table [R, W]``
    in place and return ``table``; ids unique, ids outside [0, R) dropped.
    ``rows_per_step`` is the TPU kernel's DMA group size; it is accepted
    and ignored (the CUDA kernel's grid is its own)."""
    del rows_per_step
    _check(table, ids, vals)
    if table.device.type == "cpu":
        return scatter_rows_set_reference(table, ids, vals)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_rows_set: unsupported device {table.device}")
    for name, t in (("table", table), ("ids", ids), ("vals", vals)):
        if not t.is_contiguous():
            raise ValueError(f"scatter_rows_set: {name} must be contiguous")
    R, W = table.shape
    B = ids.shape[0]
    if B == 0 or R == 0:
        return table
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().fvx_scatter_rows_set(table.data_ptr(), ids.data_ptr(),
                                             vals.data_ptr(), R, W, B, stream)
    if rc != 0:
        raise RuntimeError(f"scatter kernel launch failed: cudaError {rc}")
    scatter_rows_set.launches += 1
    return table


scatter_rows_set.launches = 0


def bench_scatter(table_rows: int = 1_000_000, dim: int = 384, batch: int = 24576,
                  reps: int = 20, rows_per_step: int = 16,
                  device: DeviceLike = None) -> Tuple[float, float]:
    """(kernel_ms, torch_ms) per scatter-set of ``batch`` unique random rows
    into a [table_rows, dim] table on the CUDA card: ``reps`` sets at
    ``(ids + i) % R`` chained over the same table, as in the JAX package's
    bench, through the kernel and through ``Tensor.index_copy_``.  Needs a
    card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("bench_scatter times the CUDA kernel: it needs a CUDA device")
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(table_rows, dim, device=dev, generator=g)
    ids = torch.randperm(table_rows, device=dev, generator=g)[:batch]
    vals = torch.randn(batch, dim, device=dev, generator=g)
    ids32 = ids.to(torch.int32)

    def kernel(i):
        scatter_rows_set(table, (ids32 + i) % table_rows, vals, rows_per_step)

    def library(i):
        table.index_copy_(0, (ids + i) % table_rows, vals)

    return chained_ms(kernel, reps), chained_ms(library, reps)


if __name__ == "__main__":
    k, t = bench_scatter()
    print(json.dumps({"kernel_ms": k, "torch_ms": t, "speedup": t / k}))
