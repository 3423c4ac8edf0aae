"""Row gather (port of ``fashionvisualexpl_tpu/ops/gather.py``, K4).

``out[b] = table[ids[b]]`` for a float32 table [R, W] and int32 ids [B],
by the hand-written CUDA kernel of ``csrc/gather.cu`` (one warp per row,
16-, 8- or 4-byte integer words: the bits are copied, never float values).
The packed LazyAdam step (``train/packed_generic.py``) reads all its rows
through it.  The TPU kernel's per-row DMAs and semaphores stay behind.

Ids outside [0, R) are mapped as the TPU kernel maps them: a negative id
wraps once (``id + R``), then the result is clamped into [0, R - 1] (so
the dedupe's pad 2**30 reads row R - 1).  ``jnp.take`` would return NaN
rows there instead; the packed step throws those rows away either way.

``gather_rows`` launches the kernel for CUDA tensors (or raises) and takes
the plain version ``gather_rows_reference`` for CPU tensors only;
``gather_rows.launches`` counts kernel launches.  ``bench_gather`` times
the kernel against ``torch.index_select`` on the card, as the JAX package's
bench compares its kernel with XLA's gather.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device


def check_rows(table: torch.Tensor, ids: torch.Tensor, op: str) -> None:
    """Raise ValueError unless ``table`` is a 2-D float32 table and ``ids``
    1-D int32 on its device."""
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(
            f"{op}: table must be a 2-D float32 tensor, got "
            f"{table.dtype}{tuple(table.shape)}"
        )
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(
            f"{op}: ids must be a 1-D int32 tensor, got {ids.dtype}{tuple(ids.shape)}"
        )
    if ids.device != table.device:
        raise ValueError(f"{op}: ids on {ids.device}, table on {table.device}")


def gather_rows_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: the rows copied as int32 bits, ids wrapped once when
    negative and clamped into [0, R - 1]."""
    R = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + R, idx).clamp_(0, R - 1)
    return table.view(torch.int32).index_select(0, idx).view(torch.float32)


def _library() -> ctypes.CDLL:
    from fashionvisualexpl_tpu_torch.ops.cuda_build import load_library

    lib = load_library("gather")
    if not getattr(lib, "_fvx_typed", False):
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.fvx_gather_rows.argtypes = [ptr] * 3 + [i64] * 3 + [ptr]
        lib.fvx_gather_rows.restype = ctypes.c_int
        lib._fvx_typed = True
    return lib


@torch.no_grad()
def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                rows_per_step: int = 8) -> torch.Tensor:
    """table [R, W] float32 (R >= 1), ids [B] int32 -> [B, W], a new tensor.
    ``rows_per_step`` is the TPU kernel's DMA group size; it is accepted
    and ignored (the CUDA kernel's grid is its own)."""
    del rows_per_step
    check_rows(table, ids, "gather_rows")
    if table.shape[0] < 1:
        raise ValueError("gather_rows: the table has no rows")
    if table.device.type == "cpu":
        return gather_rows_reference(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    for name, t in (("table", table), ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"gather_rows: {name} must be contiguous")
    R, W = table.shape
    B = ids.shape[0]
    out = torch.empty(B, W, dtype=table.dtype, device=table.device)
    if B == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().fvx_gather_rows(table.data_ptr(), ids.data_ptr(),
                                        out.data_ptr(), R, W, B, stream)
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError {rc}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def chained_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn(i)`` over i = 0..reps-1, one chain timed with
    CUDA events after one chain of warm-up."""
    for i in range(reps):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_gather(table_rows: int = 1_000_000, dim: int = 128, batch: int = 24576,
                 reps: int = 20, device: DeviceLike = None) -> Tuple[float, float]:
    """(kernel_ms, torch_ms) per gather of ``batch`` random rows of a
    [table_rows, dim] table on the CUDA card: ``reps`` gathers at
    ``(ids + i) % R`` chained as in the JAX package's bench, through the
    kernel and through ``torch.index_select``.  Needs a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("bench_gather times the CUDA kernel: it needs a CUDA device")
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(table_rows, dim, device=dev, generator=g)
    ids = torch.randint(0, table_rows, (batch,), device=dev, generator=g,
                        dtype=torch.int32)
    ids64 = ids.long()
    acc = torch.zeros((), device=dev)

    def kernel(i):
        acc.add_(gather_rows(table, (ids + i) % table_rows)[0, 0])

    def library(i):
        acc.add_(torch.index_select(table, 0, (ids64 + i) % table_rows)[0, 0])

    return chained_ms(kernel, reps), chained_ms(library, reps)
