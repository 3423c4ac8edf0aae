"""Row gather (port of ``fashionvisualexpl_tpu/ops/gather.py``, K4).

``out[b] = table[ids[b]]`` for a float32 table [R, W] and int32 ids [B],
by the hand-written CUDA kernels of ``csrc/gather.cu``: the bits are
copied as integers, never as float values.  The packed LazyAdam step
(``train/packed_generic.py``) reads all its rows through it.  The TPU
kernel's per-row DMAs and semaphores stay behind.

Ids outside [0, R) are mapped as the TPU kernel maps them: a negative id
wraps once (``id + R``), then the result is clamped into [0, R - 1] (so
the dedupe's pad 2**30 reads row R - 1).  ``jnp.take`` would return NaN
rows there instead; the packed step throws those rows away either way.

Routes (``gather_plan``; the source note of ``csrc/gather.cu`` says how
each runs): rows narrower than ``BULK_MIN_BYTES`` take a lanes route, each
lane keeping several 16- or 4-byte loads in flight (``lanes16`` where the
width and the base pointers allow 16-byte words, else ``lanes4``); wider
rows come into shared memory by bulk asynchronous copies and leave by bulk
copies where every offset is a multiple of 16 bytes (``bulk_store``), else
by the lanes (``bulk_lanes``).

``gather_rows`` launches the kernel for CUDA tensors (or raises) and takes
the plain version ``gather_rows_reference`` for CPU tensors only;
``gather_rows.launches`` counts kernel launches and ``gather_rows.routes``
counts them by route.  ``bench_gather`` times the kernel against
``torch.index_select`` on the card, as the JAX package's bench compares
its kernel with XLA's gather.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import NamedTuple, Optional, Tuple, Union

import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device

# csrc/gather.cu's routes, by the number fvx_gather_rows takes
ROUTES = ("lanes4", "lanes16", "bulk_store", "bulk_lanes")
_ROUTE_NUMBER = {name: i for i, name in enumerate(ROUTES)}
# rows of at least this many bytes take a bulk route (measured with the L2
# flushed by scripts_torch/k4_ab.py; PERF.md)
BULK_MIN_BYTES = 2048
# the lanes routes' loads in flight a lane (2, 4, 8 or 16; at most 8 of 16
# bytes): the fewest that take a whole row in one trip
LANE_UNROLL = (2, 4, 8, 16)
# the bulk routes' largest piece (bytes one copy moves) and stages a warp
# (swept by scripts_torch/k4_ab.py; PERF.md): bulk_store keeps 8 pieces
# of at most 4 KB in flight a warp, one 4-warp block an SM; bulk_lanes 4
# pieces of at most 8 KB (two blocks an SM at the bf16 item rows' 5.8 and
# 6.5 KB pieces, so 8 warps of lanes store from shared memory)
BULK_GEOMETRY = {"bulk_store": (4096, 8), "bulk_lanes": (8192, 4)}
# csrc/gather.cu's geometry constants
BULK_WARPS, MAX_STAGES, STAGE_SLACK, RING_OFFSET, MAX_SMEM = 4, 16, 32, 512, 232_448
MAX_WIDTH, MAX_LANES_WIDTH = 1 << 28, 1 << 22


class GatherPlan(NamedTuple):
    """The route ``gather_rows`` launches and its parameters: ``param`` is
    the lanes routes' loads a lane issues for a row, or the bulk routes'
    stages a warp; ``piece_bytes`` the bulk routes' largest piece (0 on
    the lanes)."""

    route: str
    param: int
    piece_bytes: int


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


def gather_plan(width: int, table_ptr: int, out_ptr: int,
                route: Optional[str] = None) -> GatherPlan:
    """The route and parameters ``gather_rows`` launches for rows of
    ``width`` floats between a table and an output at these addresses.
    ``route`` forces a kind (``"lanes"``, ``"bulk"``) or a route of
    ``ROUTES``; raises ValueError for what ``csrc/gather.cu`` cannot take."""
    return _plan(int(width), (table_ptr | out_ptr) & 15, route)


@functools.lru_cache(maxsize=512)
def _plan(width: int, low_bits: int, route: Optional[str]) -> GatherPlan:
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"gather_plan: width {width} outside [1, {MAX_WIDTH}]")
    if low_bits & 3:
        raise ValueError("gather_plan: table and out must be 4-byte aligned")
    row = 4 * width
    vec16 = width % 4 == 0 and not low_bits & 15
    kind = route or ("bulk" if row >= BULK_MIN_BYTES else "lanes")
    if kind == "lanes":
        kind = "lanes16" if vec16 else "lanes4"
    elif kind == "bulk":
        kind = "bulk_store" if vec16 else "bulk_lanes"
    if kind not in _ROUTE_NUMBER:
        raise ValueError(f"gather_plan: unknown route {route!r}")
    if kind.startswith("lanes"):
        word = int(kind[len("lanes"):])
        if kind == "lanes16" and not vec16:
            raise ValueError(f"gather_plan: {kind} cannot take width {width} at "
                             f"addresses {low_bits} mod 16")
        if width > MAX_LANES_WIDTH:
            raise ValueError(f"gather_plan: the lanes routes take at most {MAX_LANES_WIDTH} "
                             f"floats a row, not {width}")
        words = row // word
        unroll = next((u for u in LANE_UNROLL if 32 * u >= words), LANE_UNROLL[-1])
        return GatherPlan(kind, min(unroll, 8) if word == 16 else unroll, 0)
    if kind == "bulk_store" and not vec16:
        raise ValueError(f"gather_plan: bulk_store needs W % 4 == 0 and 16-byte-aligned "
                         f"bases (width {width}, addresses {low_bits} mod 16)")
    largest, stages = BULK_GEOMETRY[kind]
    pieces = -(-row // largest)
    return GatherPlan(kind, stages, 16 * -(-row // (16 * pieces)))


def bulk_smem(plan: GatherPlan) -> int:
    """Dynamic shared memory a block of a bulk route takes."""
    return RING_OFFSET + BULK_WARPS * plan.param * (plan.piece_bytes + STAGE_SLACK)


def _bind():
    """The typed ctypes entries of the built library, looked up once."""
    from fashionvisualexpl_tpu_torch.ops.cuda_build import load_library

    lib = load_library("gather")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.fvx_gather_rows
    fn.argtypes = [ptr] * 3 + [i64] * 3 + [i32, i32, i64, ptr]
    fn.restype = ctypes.c_int
    res = lib.fvx_gather_residency
    res.argtypes = [i64, i32, i32, i64, ptr]
    res.restype = ctypes.c_int
    _entries[:] = [fn, res]
    return _entries


_entries: list = []
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def gather_residency(width: int, plan: GatherPlan) -> Tuple[int, int]:
    """(resident blocks an SM, SMs) of ``plan``'s kernel on the current
    card: the persistent grid is their product.  Needs a card."""
    info = (ctypes.c_int * 2)()
    _, res = _entries or _bind()
    rc = res(width, _ROUTE_NUMBER[plan.route], plan.param, plan.piece_bytes, info)
    if rc != 0:
        raise RuntimeError(f"gather residency query failed: cudaError {rc}")
    return info[0], info[1]


@torch.no_grad()
def gather_rows(table: torch.Tensor, ids: torch.Tensor, rows_per_step: int = 8,
                _route: Union[str, GatherPlan, None] = None) -> torch.Tensor:
    """table [R, W] float32 (R >= 1), ids [B] int32 -> [B, W], a new tensor.
    ``rows_per_step`` is the TPU kernel's DMA group size; it is accepted
    and ignored (the CUDA kernel's grid is its own).  ``_route`` forces a
    route on the card (``gather_plan``'s ``route``), or a whole plan that
    the kernel checks (the card tests and the timing scripts use it)."""
    del rows_per_step
    check_rows(table, ids, "gather_rows")
    R, W = table.shape
    if R < 1:
        raise ValueError("gather_rows: the table has no rows")
    dev = table.device
    if dev.type == "cpu":
        return gather_rows_reference(table, ids)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {dev}")
    if not table.is_contiguous():
        raise ValueError("gather_rows: table must be contiguous")
    if not ids.is_contiguous():
        raise ValueError("gather_rows: ids must be contiguous")
    B = ids.shape[0]
    out = torch.empty((B, W), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    tp, op = table.data_ptr(), out.data_ptr()
    plan = _route if isinstance(_route, GatherPlan) else _plan(W, (tp | op) & 15, _route)
    fn = (_entries or _bind())[0]
    args = (tp, ids.data_ptr(), op, R, W, B, _ROUTE_NUMBER[plan.route], plan.param,
            plan.piece_bytes)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, _stream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, _stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed ({plan.route}): cudaError {rc}")
    gather_rows.launches += 1
    gather_rows.routes[plan.route] += 1
    return out


gather_rows.launches = 0
gather_rows.routes = Counter()


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
