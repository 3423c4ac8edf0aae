"""Row scatter-set (port of ``fashionvisualexpl_tpu/ops/row_scatter.py``, K5).

``table[ids[b]] = vals[b]`` in place for a float32 table [R, W], unique
int32 ids [B] and vals [B, W], by the hand-written CUDA kernels of
``csrc/row_scatter.cu``: the bits are copied as integers, never as float
values.  The packed LazyAdam step (``train/packed_generic.py``) writes all
its rows through it.

Semantics of ``.at[ids].set(vals, unique_indices=True, mode="drop")`` with
negative ids dropped as well:
- ids MUST be unique (two rows writing one id race; the packed engine's
  sort/segment dedupe guarantees it, as on the TPU); nothing checks it;
- ids >= R and ids < 0 (the dedupe's padding convention) are dropped.

Routes (``scatter_plan``; the source note of ``csrc/row_scatter.cu`` says
how each runs): a row that one trip of 8 loads a lane holds (256 words:
``LANES_MAX_BYTES``) takes a lanes route, each lane keeping its loads of
two rows of ``vals`` in flight (``lanes16`` where the width and the base
pointers allow 16-byte words, else ``lanes4``); wider rows come into
shared memory by bulk asynchronous copies and leave for their table rows
by bulk copies where every offset is a multiple of 16 bytes
(``bulk_store``), else by the lanes (``bulk_lanes``).

The table is updated in place and returned, the role of the TPU kernel's
donated ``input_output_aliases``.  ``scatter_rows_set`` launches the kernel
for CUDA tensors (or raises) and takes the plain version
``scatter_rows_set_reference`` for CPU tensors only;
``scatter_rows_set.launches`` counts kernel launches and
``scatter_rows_set.routes`` counts them by route.  ``bench_scatter`` times
the kernel against ``Tensor.index_copy_`` on the card; ``python -m
fashionvisualexpl_tpu_torch.ops.row_scatter`` prints its result.
"""

from __future__ import annotations

import ctypes
import functools
import json
from collections import Counter
from typing import NamedTuple, Optional, Tuple, Union

import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.ops.gather import _stream, chained_ms, check_rows

# csrc/row_scatter.cu's routes, by the number fvx_scatter_rows_set takes
ROUTES = ("lanes4", "lanes16", "bulk_store", "bulk_lanes")
_ROUTE_NUMBER = {name: i for i, name in enumerate(ROUTES)}
# the widest rows (bytes) each lanes route takes: one trip of 8 loads a
# lane, with the next row's loads in flight; wider rows take a bulk route,
# which beat a lanes route of 16 loads a lane or of two trips there
# (measured with the L2 flushed by scripts_torch/k5_ab.py; PERF.md)
LANES_MAX_BYTES = {"lanes4": 1024, "lanes16": 4096}
# the lanes routes' loads in flight a lane (2, 4, 8 or 16; at most 8 of 16
# bytes): the fewest that take a whole row in one trip
LANE_UNROLL = (2, 4, 8, 16)
# the bulk routes' largest piece (bytes one copy moves) and stages a warp
# (swept by scripts_torch/k5_ab.py; PERF.md)
BULK_GEOMETRY = {"bulk_store": (4096, 6), "bulk_lanes": (8192, 4)}
# csrc/row_scatter.cu's geometry constants
BULK_WARPS, MAX_STAGES, STAGE_SLACK, RING_OFFSET, MAX_SMEM = 4, 16, 32, 512, 232_448
MAX_WIDTH, MAX_LANES_WIDTH = 1 << 28, 1 << 22


class ScatterPlan(NamedTuple):
    """The route ``scatter_rows_set`` launches and its parameters:
    ``param`` is the lanes routes' loads a lane issues for a row, or the
    bulk routes' stages a warp; ``piece_bytes`` the bulk routes' largest
    piece (0 on the lanes)."""

    route: str
    param: int
    piece_bytes: int


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


def scatter_plan(width: int, table_ptr: int, vals_ptr: int,
                 route: Optional[str] = None) -> ScatterPlan:
    """The route and parameters ``scatter_rows_set`` launches for rows of
    ``width`` floats between a table and vals at these addresses.
    ``route`` forces a kind (``"lanes"``, ``"bulk"``) or a route of
    ``ROUTES``; raises ValueError for what ``csrc/row_scatter.cu`` cannot
    take."""
    return _plan(int(width), (table_ptr | vals_ptr) & 15, route)


@functools.lru_cache(maxsize=512)
def _plan(width: int, low_bits: int, route: Optional[str]) -> ScatterPlan:
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"scatter_plan: width {width} outside [1, {MAX_WIDTH}]")
    if low_bits & 3:
        raise ValueError("scatter_plan: table and vals must be 4-byte aligned")
    row = 4 * width
    vec16 = width % 4 == 0 and not low_bits & 15
    lanes = "lanes16" if vec16 else "lanes4"
    kind = route or (lanes if row <= LANES_MAX_BYTES[lanes] else "bulk")
    if kind == "lanes":
        kind = lanes
    elif kind == "bulk":
        kind = "bulk_store" if vec16 else "bulk_lanes"
    if kind not in _ROUTE_NUMBER:
        raise ValueError(f"scatter_plan: unknown route {route!r}")
    if kind.startswith("lanes"):
        word = int(kind[len("lanes"):])
        if kind == "lanes16" and not vec16:
            raise ValueError(f"scatter_plan: {kind} cannot take width {width} at "
                             f"addresses {low_bits} mod 16")
        if width > MAX_LANES_WIDTH:
            raise ValueError(f"scatter_plan: the lanes routes take at most "
                             f"{MAX_LANES_WIDTH} floats a row, not {width}")
        words = row // word
        unroll = next((u for u in LANE_UNROLL if 32 * u >= words), LANE_UNROLL[-1])
        return ScatterPlan(kind, min(unroll, 8) if word == 16 else unroll, 0)
    if kind == "bulk_store" and not vec16:
        raise ValueError(f"scatter_plan: bulk_store needs W % 4 == 0 and 16-byte-aligned "
                         f"bases (width {width}, addresses {low_bits} mod 16)")
    largest, stages = BULK_GEOMETRY[kind]
    pieces = -(-row // largest)
    return ScatterPlan(kind, stages, 16 * -(-row // (16 * pieces)))


def bulk_smem(plan: ScatterPlan) -> int:
    """Dynamic shared memory a block of a bulk route takes."""
    return RING_OFFSET + BULK_WARPS * plan.param * (plan.piece_bytes + STAGE_SLACK)


def _bind():
    """The typed ctypes entries of the built library, looked up once."""
    from fashionvisualexpl_tpu_torch.ops.cuda_build import load_library

    lib = load_library("row_scatter")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.fvx_scatter_rows_set
    fn.argtypes = [ptr] * 3 + [i64] * 3 + [i32, i32, i64, ptr]
    fn.restype = ctypes.c_int
    res = lib.fvx_scatter_residency
    res.argtypes = [i64, i32, i32, i64, ptr]
    res.restype = ctypes.c_int
    _entries[:] = [fn, res]
    return _entries


_entries: list = []


def scatter_residency(width: int, plan: ScatterPlan) -> Tuple[int, int]:
    """(resident blocks an SM, SMs) of ``plan``'s kernel on the current
    card: the persistent grid is their product.  Needs a card."""
    info = (ctypes.c_int * 2)()
    _, res = _entries or _bind()
    rc = res(width, _ROUTE_NUMBER[plan.route], plan.param, plan.piece_bytes, info)
    if rc != 0:
        raise RuntimeError(f"scatter residency query failed: cudaError {rc}")
    return info[0], info[1]


@torch.no_grad()
def scatter_rows_set(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
                     rows_per_step: int = 16,
                     _route: Union[str, ScatterPlan, None] = None) -> torch.Tensor:
    """Write ``vals [B, W]`` into the rows ``ids [B]`` of ``table [R, W]``
    in place and return ``table``; ids unique, ids outside [0, R) dropped.
    ``rows_per_step`` is the TPU kernel's DMA group size; it is accepted
    and ignored (the CUDA kernel's grid is its own).  ``_route`` forces a
    route on the card (``scatter_plan``'s ``route``), or a whole plan that
    the kernel checks (the card tests and the timing scripts use it)."""
    del rows_per_step
    _check(table, ids, vals)
    dev = table.device
    if dev.type == "cpu":
        return scatter_rows_set_reference(table, ids, vals)
    if dev.type != "cuda":
        raise ValueError(f"scatter_rows_set: unsupported device {dev}")
    for name, t in (("table", table), ("ids", ids), ("vals", vals)):
        if not t.is_contiguous():
            raise ValueError(f"scatter_rows_set: {name} must be contiguous")
    R, W = table.shape
    B = ids.shape[0]
    if B == 0 or R == 0:
        return table
    tp, vp = table.data_ptr(), vals.data_ptr()
    plan = _route if isinstance(_route, ScatterPlan) else _plan(W, (tp | vp) & 15, _route)
    fn = (_entries or _bind())[0]
    args = (tp, ids.data_ptr(), vp, R, W, B, _ROUTE_NUMBER[plan.route], plan.param,
            plan.piece_bytes)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, _stream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, _stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"scatter kernel launch failed ({plan.route}): cudaError {rc}")
    scatter_rows_set.launches += 1
    scatter_rows_set.routes[plan.route] += 1
    return table


scatter_rows_set.launches = 0
scatter_rows_set.routes = Counter()


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
