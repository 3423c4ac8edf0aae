"""Fused catalog scoring + segment max (serving stage 1).

Port of ``fashionvisualexpl_tpu/ops/segmax.py::_kernel`` (behind
``segmax_scores``), as the hand-written CUDA kernel ``csrc/segmax.cu``:

    out[b, s] = max over items j of segment s of (uf[b] . iv[j] + ib_cand[j])

with f32 accumulation from bf16 or f32 operands (a bf16 x bf16 product is
exact in f32).  ``ib_cand`` carries the item bias and the validity mask (pad
items hold -1e30), so the kernel has no branch on validity.  The output is
always [B, S]; the TPU kernel's transposed layout, its user-tile
divisibility rule and its lane-multiple item tile are Mosaic matters that
stay behind.

Bound on an H100 SXM at the serving shapes: B=4096, Ip=1,048,576 (1M items
padded to the 65536 block), D=128 is 1.10 TFLOP, ~1.11 ms at 989 TFLOP/s
bf16, against ~0.81 GB of traffic (iv 268 MB + out 537 MB), ~0.24 ms at
3.35 TB/s.  At B=8 the 268 MB item read alone bounds it: ~0.08 ms.  The
bf16 kernel runs on the tensor cores, each block holding a tile of items
while the users stream past it.  For D up to 256 in rows that take 8- or
16-byte copies (D a multiple of 4 and operands 8-byte aligned, as VBPR's
and GradFashion's D=148 and CompVBPR's 208) it runs ``mma.sync`` with the
items in registers for B <= 64 (D zero-padded to 128, 160 or 256) and
``wgmma`` warpgroup products for B > 64: up to D = 160 with the items on
M (Dp 128 or 160), above it ``segmax_wgmma_wide_kernel`` with the items on
N in an order that gives each thread whole segments (Dp 208 or 256); at
any other D ``mma.sync`` from shared memory.  ``segmax_route`` says which
for a geometry, without launching.  The f32 entry, on no main path, keeps
the first CUDA-core design.  Measured times are in PERF.md.

``segmax_scores`` launches the kernel for a CUDA tensor (or raises) and takes
the plain version ``segmax_scores_reference`` for a CPU tensor only.
``segmax_scores.launches`` counts kernel launches, and
``segmax_scores.routes`` counts them by the kernel that ran (``ROUTES``).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

_DTYPES = {torch.bfloat16: "fvx_segmax_bf16", torch.float32: "fvx_segmax_f32"}
_LAUNCH_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2
_ROUTE_ARGS = [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
# the kernels of csrc/segmax.cu, by the route number its entries report
ROUTES = ("segmax_simt_kernel", "segmax_mma_kernel", "segmax_mma_regs_kernel",
          "segmax_wgmma_kernel", "segmax_wgmma_wide_kernel")
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_entries = {}  # C entry name -> bound ctypes function


def segmax_scores_reference(
    uf: torch.Tensor, iv: torch.Tensor, ib_cand: torch.Tensor, seg: int
) -> torch.Tensor:
    """Plain PyTorch version: [B, Ip // seg] f32 segment maxima."""
    B = uf.shape[0]
    s = uf.float() @ iv.float().T + ib_cand
    return s.view(B, -1, seg).amax(-1)


def _check(uf, iv, ib_cand, seg):
    if uf.dim() != 2 or iv.dim() != 2 or ib_cand.dim() != 1:
        raise ValueError(
            f"expected uf [B, D], iv [Ip, D], ib_cand [Ip]; got "
            f"{tuple(uf.shape)}, {tuple(iv.shape)}, {tuple(ib_cand.shape)}"
        )
    B, D = uf.shape
    Ip = iv.shape[0]
    if iv.shape[1] != D or ib_cand.shape[0] != Ip:
        raise ValueError(
            f"shape mismatch: uf {tuple(uf.shape)} iv {tuple(iv.shape)} "
            f"ib_cand {tuple(ib_cand.shape)}"
        )
    if uf.dtype != iv.dtype or uf.dtype not in _DTYPES:
        raise ValueError(
            f"uf and iv must share dtype bf16 or f32; got {uf.dtype}, {iv.dtype}"
        )
    if ib_cand.dtype != torch.float32:
        raise ValueError(f"ib_cand must be float32, got {ib_cand.dtype}")
    if seg < 1 or Ip % seg:
        raise ValueError(f"geometry: Ip={Ip} not a multiple of seg={seg}")
    if not (uf.device == iv.device == ib_cand.device):
        raise ValueError("uf, iv and ib_cand must be on one device")


def segmax_scores(
    uf: torch.Tensor,  # [B, D] bf16 (or f32)
    iv: torch.Tensor,  # [Ip, D] same dtype
    ib_cand: torch.Tensor,  # [Ip] f32: bias + validity penalty for pad items
    seg: int,
) -> torch.Tensor:
    """[B, Ip // seg] f32 segment maxima of the full score matrix."""
    _check(uf, iv, ib_cand, seg)
    if uf.device.type == "cpu":
        return segmax_scores_reference(uf, iv, ib_cand, seg)
    if uf.device.type != "cuda":
        raise ValueError(f"segmax_scores: unsupported device {uf.device}")
    for name, t in (("uf", uf), ("iv", iv), ("ib_cand", ib_cand)):
        if not t.is_contiguous():
            raise ValueError(f"segmax_scores: {name} must be contiguous")
    fn = _entry(_DTYPES[uf.dtype], _LAUNCH_ARGS)
    B, D = uf.shape
    Ip = iv.shape[0]
    out = torch.empty((B, Ip // seg), dtype=torch.float32, device=uf.device)
    route = ctypes.c_int(-1)
    args = (uf.data_ptr(), iv.data_ptr(), ib_cand.data_ptr(), out.data_ptr(), B, Ip, D, seg)
    index = uf.device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, _stream(index), ctypes.byref(route))
    else:
        with torch.cuda.device(uf.device):
            rc = fn(*args, _stream(index), ctypes.byref(route))
    if rc != 0:
        raise RuntimeError(f"segmax kernel launch failed: cudaError {rc}")
    segmax_scores.launches += 1
    segmax_scores.routes[ROUTES[route.value]] += 1
    return out


segmax_scores.launches = 0
segmax_scores.routes = Counter()


def _stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def _entry(name: str, argtypes):
    fn = _entries.get(name)
    if fn is None:
        from fashionvisualexpl_tpu_torch.ops.cuda_build import load_library

        fn = getattr(load_library("segmax"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def operand_align(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every tensor's
    address: the alignment ``segmax_scores``' bf16 kernel plans with."""
    bits = 16
    for t in tensors:
        bits |= t.data_ptr()
    return bits & -bits


def segmax_route(B: int, D: int, seg: int, align: int = 16) -> dict:
    """The kernel and geometry ``segmax_scores`` launches for bf16 [B, D]
    users over items of width D at segment width ``seg``, operands aligned
    to ``align`` bytes (``operand_align``), without launching: ``kernel``
    (one of ``ROUTES``), ``Dp`` (D zero-padded), ``ld`` (shared row stride,
    bf16), ``copy_bytes``, ``group_rows`` (rows reduced in registers; 0:
    through a score tile; ``segmax_wgmma_wide_kernel``: seg where it
    divides 64, each thread's segments reduced in its registers, else 0,
    merged in shared memory), ``smem`` (bytes a block), ``block_items``
    (items a block holds) and ``stages`` (user-tile ring slots a block).
    Needs the built library, so a card's toolkit."""
    info = (ctypes.c_longlong * 7)()
    route = _entry("fvx_segmax_route", _ROUTE_ARGS)(B, D, seg, align, info)
    if route < 0:
        raise ValueError(f"segmax_route: bad geometry B={B} D={D} seg={seg} align={align}")
    ks, ld, cw, kg, smem, mt, stages = info
    return dict(kernel=ROUTES[route], Dp=16 * ks, ld=ld, copy_bytes=cw, group_rows=kg,
                smem=smem, block_items=mt, stages=stages)
