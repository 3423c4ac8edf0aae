"""Fused scoring + >=-position counts for the streaming evaluator (port of
``fashionvisualexpl_tpu/ops/counts.py``), kernel K2.

The per-epoch metric path (eval/factored.py) is a blocked scan whose body is
matmul -> banned mask -> >= compare -> reduce.  The hand-written CUDA
kernel of ``csrc/counts.cu`` computes

    counts[u, t] = |{allowed i : iv_i . uf_u + ib_i >= ref[u, t]}|

with the scores kept in registers: they never reach device memory.
Exclusions stay BY ID (the evaluator's ulp-safety rule, ops/topk.py):
banned ids arrive bucketed per item tile (``bucket_banned_ids_device``) as
tile-LOCAL offsets with -1 sentinels.  Replaces the TPU kernel
``fashionvisualexpl_tpu/ops/counts.py::_kernel``.

Bound on an H100 SXM at the evaluator's shapes (B=4096, Ip=501,760, D=128):
2*B*Ip*D = 526 GFLOP, 0.53 ms at the 989 TFLOP/s bf16 tensor-core rate
(7.85 ms at 67 TFLOP/s on the CUDA cores); compute-bound (0.26 GB of
inputs).  The counts are those of one f32 score per pair: the ``fmaf``
chain in ascending d, then ``+ ib``, then ``>=``.  The kernel takes the
product on the tensor cores in bf16x3 at any D (the rows arrive in chunks
of D: one up to D=128, two at VBPR's and GradFashion's D=148) and scores
exactly again every pair whose approximate score lies within ``band_eps``
of a reference, so its counts equal that f32 computation on any data
(``csrc/counts.cu`` derives the bound).  The plain version is one f32
matmul per item tile: equal counts wherever both compute exact scores
(quantized data).  Measured times are in PERF.md.

``counts_kernel`` launches the kernel for CUDA tensors (or raises) and takes
the plain version ``counts_kernel_reference`` for CPU tensors only;
``counts_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

MAX_T = 4  # reference columns the kernel takes
MAX_W = 48  # banned offsets per (tile, user) the kernel takes
KERNEL_TILE = 128  # the kernel's item sub-tile: item_tile must be a multiple


def counts_kernel_reference(uf, iv, ib_pad, ref_scores, banned_local, item_tile):
    """Plain PyTorch version: [B, T] int32, one f32 matmul per item tile."""
    Ip = iv.shape[0]
    iota = torch.arange(item_tile, dtype=torch.int32, device=uf.device)
    out = torch.zeros(ref_scores.shape, dtype=torch.int32, device=uf.device)
    for tile in range(Ip // item_tile):
        lo, hi = tile * item_tile, (tile + 1) * item_tile
        s = uf @ iv[lo:hi].T + ib_pad[None, lo:hi]  # [B, tile]
        banned = (iota[None, :, None] == banned_local[tile][:, None, :]).any(dim=2)
        allowed = ~banned
        for t in range(ref_scores.shape[1]):
            out[:, t] += ((s >= ref_scores[:, t : t + 1]) & allowed).sum(
                dim=1, dtype=torch.int32
            )
    return out


def band_eps(uf, iv, ib, band_scale: float = 1.0):
    """[B, I] float64: the kernel's recheck band, the bound on |bf16x3
    score - f32 fmaf-chain score| that ``csrc/counts.cu`` derives and
    applies (there in f32, from f32 norms):
    1.001 * ((4D + 300) * 2^-22 * |u|_2 |v|_2 + 2^-22 |b|) + 2^-100, |b| taken
    as 0 where b is infinite.  Plain torch; the tests hold the emulated
    arithmetic to it."""
    D = uf.shape[1]
    nu = torch.linalg.vector_norm(uf.double(), dim=1)
    nv = torch.linalg.vector_norm(iv.double(), dim=1)
    b = ib.double().abs()
    b = torch.where(torch.isinf(b), torch.zeros_like(b), b)
    eps = 1.001 * ((4 * D + 300) * 2.0**-22 * nu[:, None] * nv[None, :]
                   + 2.0**-22 * b[None, :])
    return eps * band_scale + 2.0**-100


def band_worst_case(D: int, B: int = 8, I: int = 128, seed: int = 0):
    """Rows on which bf16x3 misses the f32 score by about the most its split
    can: every coordinate is +-(1 + k 2^-7 + 2^-8 - 2^-17 - 2^-23), k in
    {0, 1}, whose bf16 rounding hi drops just under half a bf16 ulp and
    whose lo = rn_bf16(x - hi) drops just under half of its own.  Users and
    items share those coordinates (so every product errs the same way) and
    differ by powers of two, 2^a_b and 2^c_j with a, c in [-3, 3]; the bias
    is 0.  ref[b] lies halfway between the bf16x3 product of the pair
    (b, j_b) without rounding and its exact product, which the f32 score
    exceeds: item j counts for user b exactly when c_j >= c_{j_b}, and a
    band that does not hold the miss counts the pairs of j_b's scale wrong.
    Plain torch, for the tests.  Returns (uf [B, D], iv [I, D], ib [I],
    ref [B, 1]) f32 CPU tensors and the exact counts [B, 1] int32."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(0, 2, (D,), generator=g).double()
    sign = torch.randint(0, 2, (D,), generator=g).double() * 2 - 1
    x = (sign * (1 + k * 2.0**-7 + 2.0**-8 - 2.0**-17 - 2.0**-23)).float()
    hi = x.bfloat16().float()
    lo = (x - hi).bfloat16().float()
    x, hi, lo = x.double(), hi.double(), lo.double()
    exact = (x * x).sum()
    approx = (hi * hi + 2 * hi * lo).sum()
    a = torch.randint(-3, 4, (B,), generator=g)
    c = torch.randint(-3, 4, (I,), generator=g)
    jb = torch.randint(0, I, (B,), generator=g)
    uf = (2.0 ** a.double())[:, None] * x[None, :]
    iv = (2.0 ** c.double())[:, None] * x[None, :]
    ref = 2.0 ** (a + c[jb]).double()[:, None] * (exact + approx) / 2
    want = (c[None, :] >= c[jb][:, None]).sum(dim=1, keepdim=True).to(torch.int32)
    return uf.float(), iv.float(), torch.zeros(I), ref.float(), want


def _check(uf, iv, ib_pad, ref_scores, banned_local, item_tile, user_tile):
    """The JAX package's contract and geometry checks."""
    if uf.dim() != 2 or iv.dim() != 2 or ib_pad.dim() != 1 or ref_scores.dim() != 2 \
            or banned_local.dim() != 3:
        raise ValueError(
            f"expected uf [B, D], iv [Ip, D], ib_pad [Ip], ref [B, T], "
            f"banned_local [Ip/item_tile, B, W]; got {tuple(uf.shape)}, "
            f"{tuple(iv.shape)}, {tuple(ib_pad.shape)}, {tuple(ref_scores.shape)}, "
            f"{tuple(banned_local.shape)}"
        )
    B, D = uf.shape
    Ip = iv.shape[0]
    if Ip % item_tile or B % user_tile:
        raise ValueError(f"geometry: Ip={Ip} item_tile={item_tile} B={B} "
                         f"user_tile={user_tile}")
    if banned_local.shape[0] != Ip // item_tile:
        raise ValueError(
            f"banned buckets for {banned_local.shape[0]} tiles, "
            f"grid has {Ip // item_tile}"
        )
    if (iv.shape[1] != D or ib_pad.shape[0] != Ip or ref_scores.shape[0] != B
            or banned_local.shape[1] != B):
        raise ValueError(
            f"shape mismatch: uf {tuple(uf.shape)} iv {tuple(iv.shape)} "
            f"ib_pad {tuple(ib_pad.shape)} ref {tuple(ref_scores.shape)} "
            f"banned_local {tuple(banned_local.shape)}"
        )
    for name, t in (("uf", uf), ("iv", iv), ("ib_pad", ib_pad),
                    ("ref_scores", ref_scores)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if banned_local.dtype != torch.int32:
        raise ValueError(f"banned_local must be int32, got {banned_local.dtype}")
    if len({t.device for t in (uf, iv, ib_pad, ref_scores, banned_local)}) != 1:
        raise ValueError("counts_kernel: all inputs must be on one device")


def _library() -> ctypes.CDLL:
    from fashionvisualexpl_tpu_torch.ops.cuda_build import load_library

    lib = load_library("counts")
    if not getattr(lib, "_fvx_typed", False):
        lib.fvx_counts.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 6 + [ctypes.c_double]
            + [ctypes.c_void_p] * 2
        )
        lib.fvx_counts.restype = ctypes.c_int
        lib._fvx_typed = True
    return lib


@torch.no_grad()
def counts_kernel(
    uf: torch.Tensor,  # [B, D] f32, B % user_tile == 0
    iv: torch.Tensor,  # [Ip, D] f32, Ip % item_tile == 0
    ib_pad: torch.Tensor,  # [Ip] f32: bias; pad items hold -inf (never >= ref)
    ref_scores: torch.Tensor,  # [B, T] f32 (+inf for pad users)
    banned_local: torch.Tensor,  # [Ip // item_tile, B, W] int32, -1 = none
    item_tile: int = 2048,
    user_tile: int = 256,
    _band_scale: float = 1.0,
    _rechecked=None,
) -> torch.Tensor:
    """[B, T] int32 counts of allowed items scoring >= each ref score.

    ``_band_scale`` (a test hook, >= 1) multiplies the kernel's recheck
    band: ``float('inf')`` scores every pair through the exact chain.
    ``_rechecked``, an int64 [1] tensor on the card, gains the number of
    pairs the kernel scored exactly.  Neither changes the counts."""
    _check(uf, iv, ib_pad, ref_scores, banned_local, item_tile, user_tile)
    if not _band_scale >= 1.0:
        raise ValueError(f"counts_kernel: _band_scale must be >= 1, got {_band_scale}")
    if uf.device.type == "cpu":
        return counts_kernel_reference(uf, iv, ib_pad, ref_scores, banned_local,
                                       item_tile)
    if uf.device.type != "cuda":
        raise ValueError(f"counts_kernel: unsupported device {uf.device}")
    B, D = uf.shape
    Ip = iv.shape[0]
    T, W = ref_scores.shape[1], banned_local.shape[2]
    if not (1 <= T <= MAX_T and 1 <= W <= MAX_W and item_tile % KERNEL_TILE == 0):
        raise ValueError(
            f"counts_kernel: the CUDA kernel takes T <= {MAX_T}, W <= {MAX_W} "
            f"and item_tile a multiple of {KERNEL_TILE}; got T={T}, W={W}, "
            f"item_tile={item_tile}"
        )
    for name, t in (("uf", uf), ("iv", iv), ("ib_pad", ib_pad),
                    ("ref_scores", ref_scores), ("banned_local", banned_local)):
        if not t.is_contiguous():
            raise ValueError(f"counts_kernel: {name} must be contiguous")
    if _rechecked is not None and (
            _rechecked.dtype != torch.int64 or _rechecked.numel() != 1
            or _rechecked.device != uf.device):
        raise ValueError("counts_kernel: _rechecked must be an int64 [1] tensor "
                         "on the inputs' device")
    out = torch.zeros((B, T), dtype=torch.int32, device=uf.device)
    # the band's factors: f32 row norms (the kernel's 1.001 covers their
    # rounding)
    nu = torch.linalg.vector_norm(uf, dim=1)
    nv = torch.linalg.vector_norm(iv, dim=1)
    with torch.cuda.device(uf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().fvx_counts(
            uf.data_ptr(), iv.data_ptr(), ib_pad.data_ptr(), ref_scores.data_ptr(),
            banned_local.data_ptr(), nu.data_ptr(), nv.data_ptr(), out.data_ptr(),
            B, Ip, D, T, W, item_tile,
            float(_band_scale), None if _rechecked is None else _rechecked.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"counts kernel launch failed: cudaError {rc}")
    counts_kernel.launches += 1
    return out


counts_kernel.launches = 0


def pad_counts_inputs(user_vecs, item_vecs, item_bias, ref_scores, banned_local,
                      banned_valid, item_block=2048, user_tile=256):
    """``counts_kernel``'s arguments from ``streaming_counts_kernel``'s:
    users and items padded to the tiles (pad items score -inf, pad users
    compare against +inf: neither can satisfy >=) and the validity mask
    folded into a -1 offset sentinel.  Returns (uf, iv, ib_pad, ref, loc,
    item_tile, user_tile)."""
    Bu = user_vecs.shape[0]
    I = item_vecs.shape[0]
    ut = min(user_tile, max(8, Bu))
    pad_u = (-Bu) % ut
    pad_i = (-I) % item_block
    ib = (
        item_bias if item_bias is not None
        else torch.zeros(I, dtype=user_vecs.dtype, device=user_vecs.device)
    )
    loc = torch.where(banned_valid, banned_local, -1).to(torch.int32)
    return (
        F.pad(user_vecs, (0, 0, 0, pad_u)).contiguous(),
        F.pad(item_vecs, (0, 0, 0, pad_i)).contiguous(),
        F.pad(ib, (0, pad_i), value=float("-inf")).contiguous(),
        F.pad(ref_scores, (0, 0, 0, pad_u), value=float("inf")).contiguous(),
        F.pad(loc, (0, 0, 0, pad_u), value=-1).contiguous(),
        item_block, ut,
    )


def streaming_counts_kernel(
    user_vecs: torch.Tensor,  # [Bu, D]
    item_vecs: torch.Tensor,  # [I, D]
    item_bias,  # [I] or None
    ref_scores: torch.Tensor,  # [Bu, T]
    banned_local: torch.Tensor,  # [n_tiles, Bu, W] (bucket_banned_ids at item_block)
    banned_valid: torch.Tensor,  # [n_tiles, Bu, W]
    item_block: int = 2048,
    user_tile: int = 256,
    _rechecked=None,
) -> torch.Tensor:
    """Counterpart of the JAX package's ``streaming_counts_pallas``: a
    drop-in for ``ops.topk.streaming_counts`` with pre-bucketed banned ids,
    through ``counts_kernel`` on the padded inputs of
    ``pad_counts_inputs`` (``_rechecked`` as there)."""
    *args, item_tile, ut = pad_counts_inputs(
        user_vecs, item_vecs, item_bias, ref_scores, banned_local, banned_valid,
        item_block, user_tile)
    out = counts_kernel(*args, item_tile=item_tile, user_tile=ut, _rechecked=_rechecked)
    return out[: user_vecs.shape[0]]
