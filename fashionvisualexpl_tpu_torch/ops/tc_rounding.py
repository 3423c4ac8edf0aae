"""How the H100's tensor cores round their f32 sums of bf16 products.

K7's bf16 backward (``csrc/edge_tower.cu::edge_bwd_wgmma_kernel``) decides
pool winners on ``wgmma`` sums, and K2's band and K7's forward bound assume
a rounding of those sums.  This module holds the probe that measures it and
the model that the measurement picks:

- ``probe_sums`` runs d = c + a . b over one 64 x 64 x 16 product on the
  card (``fvx_edge_tower_probe_sums``: ``wgmma.m64n64k16`` as the conv
  issues it, or ``mma.sync.m16n8k16``); ``probe_operands`` makes crafted
  operands whose exact sums tell truncation from rounding to nearest and one
  rounding per addition from one per k16 step.
- ``tc_sums`` is the family of models held against the probe: the
  products of a k16 step taken ``block`` at a time, each block with the
  running sum aligned to a reference exponent R (the largest of the running
  sum's exponent and the products' exponents: with ``unnormalized`` a
  product a b takes e(a) + e(b), the exponent before its significand
  product in [1, 4) is normalized, else its own), every term cut toward
  zero to a multiple of 2^(R - 23 - extra), the cut terms summed exactly and
  the sum rounded once to f32 (toward zero, or to nearest even).  ``block``
  1 with 20 extra bits is one rounding per addition; ``block`` 16 with 20
  extra bits is one rounding per k16 step.  ``candidates`` lists the
  family, ``fit`` scores it against probe runs, ``MEASURED`` is the model
  that the H100's probe runs picked (every output of ``wgmma`` and of
  ``mma.sync`` equal).
- ``conv_sums`` replays by ``MEASURED`` the conv values that K7's bf16
  kernels sum on the tensor cores (``chip_smoke.py``'s float64 witness).
- ``probe_tap_sums`` runs the backward's tap-sum product (B the im2col tile
  read transposed) for a check against ``torch.matmul``.

The probes launch nothing that the main path uses; the card tests and
``chip_smoke.py`` call them."""

from __future__ import annotations

import ctypes
from typing import Dict, Iterable, List, Tuple

import torch

# extra bits below the f32 ulp of the reference exponent; the cut terms of
# 17 at 20 extra bits sum exactly in float64
EXTRA_BITS = (0, 1, 2, 3, 4, 5, 6, 20)
BLOCKS = (1, 2, 4, 8, 16)
KINDS = ("mixed", "small_c", "tiny", "cancel", "ties")
# (block, extra, toward_zero, unnormalized) of the H100's tensor cores
# (bf16 operands, f32 sums): one exact sum of a k16 step's 16 products and
# the running sum, each cut toward zero 2 bits below the f32 ulp of the
# largest unnormalized exponent, then cut toward zero to f32
MEASURED = (16, 2, True, True)


def round_f32(s: torch.Tensor, toward_zero: bool) -> torch.Tensor:
    """float64 ``s`` rounded to f32 (toward zero, or to nearest even), as
    float64."""
    f = s.float()
    if toward_zero:
        f = torch.where(f.double().abs() > s.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


ZERO_EXP = -1000  # the exponent a zero takes: below any term's, its grid still above 0


def _exponent(v: torch.Tensor) -> torch.Tensor:
    """floor(log2 |v|) of float64 v, ZERO_EXP for 0."""
    _, e = torch.frexp(v)
    return torch.where(v == 0, torch.full_like(e, ZERO_EXP), e - 1)


def tc_sums(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, block: int = MEASURED[0],
            extra: int = MEASURED[1], toward_zero: bool = MEASURED[2],
            unnormalized: bool = MEASURED[3]) -> torch.Tensor:
    """The model's f32 result (as float64) of c + sum_k a[..., k] b[..., k]
    over one k16 step, float64 tensors holding bf16 values (a, b) and f32
    values (c), broadcast together; by default ``MEASURED``."""
    a, b = torch.broadcast_tensors(a.double(), b.double())
    prods = a * b  # exact
    pexp = _exponent(a) + _exponent(b) if unnormalized else _exponent(prods)
    pexp = torch.where(prods == 0, torch.full_like(pexp, ZERO_EXP), pexp)
    acc = c.double()
    for k0 in range(0, prods.shape[-1], block):
        terms = torch.cat([acc.unsqueeze(-1), prods[..., k0:k0 + block]], dim=-1)
        ref = torch.maximum(_exponent(acc), pexp[..., k0:k0 + block].amax(dim=-1))
        grid = torch.ldexp(torch.ones_like(acc), ref - 23 - extra).unsqueeze(-1)
        acc = round_f32((torch.trunc(terms / grid) * grid).sum(dim=-1), toward_zero)
    return acc


def conv_sums(images: torch.Tensor, wt: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """[n, C, H, W] f32: K7's bf16 conv values of images [n, 1, H, W] (bf16
    values, as f32) and weights wt [25, C] (bf16 values, tap ky*5+kx) by
    ``MEASURED``: the SAME 5x5 conv (zero padding 2) as the kernels sum it,
    2 k16 steps from 0, taps 0..15 then 16..31 (25..31 zero), ``chunk``
    images at a time."""
    import torch.nn.functional as F

    n, _, H, W = images.shape
    C = wt.shape[1]
    wd = torch.cat([wt.double(), wt.new_zeros(7, C, dtype=torch.float64)])  # [32, C]
    out = torch.empty(n, C, H, W, device=images.device)
    for lo in range(0, n, chunk):
        xp = F.pad(images[lo:lo + chunk], (2, 2, 2, 2)).double()
        m = xp.shape[0]
        zero = xp.new_zeros(m, H, W)
        z = xp.new_zeros(m, C, H, W)
        for k0 in (0, 16):
            taps = torch.stack([xp[:, 0, j // 5:j // 5 + H, j % 5:j % 5 + W] if j < 25 else zero
                                for j in range(k0, k0 + 16)], dim=-1)  # [m, H, W, 16]
            z = tc_sums(z, wd[k0:k0 + 16].T[None, :, None, None, :], taps[:, None])
        out[lo:lo + chunk] = z.float()
    return out


def candidates() -> List[Tuple[int, int, bool, bool]]:
    """(block, extra, toward_zero, unnormalized) of every model of the
    family."""
    return [(blk, ex, rz, un) for blk in BLOCKS for ex in EXTRA_BITS for rz in (True, False)
            for un in (True, False)]


def name(model: Tuple[int, int, bool, bool]) -> str:
    blk, ex, rz, un = model
    return (f"block {blk}, {ex} extra bits, {'toward zero' if rz else 'to nearest even'}, "
            f"{'unnormalized' if un else 'normalized'} product exponents")


def _bf16_values(g, shape, lo: int, hi: int) -> torch.Tensor:
    """Random bf16 values (as f32): random sign, 7 random mantissa bits,
    exponents lo..hi."""
    m = torch.randint(0, 128, shape, generator=g).float()
    e = torch.randint(lo, hi + 1, shape, generator=g).float()
    s = torch.randint(0, 2, shape, generator=g).float() * 2 - 1
    return s * (1 + m / 128) * torch.exp2(e)


def _f32_values(g, shape, lo: int, hi: int) -> torch.Tensor:
    m = torch.randint(0, 2**23, shape, generator=g).double()
    e = torch.randint(lo, hi + 1, shape, generator=g).double()
    s = torch.randint(0, 2, shape, generator=g).double() * 2 - 1
    return (s * (1 + m / 2**23) * torch.exp2(e)).float()


def probe_operands(kind: str, seed: int):
    """(a [64, 16] bf16, b [64, 16] bf16 (row n: column n's k), c [64, 64]
    f32) on the CPU, made from ``seed``:

    - ``mixed``: products 2^-12 .. 2^1 and running sums 2^-3 .. 2^3, signs
      random: partial cancellation and alignment cuts everywhere;
    - ``small_c``: running sums 2^-30 .. 2^-14 under products near 1: is the
      running sum cut to the products' grid;
    - ``tiny``: running sums near +-1, products 2^-34 .. 2^-20: sub-ulp
      terms, dropped one at a time or summed first;
    - ``cancel``: running sums that the products nearly cancel, so the
      result's bits come from below the inputs' top bits;
    - ``ties``: running sum 1 + k 2^-23 and one product of 2^-24 (a half
      ulp), 0.75 or 0.25 ulp, the other 15 zero: nearest even, or toward
      zero."""
    g = torch.Generator().manual_seed(seed)
    if kind == "mixed":
        a, b = _bf16_values(g, (64, 16), -6, 0), _bf16_values(g, (64, 16), -6, 0)
        c = _f32_values(g, (64, 64), -3, 3)
    elif kind == "small_c":
        a, b = _bf16_values(g, (64, 16), -1, 0), _bf16_values(g, (64, 16), -1, 0)
        c = _f32_values(g, (64, 64), -30, -14)
    elif kind == "tiny":
        a, b = _bf16_values(g, (64, 16), -20, -14), _bf16_values(g, (64, 16), -14, -6)
        c = _f32_values(g, (64, 64), -1, 0)
    elif kind == "cancel":
        a, b = _bf16_values(g, (64, 16), -2, 0), _bf16_values(g, (64, 16), -2, 0)
        c = -(a.double() @ b.double().T).float()  # f32 rounding of minus the exact sum
        c = c * (1 + _f32_values(g, (64, 64), -12, -6).double().abs().float())
    elif kind == "ties":
        a = torch.zeros(64, 16)
        a[:, 0] = 1.0
        b = torch.zeros(64, 16)
        frac = torch.tensor([0.5, 0.75, 0.25, 1.5])  # of 2^-23
        b[:, 0] = frac[torch.arange(64) % 4] * 2.0**-23
        k = torch.randint(0, 2**20, (64, 64), generator=g).double()
        sign = torch.randint(0, 2, (64, 1), generator=g).double() * 2 - 1
        c = (sign * (1 + k * 2.0**-23)).float()
        a = a * sign.float()  # the product takes the sum's sign
    else:
        raise ValueError(f"unknown probe kind {kind!r}")
    return a.bfloat16(), b.bfloat16(), c.float()


def _library():
    from fashionvisualexpl_tpu_torch.ops import edge_tower

    lib = edge_tower._library()
    if not getattr(lib, "_fvx_probes_typed", False):
        ptr = ctypes.c_void_p
        lib.fvx_edge_tower_probe_sums.argtypes = [ptr] * 4 + [ctypes.c_int, ptr]
        lib.fvx_edge_tower_probe_tnsp.argtypes = [ptr] * 3 + [ctypes.c_int, ptr]
        lib.fvx_edge_tower_probe_sums.restype = lib.fvx_edge_tower_probe_tnsp.restype = ctypes.c_int
        lib._fvx_probes_typed = True
    return lib


def _on_card(*tensors):
    for t in tensors:
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("the tensor-core probes take contiguous CUDA tensors")


def probe_sums(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, use_mma: bool = False):
    """[64, 64] f32: c + a . b^T on the card's tensor cores, by
    ``wgmma.m64n64k16`` or (``use_mma``) ``mma.sync.m16n8k16``; a, b [64,
    16] bf16, c [64, 64] f32, CUDA tensors."""
    _on_card(a, b, c)
    d = torch.empty(64, 64, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _library().fvx_edge_tower_probe_sums(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), int(use_mma),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tensor-core probe launch failed: cudaError {rc}")
    return d


def probe_tap_sums(a: torch.Tensor, x: torch.Tensor, swap: bool = False):
    """[64, 32] f32: a . x by the bf16 backward's tap-sum product (4 k16
    steps of ``wgmma.m64n32k16``, x laid out as its im2col tile and read
    transposed); a [64, 64] bf16, x [64, 32] bf16, CUDA tensors.  ``swap``
    exchanges the descriptors' two byte offsets (a check that the test can
    tell them apart)."""
    _on_card(a, x)
    d = torch.empty(64, 32, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _library().fvx_edge_tower_probe_tnsp(
            a.data_ptr(), x.data_ptr(), d.data_ptr(), int(swap),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tap-sum probe launch failed: cudaError {rc}")
    return d


def fit(runs: Iterable[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]],
        models: Iterable[Tuple[int, int, bool, bool]] = None) -> Dict[Tuple[int, int, bool, bool], int]:
    """{model: outputs it gets wrong} over ``runs`` of (a, b, c, d): the
    probe's operands and the card's result d = c + a . b^T; every model of
    the family unless ``models`` names some."""
    a, b, c, d = (torch.stack(t) for t in zip(*runs))
    aa, bb = a.double()[:, :, None, :], b.double()[:, None, :, :]
    return {m: int((tc_sums(c, aa, bb, *m) != d.double()).sum())
            for m in (candidates() if models is None else models)}
