"""Fused BPR triplet loss (port of ``fashionvisualexpl_tpu/ops/bpr.py``).

The BPR pairwise loss and its analytic gradients over gathered embeddings,
as the hand-written CUDA kernels of ``csrc/bpr.cu`` (K1).  Semantics match
the reference train step (BPRMF.py:95-106): x = b_i + <g_u, g_i>, the
difference clipped to [-80, 1e8], loss = sum softplus(-diff), the clip's
gradient zero outside the bounds.

- ``bpr_forward`` -> (loss, sigma): sigma = sigmoid(-diff) is the residual,
  zeroed outside the open interval (-80, 1e8).  As in the TPU kernel, diff
  is associated as (bp - bn) + sum(gu * (gp - gn)).
- ``bpr_backward`` turns sigma into the five input gradients, times the
  upstream gradient ``g`` (a 0-d tensor on the inputs' device).
- ``bpr_triplet_loss`` binds the two in a ``torch.autograd.Function``.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain version (``bpr_forward_reference`` / ``bpr_backward_reference``) for
CPU tensors only; ``.launches`` counts kernel launches.  The TPU kernel's
``tile``/``interpret`` arguments and its pad-then-subtract-n·log 2 are
Mosaic matters that stay behind: the CUDA grid masks the ragged edge.

The forward is one launch: ``fwd_tiles`` picks its route (float4 loads,
or scalar loads where K or a pointer does not allow them) and its tile of
triples, and the block that finishes last sums the blocks' partial losses
in a fixed order, through a ticket and partials kept per (device, stream)
(``csrc/bpr.cu``'s note).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from fashionvisualexpl_tpu_torch.models.base import bpr_pairwise_loss, softplus

CLIP_LO = -80.0
CLIP_HI = 1e8
# the forward kernel's triples a block on its two routes (csrc/bpr.cu's
# kVecTile, kPlainTile)
FWD_TILES = {"vec": 32, "plain": 16}


def bpr_triplet_loss_reference(gu, gi_pos, gi_neg, b_pos, b_neg):
    """Plain torch loss, the reference's association (for testing)."""
    return bpr_pairwise_loss(b_pos + torch.sum(gu * gi_pos, dim=1),
                             b_neg + torch.sum(gu * gi_neg, dim=1))


def bpr_forward_reference(gu, gp, gn, bp, bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (loss 0-d, sigma [B])."""
    diff = (bp - bn) + torch.sum(gu * (gp - gn), dim=1)
    loss = torch.sum(softplus(-torch.clamp(diff, CLIP_LO, CLIP_HI)))
    in_range = (diff > CLIP_LO) & (diff < CLIP_HI)
    sigma = torch.where(in_range, torch.sigmoid(-diff), torch.zeros_like(diff))
    return loss, sigma


def bpr_backward_reference(sigma, gu, gp, gn, g):
    """Plain version of the backward kernel: (dgu, dgp, dgn, dbp, dbn)."""
    sc = sigma[:, None]
    return (g * (sc * (gn - gp)), g * (-sc * gu), g * (sc * gu),
            g * (-sigma), g * sigma)


def _check(gu, gp, gn, vecs):
    if gu.dim() != 2 or gp.shape != gu.shape or gn.shape != gu.shape:
        raise ValueError(
            f"expected gu, gp, gn [B, K] alike; got {tuple(gu.shape)}, "
            f"{tuple(gp.shape)}, {tuple(gn.shape)}"
        )
    B = gu.shape[0]
    for name, t in vecs:
        if t.shape != (B,):
            raise ValueError(f"{name} must be [{B}], got {tuple(t.shape)}")
    for t in (gu, gp, gn, *(t for _, t in vecs)):
        if t.dtype != torch.float32:
            raise ValueError(f"BPR kernel takes float32, got {t.dtype}")
        if t.device != gu.device:
            raise ValueError("BPR kernel inputs must be on one device")
    if gu.device.type not in ("cpu", "cuda"):
        raise ValueError(f"BPR kernel: unsupported device {gu.device}")
    if B < 1:
        raise ValueError("BPR kernel needs at least one triple")


def fwd_tiles(B: int, K: int, aligned: bool) -> Tuple[str, int, int]:
    """(route, T, blocks) of the forward kernel at [B, K]: block i takes
    triples [i*T, min((i+1)*T, B)).  The "vec" route reads float4 columns,
    which needs K a multiple of 4 and the three row pointers ``aligned`` to
    16 bytes; otherwise the "plain" route reads scalars."""
    route = "vec" if aligned and K % 4 == 0 else "plain"
    T = FWD_TILES[route]
    return route, T, -(-B // T)


# (device index, stream) -> (ticket int32 [1], partials f32 [>= blocks])
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device, stream: int, blocks: int):
    """The forward's ticket and partials on this stream: the ticket zeroed
    once, when made (the kernel's last block resets it); the partials grow
    as a call needs more blocks.  Calls on one stream run in order, so they
    can share both; each stream has its own."""
    key = (device.index, stream)
    ticket, partial = _workspaces.get(key, (None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    if partial is None or partial.numel() < blocks:
        partial = torch.empty(max(blocks, 1024), dtype=torch.float32, device=device)
    _workspaces[key] = (ticket, partial)
    return ticket, partial


def _library() -> ctypes.CDLL:
    from fashionvisualexpl_tpu_torch.ops.cuda_build import load_library

    lib = load_library("bpr")
    if not getattr(lib, "_fvx_typed", False):
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.fvx_bpr_fwd.argtypes = [ptr] * 9 + [i64] * 3 + [ctypes.c_int, ptr]
        lib.fvx_bpr_bwd.argtypes = [ptr] * 10 + [i64] * 2 + [ptr]
        for fn in (lib.fvx_bpr_fwd, lib.fvx_bpr_bwd):
            fn.restype = ctypes.c_int
        lib._fvx_typed = True
    return lib


def _contig(*named):
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"BPR kernel: {name} must be contiguous")


def bpr_forward(gu, gp, gn, bp, bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss 0-d f32, sigma [B] f32) of the clipped BPR loss."""
    _check(gu, gp, gn, (("bp", bp), ("bn", bn)))
    if gu.device.type == "cpu":
        return bpr_forward_reference(gu, gp, gn, bp, bn)
    _contig(("gu", gu), ("gp", gp), ("gn", gn), ("bp", bp), ("bn", bn))
    B, K = gu.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (gu, gp, gn))
    route, T, blocks = fwd_tiles(B, K, aligned)
    with torch.cuda.device(gu.device):
        sigma = torch.empty(B, dtype=torch.float32, device=gu.device)
        loss = torch.empty((), dtype=torch.float32, device=gu.device)
        stream = torch.cuda.current_stream().cuda_stream
        ticket, partial = _workspace(gu.device, stream, blocks)
        rc = _library().fvx_bpr_fwd(
            gu.data_ptr(), gp.data_ptr(), gn.data_ptr(), bp.data_ptr(),
            bn.data_ptr(), sigma.data_ptr(), partial.data_ptr(),
            ticket.data_ptr(), loss.data_ptr(), B, K, T, int(route == "vec"), stream)
    if rc != 0:
        raise RuntimeError(f"BPR forward kernel launch failed: cudaError {rc}")
    bpr_forward.launches += 1
    return loss, sigma


def bpr_backward(sigma, gu, gp, gn, g):
    """(dgu, dgp, dgn, dbp, dbn) from the forward's sigma, times the
    upstream gradient ``g`` (0-d f32 tensor)."""
    _check(gu, gp, gn, (("sigma", sigma),))
    g = g.to(torch.float32).reshape(())
    if g.device != gu.device:
        raise ValueError("BPR backward: g must be on the inputs' device")
    if gu.device.type == "cpu":
        return bpr_backward_reference(sigma, gu, gp, gn, g)
    g = g.contiguous()
    _contig(("sigma", sigma), ("gu", gu), ("gp", gp), ("gn", gn))
    B, K = gu.shape
    outs = [torch.empty_like(gu) for _ in range(3)]
    outs += [torch.empty_like(sigma) for _ in range(2)]
    with torch.cuda.device(gu.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().fvx_bpr_bwd(sigma.data_ptr(), gu.data_ptr(), gp.data_ptr(), gn.data_ptr(),
                g.data_ptr(), *(o.data_ptr() for o in outs), B, K, stream)
    if rc != 0:
        raise RuntimeError(f"BPR backward kernel launch failed: cudaError {rc}")
    bpr_backward.launches += 1
    return tuple(outs)


bpr_forward.launches = 0
bpr_backward.launches = 0


class BPRTripletLoss(torch.autograd.Function):
    """Forward kernel, sigma saved; backward kernel from sigma."""

    @staticmethod
    def forward(ctx, gu, gi_pos, gi_neg, b_pos, b_neg):
        loss, sigma = bpr_forward(gu, gi_pos, gi_neg, b_pos, b_neg)
        ctx.save_for_backward(sigma, gu, gi_pos, gi_neg)
        return loss

    @staticmethod
    def backward(ctx, g):
        sigma, gu, gp, gn = ctx.saved_tensors
        return bpr_backward(sigma, gu, gp, gn, g)


def bpr_triplet_loss(gu, gi_pos, gi_neg, b_pos, b_neg) -> torch.Tensor:
    """Summed BPR loss over gathered triplet embeddings, fused.

    Args: gu/gi_pos/gi_neg [B, K] float32, b_pos/b_neg [B] float32."""
    return BPRTripletLoss.apply(gu, gi_pos, gi_neg, b_pos, b_neg)
