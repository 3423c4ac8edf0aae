"""Compute-dtype policy for the encoder towers (port of
``fashionvisualexpl_tpu/core/precision.py``).

The FLOP-heavy trainable towers (AttentiveFashion's modality encoders and
edge tower, CompVBPR's AlexNet-style CNN) opt into bfloat16 compute with
the per-model ``compute_dtype``, as in the JAX package, while

- master params stay f32 (the optimizer never sees bf16),
- loss, regularisation and score accumulation stay f32,
- long reductions (the global average pool) stay f32,
- every tower output is cast back to f32 (``cast_f32``).

Both dtypes run: a bfloat16 AttentiveFashion on the card takes the
edge-tower kernel's bf16 instantiation (``ops/edge_tower.py``), the bf16
convs and matmuls run on cuDNN's and cuBLAS's bf16 routes.

A float32 tower on the card computes in full f32: cuDNN rounds f32
convolutions to TF32 by default, so ``conv2d_f32`` and ``linear_f32`` (the
CNN's, the space-to-depth tower's and the plain edge tower's) run forward
and backward under ``fp32_math`` (TF32 off for cuDNN and cuBLAS), which
restores the global switches on exit.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_ALLOWED = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(name) -> torch.dtype:
    """'float32' | 'bfloat16' (or that torch dtype) -> validated torch dtype."""
    if isinstance(name, torch.dtype):
        if name in _ALLOWED.values():
            return name
    elif name in _ALLOWED:
        return _ALLOWED[name]
    raise ValueError(f"compute_dtype must be one of {tuple(_ALLOWED)}, got {name}")


def cast_compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast an activation or weight to the compute dtype (no-op for fp32)."""
    return x if x.dtype == dtype else x.to(dtype)


def cast_f32(x: torch.Tensor) -> torch.Tensor:
    """Cast a tower output back to fp32 for loss and score accumulation."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


@contextmanager
def fp32_math():
    """cuDNN convolutions and cuBLAS matmuls within run in full f32 (no
    TF32); the switches are restored on exit."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


class _Conv2d(torch.autograd.Function):
    """Conv [B, Cin, H, W] x [Cout, Cin, kh, kw] at ``stride`` with
    symmetric zero ``padding``, forward and backward under ``fp32_math``."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conv = dict(stride=stride, padding=padding)
        with fp32_math():
            return torch.nn.functional.conv2d(x, w, **ctx.conv)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        with fp32_math():
            dx = (torch.nn.grad.conv2d_input(x.shape, w, dy, **ctx.conv)
                  if ctx.needs_input_grad[0] else None)
            dw = (torch.nn.grad.conv2d_weight(x, w.shape, dy, **ctx.conv)
                  if ctx.needs_input_grad[1] else None)
        return dx, dw, None, None


class _Linear(torch.autograd.Function):
    """x [N, in] @ w [in, out] + b [out], forward and backward under
    ``fp32_math``."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with fp32_math():
            return x @ w + b

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        with fp32_math():
            dx = dy @ w.T if ctx.needs_input_grad[0] else None
            dw = x.T @ dy if ctx.needs_input_grad[1] else None
        db = dy.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def conv2d_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """``F.conv2d(x, w, stride=stride, padding=padding)``, in full f32 both
    ways."""
    return _Conv2d.apply(x, w, stride, padding)


def linear_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` (w [in, out], JAX's layout), in full f32 both ways."""
    return _Linear.apply(x, w, b)
