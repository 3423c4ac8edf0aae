"""Compute-dtype policy for the encoder towers (port of
``fashionvisualexpl_tpu/core/precision.py``).

The JAX package lets the FLOP-heavy trainable towers opt into bfloat16
compute (``compute_dtype``) while params, loss and long reductions stay
float32.  The port names the same two dtypes and keeps the same casts; only
float32 runs so far: a bfloat16 tower needs a bfloat16 edge-tower kernel,
and ``AttentiveFashion(compute_dtype="bfloat16")`` raises naming its
ROADMAP item (bf16 encoder towers).
"""

from __future__ import annotations

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
