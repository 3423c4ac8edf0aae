"""Fused Adam sweep (port of ``fashionvisualexpl_tpu/ops/adam.py``).

The sparse-apply fast path (train/fast.py) ends each step with a full-table
elementwise sweep: decay both moments and apply the bias-corrected update.
The hand-written CUDA kernel of ``csrc/adam.cu`` (K6) does the sweep in ONE
in-place pass: read m, v, p once, write them once (the device-memory floor
for an optimizer whose whole state changes every step).  Plain torch ops
would make four table-sized temporaries on the way.

Exactness trick used by the caller: the gradient scatter happens BEFORE the
sweep with pre-scaled contributions ((1-b)/b * g), so the sweep's uniform
decay produces b*m + (1-b)*g on touched rows and b*m elsewhere, rounded as
the JAX package rounds it.

``fused_adam_sweep`` launches the kernel for CUDA tensors (or raises) and
takes the plain version ``fused_adam_sweep_reference`` for CPU tensors only;
``fused_adam_sweep.launches`` counts kernel launches.  The state is updated
in place (JAX donates it); the tensors are also returned.
"""

from __future__ import annotations

import ctypes

import torch

from fashionvisualexpl_tpu_torch.train.fast import B1, B2, EPS, prescaled_scatter


def adam_scalars(lr: float, t: torch.Tensor) -> torch.Tensor:
    """[lr/(1 - B1^t), 1/(1 - B2^t)] as float32 on t's device, computed in
    float32 from the float32 step ``t`` (0-d), as the TPU kernel's caller
    does; divisions by device tensors, so they round as true divisions."""
    one = torch.ones((), dtype=torch.float32, device=t.device)
    return torch.stack([
        torch.full_like(one, lr) / (1.0 - torch.pow(B1, t)),
        one / (1.0 - torch.pow(B2, t)),
    ])


def fused_adam_sweep_reference(p, m, v, scal):
    """Plain torch version of the sweep, in place; returns (p, m, v)."""
    lr_t1, inv_bc2 = scal[0], scal[1]
    m.mul_(B1)
    v.mul_(B2)
    p.sub_(lr_t1 * m / (torch.sqrt(v * inv_bc2) + EPS))
    return p, m, v


def _library() -> ctypes.CDLL:
    from fashionvisualexpl_tpu_torch.ops.cuda_build import load_library

    lib = load_library("adam")
    if not getattr(lib, "_fvx_typed", False):
        lib.fvx_adam_sweep.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
        )
        lib.fvx_adam_sweep.restype = ctypes.c_int
        lib._fvx_typed = True
    return lib


@torch.no_grad()
def fused_adam_sweep(p, m, v, scal):
    """In-place decay + update sweep.  p/m/v same shape (1-D or 2-D),
    float32, contiguous; ``scal`` = ``adam_scalars(lr, t)`` for the new
    step count t, on their device."""
    if not (p.shape == m.shape == v.shape):
        raise ValueError(
            f"p, m, v shapes differ: {tuple(p.shape)}, {tuple(m.shape)}, "
            f"{tuple(v.shape)}"
        )
    for t_ in (p, m, v, scal):
        if t_.dtype != torch.float32 or t_.device != p.device:
            raise ValueError("p, m, v and scal must be float32 on one device")
    if scal.shape != (2,):
        raise ValueError(f"scal must be [2], got {tuple(scal.shape)}")
    if p.device.type == "cpu":
        return fused_adam_sweep_reference(p, m, v, scal)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam_sweep: unsupported device {p.device}")
    for name, t_ in (("p", p), ("m", m), ("v", v), ("scal", scal)):
        if not t_.is_contiguous():
            raise ValueError(f"fused_adam_sweep: {name} must be contiguous")
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().fvx_adam_sweep(p.data_ptr(), m.data_ptr(), v.data_ptr(),
                                       scal.data_ptr(), p.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"Adam sweep kernel launch failed: cudaError {rc}")
    fused_adam_sweep.launches += 1
    return p, m, v


fused_adam_sweep.launches = 0


@torch.no_grad()
def sparse_adam_table_fused(p, m, v, uids, g, scal):
    """``train/fast.py::sparse_adam_table`` with the fused sweep: the
    pre-scaled scatter of (1-b)/b * g and (1-b)/b * g^2 into m and v on the
    touched rows, then one sweep.  ``uids`` may hold out-of-range pads
    (``compact_row_grads``) whose ``g`` rows are zero; ``scal`` =
    ``adam_scalars(lr, t)``."""
    prescaled_scatter(m, v, uids, g)
    return fused_adam_sweep(p, m, v, scal)
