"""Carry the JAX package's parameters into the port's modules, bit for bit.

The JAX package's params are a dict of arrays; hand them over as numpy
(``{k: np.asarray(v) for k, v in params.items()}``) so this module needs no
JAX.  The copy is exact, so both packages then compute on the same weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF


def _f32(params: Dict[str, np.ndarray], name: str, ndim: int) -> np.ndarray:
    arr = np.asarray(params[name])
    if arr.dtype != np.float32 or arr.ndim != ndim:
        raise ValueError(
            f"{name}: expected a {ndim}-d float32 array, got "
            f"{arr.ndim}-d {arr.dtype}"
        )
    # torch tensors need writable memory; copies only a read-only array
    return np.require(arr, requirements=["C", "W"])


def bprmf_from_jax(
    params: Dict[str, np.ndarray], device: DeviceLike = None
) -> BPRMF:
    """A ``BPRMF`` holding exactly the JAX BPRMF's ``Gu``, ``Gi``, ``Bi``."""
    gu, gi, bi = _f32(params, "Gu", 2), _f32(params, "Gi", 2), _f32(params, "Bi", 1)
    if gu.shape[1] != gi.shape[1] or bi.shape[0] != gi.shape[0]:
        raise ValueError(
            f"inconsistent shapes Gu {gu.shape} Gi {gi.shape} Bi {bi.shape}"
        )
    model = BPRMF(gu.shape[0], gi.shape[0], embed_k=gu.shape[1], device=device)
    with torch.no_grad():
        for p, arr in ((model.Gu, gu), (model.Gi, gi), (model.Bi, bi)):
            p.copy_(torch.from_numpy(arr))
    return model
