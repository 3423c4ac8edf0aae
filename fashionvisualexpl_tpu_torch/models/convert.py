"""Carry the JAX package's parameters and train states into the port, bit
for bit.

The JAX package's params are a dict of arrays; hand them over as numpy
(``{k: np.asarray(v) for k, v in params.items()}``) so this module needs no
JAX.  The copy is exact, so both packages then compute on the same weights,
and a mid-run optimizer state (step, moments, last-touch steps) carries
across as well.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
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


def _tensors(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.require(np.asarray(v), requirements=["C", "W"])).to(dev)
        for k, v in arrays.items()
    }


def _count(x, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                        device=resolve_device(device))


def fast_state_from_jax(
    step,
    params: Dict[str, np.ndarray],
    mu: Dict[str, np.ndarray],
    nu: Dict[str, np.ndarray],
    tau: Optional[Dict[str, np.ndarray]] = None,
    device: DeviceLike = None,
):
    """The port's ``FastState`` (or ``LazyFastState`` with ``tau``) holding
    exactly a JAX fast-path state, handed over as numpy (``step`` scalar,
    dicts of arrays), so mid-run states of the two packages compare."""
    from fashionvisualexpl_tpu_torch.train.fast import FastState, LazyFastState

    base = (_count(step, device), _tensors(params, device),
            _tensors(mu, device), _tensors(nu, device))
    if tau is None:
        return FastState(*base)
    return LazyFastState(*base, _tensors(tau, device))


def train_state_from_jax(
    model: BPRMF,
    step,
    params: Dict[str, np.ndarray],
    count,
    mu: Dict[str, np.ndarray],
    nu: Dict[str, np.ndarray],
):
    """The port's ``TrainState`` for the generic trainer from a JAX
    ``TrainState`` handed over as numpy: ``params`` are copied into
    ``model``'s own parameters (which the state then holds); ``count``,
    ``mu`` and ``nu`` are optax's ``ScaleByAdamState`` fields."""
    from fashionvisualexpl_tpu_torch.core.train_state import AdamState, TrainState

    dev = model.device
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(_f32(params, name, p.dim())))
    return TrainState(
        _count(step, dev), dict(model.named_parameters()),
        AdamState(_count(count, dev), _tensors(mu, dev), _tensors(nu, dev)),
    )
