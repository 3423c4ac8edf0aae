"""Model base and shared init (port of ``fashionvisualexpl_tpu/models/base.py``).

In the JAX package a model is a stateless object over explicit ``(params,
frozen)`` pytrees.  In the port a model is an ``nn.Module`` that owns its
parameters, and the scoring methods read them from ``self``.  Random init
takes an explicit ``torch.Generator``; JAX's threefry draws cannot be
reproduced, so parity tests carry JAX's params across with
``models/convert.py`` instead.

Not ported yet: ``PackedSpec`` — it comes with the packed engine.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def l2_loss(x: torch.Tensor) -> torch.Tensor:
    """tf.nn.l2_loss parity: 0.5 * sum(x**2)."""
    return 0.5 * torch.sum(torch.square(x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with logaddexp's gradient exp(x - softplus(x))."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def bpr_pairwise_loss(x_pos: torch.Tensor, x_neg: torch.Tensor) -> torch.Tensor:
    """Summed BPR triplet loss with the reference's clip quirk
    (BPRMF.py:104-106): softplus(-clip(x_pos - x_neg, -80, 1e8))."""
    diff = torch.clamp(x_pos - x_neg, -80.0, 1e8)
    return torch.sum(softplus(-diff))


def glorot_uniform(
    shape: Tuple[int, int],
    generator: torch.Generator,
    device: torch.device,
) -> torch.Tensor:
    """GlorotUniform (tf.initializers.GlorotUniform / jax glorot_uniform):
    U(-l, l) with l = sqrt(6 / (fan_in + fan_out)), fan_in = shape[-2],
    fan_out = shape[-1]."""
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.uniform_(-limit, limit, generator=generator)


class RecommenderModel(nn.Module):
    """Base interface.  Concrete models implement:

    - score(users, items) -> [B] pointwise scores
    - predict_all() -> [U, I] full score matrix
    - predict_user_block(user_ids) -> [B_u, I] score rows
    - factored_eval() -> (user [U, D], item [I, D], item bias [I] or None),
      for models whose scores factor (the serving index path)
    """

    name: str = "base"

    def __init__(self, num_users: int, num_items: int):
        super().__init__()
        self.num_users = num_users
        self.num_items = num_items

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def predict_all(self) -> torch.Tensor:
        raise NotImplementedError

    def predict_user_block(
        self, user_ids: torch.Tensor, ctx: Optional[object] = None
    ) -> torch.Tensor:
        raise NotImplementedError
