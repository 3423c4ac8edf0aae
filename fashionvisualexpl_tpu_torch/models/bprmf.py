"""BPR-MF: matrix factorization with item bias (port of
``fashionvisualexpl_tpu/models/bprmf.py``).

Scoring x_ui = b_i + <gamma_u, gamma_i>, full matrix Bi + Gu @ Gi^T.
Not ported yet: ``loss``, ``packed_spec`` and ``packed_loss`` — they come
with training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.models.base import (
    RecommenderModel,
    glorot_uniform,
)


class BPRMF(RecommenderModel):
    """Parameters ``Gu [U, K]``, ``Gi [I, K]`` (GlorotUniform) and
    ``Bi [I]`` (zeros), all float32, on ``device`` (``None`` = the CUDA card;
    raises without one).  ``generator`` draws the init; ``None`` uses a fresh
    generator seeded with 0 on that device."""

    name = "bprmf"

    def __init__(
        self,
        num_users: int,
        num_items: int,
        embed_k: int = 128,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(num_users, num_items)
        self.embed_k = embed_k
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.Bi = nn.Parameter(torch.zeros(num_items, device=dev))
        self.Gu = nn.Parameter(
            glorot_uniform((num_users, embed_k), generator, dev)
        )
        self.Gi = nn.Parameter(
            glorot_uniform((num_items, embed_k), generator, dev)
        )

    def score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        return self.Bi[items] + (self.Gu[users] * self.Gi[items]).sum(dim=1)

    def factored_eval(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Factored scores for the serving index (serve/engine.py)."""
        return self.Gu, self.Gi, self.Bi

    def predict_all(self) -> torch.Tensor:
        return self.Bi[None, :] + self.Gu @ self.Gi.T

    def predict_user_block(
        self, user_ids: torch.Tensor, ctx: Optional[object] = None
    ) -> torch.Tensor:
        del ctx
        return self.Bi[None, :] + self.Gu[user_ids] @ self.Gi.T
