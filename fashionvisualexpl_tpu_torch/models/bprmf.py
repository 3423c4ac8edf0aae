"""BPR-MF: matrix factorization with item bias (port of
``fashionvisualexpl_tpu/models/bprmf.py``).

Scoring x_ui = b_i + <gamma_u, gamma_i>, full matrix Bi + Gu @ Gi^T, and
the BPR loss with its reference quirks (BPRMF.py:104-112): clip(-80, 1e8) on
the score difference and the negative item bias regularised at reg/10.  ``packed_spec`` /
``packed_loss`` put it on the packed LazyAdam engine: Gu in the user rows,
Gi with Bi folded into the item rows.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.models.base import (
    PackedSpec,
    RecommenderModel,
    bpr_pairwise_loss,
    glorot_uniform,
    l2_loss,
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

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the init anew in place, in ``__init__``'s order (Gu, Gi)."""
        dev = self.device
        self.Bi.zero_()
        self.Gu.copy_(glorot_uniform(tuple(self.Gu.shape), generator, dev))
        self.Gi.copy_(glorot_uniform(tuple(self.Gi.shape), generator, dev))

    def score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        return self.Bi[items] + (self.Gu[users] * self.Gi[items]).sum(dim=1)

    def loss(
        self,
        users: torch.Tensor,
        pos: torch.Tensor,
        neg: torch.Tensor,
        reg: float,
        rng=None,
    ) -> torch.Tensor:
        """Summed BPR loss over the triples plus the reference's L2 terms
        (BPRMF.py:108-112): embeddings and positive bias at ``reg``,
        negative bias at ``reg / 10``, every term times 2.  ``rng`` (the
        trainer's per-step dropout generator) is unused: BPRMF has no
        stochastic layer."""
        del rng
        gamma_u = self.Gu[users]
        beta_pos = self.Bi[pos]
        gamma_pos = self.Gi[pos]
        beta_neg = self.Bi[neg]
        gamma_neg = self.Gi[neg]

        x_pos = beta_pos + torch.sum(gamma_u * gamma_pos, dim=1)
        x_neg = beta_neg + torch.sum(gamma_u * gamma_neg, dim=1)
        loss = bpr_pairwise_loss(x_pos, x_neg)
        reg_loss = (
            reg * (l2_loss(gamma_u) + l2_loss(gamma_pos) + l2_loss(gamma_neg)) * 2.0
            + reg * l2_loss(beta_pos) * 2.0
            + reg * l2_loss(beta_neg) * 2.0 / 10.0
        )
        return loss + reg_loss

    # --- packed LazyAdam engine (train/packed_generic.py) ---

    def packed_spec(self) -> PackedSpec:
        return PackedSpec(
            user_tables=(("Gu", self.embed_k),),
            item_tables=(("Gi", self.embed_k),),
            item_scalars=("Bi",),
            dense=(),
        )

    def packed_loss(self, user_vw, pos_vw, neg_vw, dense, frozen, ids,
                    reg, rng=None):
        """``loss`` over the gathered rows (the same terms, the same
        order)."""
        gu = user_vw["Gu"]
        gp, gn = pos_vw["Gi"], neg_vw["Gi"]
        bp, bn = pos_vw["Bi"], neg_vw["Bi"]
        x_pos = bp + torch.sum(gu * gp, dim=1)
        x_neg = bn + torch.sum(gu * gn, dim=1)
        loss = bpr_pairwise_loss(x_pos, x_neg)
        return loss + (
            reg * (l2_loss(gu) + l2_loss(gp) + l2_loss(gn)) * 2.0
            + reg * l2_loss(bp) * 2.0
            + reg * l2_loss(bn) * 2.0 / 10.0
        )

    def factored_eval(
        self, params: Optional[Mapping[str, torch.Tensor]] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Factored scores for the serving index and the streaming
        evaluator, from ``params`` (name -> tensor) or the model's own."""
        p = self.params_or_own(params)
        return p["Gu"], p["Gi"], p["Bi"]

    def predict_all(self) -> torch.Tensor:
        return self.Bi[None, :] + self.Gu @ self.Gi.T

    def predict_user_block(
        self,
        user_ids: torch.Tensor,
        ctx: Optional[object] = None,
        params: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        del ctx
        p = self.params_or_own(params)
        return p["Bi"][None, :] + p["Gu"][user_ids] @ p["Gi"].T
