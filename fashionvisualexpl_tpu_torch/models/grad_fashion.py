"""GradFashion: explainable VBPR over two frozen low-level feature families
(port of ``fashionvisualexpl_tpu/models/grad_fashion.py``).

Capability parity with reference src/recommender/models/GradFashion.py:
color (Fc / Ec) and edge (Fe / Ee) families projected and concatenated
(GradFashion.py:105-116), scoring b_i + <gamma_u, gamma_i> + <theta_u,
theta_i> + vf_i . Bp (GradFashion.py:121-126), and the gradient-x-input
explanations (GradFashion.py:269-302).

The reference's regularization here does NOT divide the negative bias by
10 (GradFashion.py:171-181): both biases are at full reg.  Reproduced.

The score is affine in an item's features, so d(score)/d(color_i) and
d(score)/d(edges_i) depend on the user only: the attributions take that
gradient in closed form, once per user (the order of autodiff's
vector-Jacobian products: d/dvf = E theta_u + Bp, then through Ec and Ee),
and dot it with each item's features.  ``Fc`` and ``Fe`` are non-persistent
buffers, as VBPR's ``F``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.models.base import (
    Features,
    PackedSpec,
    RecommenderModel,
    bpr_pairwise_loss,
    frozen_buffer,
    glorot_uniform,
    l2_loss,
)
from fashionvisualexpl_tpu_torch.models.vbpr import ProjectedItemScores


class GradFashion(ProjectedItemScores, RecommenderModel):
    """Parameters ``Bi [I]`` (zeros), ``Gu [U, K]``, ``Gi [I, K]``, ``Ec
    [dim_c, embed_color]``, ``Ee [dim_e, embed_edges]``, ``Bp [d_vf, 1]``,
    ``E [d_vf, d]``, ``Tu [U, d]`` (GlorotUniform; d_vf = embed_color +
    embed_edges) on ``device`` (``None`` = the CUDA card); frozen
    ``color_features`` [I, dim_c] and ``edge_features`` [I, dim_e]."""

    name = "grad_fashion"

    def __init__(
        self,
        num_users: int,
        num_items: int,
        color_features: Features,
        edge_features: Features,
        embed_k: int = 128,
        embed_d: int = 20,
        embed_color: int = 32,
        embed_edges: int = 32,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(num_users, num_items)
        for f, nm in ((color_features, "color"), (edge_features, "edge")):
            if f.shape[0] != num_items:
                raise ValueError(f"{nm} features rows != num_items")
        self.embed_k = embed_k
        self.embed_d = embed_d
        self.embed_color = embed_color
        self.embed_edges = embed_edges
        self.dim_c = int(color_features.shape[1])
        self.dim_e = int(edge_features.shape[1])
        dev = resolve_device(device)
        self.register_buffer("Fc", frozen_buffer(color_features, dev), persistent=False)
        self.register_buffer("Fe", frozen_buffer(edge_features, dev), persistent=False)

        def empty(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        d_vf = embed_color + embed_edges
        self.Bi = empty(num_items)
        self.Gu = empty(num_users, embed_k)
        self.Gi = empty(num_items, embed_k)
        self.Ec = empty(self.dim_c, embed_color)
        self.Ee = empty(self.dim_e, embed_edges)
        self.Bp = empty(d_vf, 1)
        self.E = empty(d_vf, embed_d)
        self.Tu = empty(num_users, embed_d)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the init anew in place, in the JAX init's order: Gu, Gi, Ec,
        Ee, Bp, E, Tu; Bi zeros."""
        self.Bi.zero_()
        for p in (self.Gu, self.Gi, self.Ec, self.Ee, self.Bp, self.E, self.Tu):
            p.copy_(glorot_uniform(tuple(p.shape), generator, self.device))

    # --- scoring pieces ---

    @staticmethod
    def _visual_features(Ec, Ee, color_i, edges_i):
        """concat([color @ Ec, edges @ Ee]) (GradFashion.py:112-116)."""
        return torch.cat([color_i @ Ec, edges_i @ Ee], dim=-1)

    def _score_from_feats(self, p, gamma_u, theta_u, gamma_i, beta_i, color_i, edges_i):
        vf = self._visual_features(p["Ec"], p["Ee"], color_i, edges_i)
        return (beta_i + torch.sum(gamma_u * gamma_i, dim=-1)
                + torch.sum(theta_u * (vf @ p["E"]), dim=-1) + (vf @ p["Bp"])[..., 0])

    def score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        return self._score_from_feats(
            dict(self.named_parameters()), self.Gu[users], self.Tu[users], self.Gi[items],
            self.Bi[items], self.Fc[items], self.Fe[items])

    def _bpr_loss(self, p, gu, tu, gp, gn, bp, bn, cp, cn, ep, en, reg):
        """The summed BPR loss and the reference's L2 terms: batch
        embeddings and both biases at ``reg`` (no /10), the whole Ec, Ee, E,
        Bp at ``global_reg_scale * reg``; each times 2.  ``p`` holds the
        dense params."""
        x_pos = self._score_from_feats(p, gu, tu, gp, bp, cp, ep)
        x_neg = self._score_from_feats(p, gu, tu, gn, bn, cn, en)
        loss = bpr_pairwise_loss(x_pos, x_neg)
        return loss + (
            reg * (l2_loss(gu) + l2_loss(gp) + l2_loss(gn) + l2_loss(tu)) * 2.0
            + reg * (l2_loss(bp) + l2_loss(bn)) * 2.0
            + self.global_reg_scale * reg
            * (l2_loss(p["Ec"]) + l2_loss(p["Ee"]) + l2_loss(p["E"]) + l2_loss(p["Bp"]))
            * 2.0
        )

    def row_sharded_params(self):
        return ("Bi", "Gu", "Gi", "Tu", "Fc", "Fe")

    def loss(self, users, pos, neg, reg: float, rng=None) -> torch.Tensor:
        """``rng`` is unused: GradFashion has no stochastic layer."""
        del rng
        t = self.take
        return self._bpr_loss(
            dict(self.named_parameters()), t("Gu", self.Gu, users), t("Tu", self.Tu, users),
            t("Gi", self.Gi, pos), t("Gi", self.Gi, neg), t("Bi", self.Bi, pos),
            t("Bi", self.Bi, neg), t("Fc", self.Fc, pos), t("Fc", self.Fc, neg),
            t("Fe", self.Fe, pos), t("Fe", self.Fe, neg), reg)

    # --- packed LazyAdam engine (train/packed_generic.py) ---

    def packed_spec(self) -> PackedSpec:
        return PackedSpec(
            user_tables=(("Gu", self.embed_k), ("Tu", self.embed_d)),
            item_tables=(("Gi", self.embed_k),),
            item_scalars=("Bi",),
            dense=("E", "Bp", "Ec", "Ee"),
            frozen_item_tables=(("Fc", self.dim_c), ("Fe", self.dim_e)),
        )

    def packed_loss(self, user_vw, pos_vw, neg_vw, dense, frozen, ids,
                    reg, rng=None, frozen_vw=None):
        """``loss`` over the gathered rows; ``frozen_vw`` as for VBPR."""
        _, p_ids, n_ids = ids
        if frozen_vw is not None:
            cp, cn = frozen_vw["pos"]["Fc"], frozen_vw["neg"]["Fc"]
            ep, en = frozen_vw["pos"]["Fe"], frozen_vw["neg"]["Fe"]
        else:
            t = self.take
            cp, cn = t("Fc", frozen["Fc"], p_ids), t("Fc", frozen["Fc"], n_ids)
            ep, en = t("Fe", frozen["Fe"], p_ids), t("Fe", frozen["Fe"], n_ids)
        return self._bpr_loss(dense, user_vw["Gu"], user_vw["Tu"], pos_vw["Gi"],
                              neg_vw["Gi"], pos_vw["Bi"], neg_vw["Bi"], cp, cn, ep, en, reg)

    def item_factors(
        self, params: Optional[Mapping[str, torch.Tensor]] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(theta_i = vf @ E [I, d], vis_bias = vf @ Bp [I]), vf the
        concatenated projected families [I, d_vf]."""
        p = self.params_or_own(params)
        vf = self._visual_features(p["Ec"], p["Ee"], self.Fc, self.Fe)
        return vf @ p["E"], (vf @ p["Bp"])[:, 0]

    # --- explanations (GradFashion.py:269-302) ---

    def _feature_grads(self, p, users: torch.Tensor):
        """(d score / d color_i [B, dim_c], d score / d edges_i [B, dim_e])
        of each user in ``users``: the same for every item."""
        g_vf = p["Tu"][users] @ p["E"].T + p["Bp"][:, 0]  # [B, d_vf]
        ec = self.embed_color
        return g_vf[:, :ec] @ p["Ec"].T, g_vf[:, ec:] @ p["Ee"].T

    @torch.no_grad()
    def feature_attributions_block(
        self, users: torch.Tensor, items: torch.Tensor,
        params: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Gradient-x-input attributions, users [B], items [B, W] -> [B, W,
        2] (color, edges): sum_j d(score)/d(feat_j) * feat_j per family."""
        gc, ge = self._feature_grads(self.params_or_own(params), users.long())
        items = items.long()
        color = torch.bmm(self.Fc[items], gc[:, :, None])[..., 0]
        edges = torch.bmm(self.Fe[items], ge[:, :, None])[..., 0]
        return torch.stack([color, edges], dim=-1)

    def feature_attributions(
        self, user: int, items: torch.Tensor,
        params: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """[len(items), 2] attributions of one user's ``items``."""
        users = torch.full((1,), int(user), dtype=torch.long, device=self.device)
        return self.feature_attributions_block(users, items[None], params)[0]
