"""VBPR: BPRMF plus frozen visual features with a learned projection (port
of ``fashionvisualexpl_tpu/models/vbpr.py``).

Capability parity with reference src/recommender/models/VBPR.py: scoring
adds <theta_u, E^T f_i> + f_i . Bp (VBPR.py:82-84), the full matrix adds
Tu @ (F E)^T + F Bp (VBPR.py:95-97), and the regularization extends to
{Tu, E, Bp}, with E and Bp regularized as whole matrices each step
(VBPR.py:121-127).

The feature matrix ``F`` [I, dim_f] is a non-persistent buffer: checkpoints
hold the parameters only, as the JAX package's do (a 500k x 4096 ``F`` is
8.2 GB).  The evaluators and the server read the projected item factors
``F @ E`` and ``F @ Bp``, computed once per evaluation or refresh
(``item_factors``); factored, a user is [Gu | Tu] and an item [Gi | F E],
D = embed_k + embed_d wide.
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


class ProjectedItemScores:
    """The scoring methods shared by VBPR and GradFashion, whose items
    carry projected visual factors ``item_factors(params) -> (theta_i
    [I, d], vis_bias [I])``: x_ui = Bi + <Gu, Gi> + <Tu, theta_i> +
    vis_bias."""

    def factored_eval(
        self, params: Optional[Mapping[str, torch.Tensor]] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """u = [Gu | Tu], v = [Gi | theta_i], b = Bi + vis_bias, for the
        streaming evaluator and the serving index."""
        p = self.params_or_own(params)
        theta_i, vis_bias = self.item_factors(params)
        uf = torch.cat([p["Gu"], p["Tu"]], dim=1)
        vf = torch.cat([p["Gi"], theta_i], dim=1)
        return uf, vf, p["Bi"] + vis_bias

    def predict_all(self) -> torch.Tensor:
        theta_i, vis_bias = self.item_factors()
        return (self.Bi[None, :] + self.Gu @ self.Gi.T + self.Tu @ theta_i.T
                + vis_bias[None, :])

    def precompute_eval(self, params: Optional[Mapping[str, torch.Tensor]] = None):
        """The projected item factors, computed once per evaluation (the
        evaluator passes them back as ``ctx`` to every user block)."""
        return self.item_factors(params)

    def predict_user_block(
        self,
        user_ids: torch.Tensor,
        ctx: Optional[object] = None,
        params: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        p = self.params_or_own(params)
        theta_i, vis_bias = ctx if ctx is not None else self.item_factors(params)
        return (p["Bi"][None, :] + p["Gu"][user_ids] @ p["Gi"].T
                + p["Tu"][user_ids] @ theta_i.T + vis_bias[None, :])


class VBPR(ProjectedItemScores, RecommenderModel):
    """Parameters ``Bi [I]`` (zeros), ``Gu [U, K]``, ``Gi [I, K]``, ``Tu [U,
    d]``, ``E [dim_f, d]``, ``Bp [dim_f, 1]`` (GlorotUniform), float32 on
    ``device`` (``None`` = the CUDA card; raises without one);
    ``features`` [I, dim_f] maxabs-normalized, numpy or a tensor.
    ``generator`` draws the init; ``None`` seeds a fresh one with 0."""

    name = "vbpr"

    def __init__(
        self,
        num_users: int,
        num_items: int,
        features: Features,
        embed_k: int = 128,
        embed_d: int = 20,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(num_users, num_items)
        if features.shape[0] != num_items:
            raise ValueError(
                f"features rows {features.shape[0]} != num_items {num_items}"
            )
        self.embed_k = embed_k
        self.embed_d = embed_d
        self.dim_f = int(features.shape[1])
        dev = resolve_device(device)
        self.register_buffer("F", frozen_buffer(features, dev), persistent=False)

        def empty(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        self.Bi = empty(num_items)
        self.Gu = empty(num_users, embed_k)
        self.Gi = empty(num_items, embed_k)
        self.Tu = empty(num_users, embed_d)
        self.E = empty(self.dim_f, embed_d)
        self.Bp = empty(self.dim_f, 1)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the init anew in place, in the JAX init's order: Gu, Gi, Tu,
        E, Bp; Bi zeros."""
        self.Bi.zero_()
        for p in (self.Gu, self.Gi, self.Tu, self.E, self.Bp):
            p.copy_(glorot_uniform(tuple(p.shape), generator, self.device))

    def _scores(self, beta_i, gamma_u, gamma_i, theta_u, f_i, E, Bp):
        return (beta_i + torch.sum(gamma_u * gamma_i, dim=1)
                + torch.sum(theta_u * (f_i @ E), dim=1) + (f_i @ Bp)[:, 0])

    def score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        return self._scores(self.Bi[items], self.Gu[users], self.Gi[items],
                            self.Tu[users], self.F[items], self.E, self.Bp)

    def _bpr_loss(self, gu, tu, gp, gn, bp, bn, fp, fn, E, Bp, reg):
        """The summed BPR loss and the reference's L2 terms (VBPR.py:121-127):
        batch embeddings, positive bias at ``reg``, negative bias at ``reg /
        10``, the whole E and Bp at ``global_reg_scale * reg``; each
        times 2."""
        x_pos = self._scores(bp, gu, gp, tu, fp, E, Bp)
        x_neg = self._scores(bn, gu, gn, tu, fn, E, Bp)
        loss = bpr_pairwise_loss(x_pos, x_neg)
        return loss + (
            reg * (l2_loss(gu) + l2_loss(gp) + l2_loss(gn) + l2_loss(tu)) * 2.0
            + reg * l2_loss(bp) * 2.0
            + reg * l2_loss(bn) * 2.0 / 10.0
            + self.global_reg_scale * reg * (l2_loss(E) + l2_loss(Bp)) * 2.0
        )

    def row_sharded_params(self):
        return ("Bi", "Gu", "Gi", "Tu", "F")

    def loss(self, users, pos, neg, reg: float, rng=None) -> torch.Tensor:
        """``rng`` is unused: VBPR has no stochastic layer."""
        del rng
        t = self.take
        return self._bpr_loss(t("Gu", self.Gu, users), t("Tu", self.Tu, users),
                              t("Gi", self.Gi, pos), t("Gi", self.Gi, neg),
                              t("Bi", self.Bi, pos), t("Bi", self.Bi, neg),
                              t("F", self.F, pos), t("F", self.F, neg), self.E, self.Bp, reg)

    # --- packed LazyAdam engine (train/packed_generic.py) ---

    def packed_spec(self) -> PackedSpec:
        return PackedSpec(
            user_tables=(("Gu", self.embed_k), ("Tu", self.embed_d)),
            item_tables=(("Gi", self.embed_k),),
            item_scalars=("Bi",),
            dense=("E", "Bp"),
            frozen_item_tables=(("F", self.dim_f),),
        )

    def packed_loss(self, user_vw, pos_vw, neg_vw, dense, frozen, ids,
                    reg, rng=None, frozen_vw=None):
        """``loss`` over the gathered rows.  ``frozen_vw`` holds the F rows
        sliced out of the packed item rows (``fused_frozen``); without it F
        is read by id from ``frozen``."""
        _, p_ids, n_ids = ids
        if frozen_vw is not None:
            fp, fn = frozen_vw["pos"]["F"], frozen_vw["neg"]["F"]
        else:
            fp, fn = self.take("F", frozen["F"], p_ids), self.take("F", frozen["F"], n_ids)
        return self._bpr_loss(user_vw["Gu"], user_vw["Tu"], pos_vw["Gi"], neg_vw["Gi"],
                              pos_vw["Bi"], neg_vw["Bi"], fp, fn, dense["E"], dense["Bp"],
                              reg)

    def item_factors(
        self, params: Optional[Mapping[str, torch.Tensor]] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(theta_i = F @ E [I, d], vis_bias = F @ Bp [I])."""
        p = self.params_or_own(params)
        return self.F @ p["E"], (self.F @ p["Bp"])[:, 0]
