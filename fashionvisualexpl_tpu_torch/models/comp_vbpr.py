"""CompVBPR: component-ablatable VBPR over four visual feature families (port
of ``fashionvisualexpl_tpu/models/comp_vbpr.py``; reference
src/recommender/models/CompVBPR.py).

The four families (semantic / color / edges / texture, the reference's
``activated_components`` order, CompVBPR.py:38-52) are toggled by
``activated_components`` and mixed by ``weight_components``
(CompVBPR.py:33-34, scoring :190-200):

- semantic / color / texture: a frozen feature matrix ``F*`` [I, dim] with
  a learned projection ``E*`` [dim, d], a user profile ``Tu*`` [U, d] and a
  visual bias ``Bp*`` [dim, 1]; the family adds ``w * (<Tu*_u, F*_i E*> +
  F*_i . Bp*)``;
- edges: the trainable AlexNet-style ``CNN`` (``models/cnn.py``, the
  submodule ``cnn``, parameters ``"cnn.conv1_W"`` ...) encodes the item's
  edge image to ``theta_e`` [d] in the step; the family adds ``w *
  (<Tue_u, theta_e_i> + theta_e_i . Bpe)`` (the bias on the encoded
  vector, CompVBPR.py:199).

With every family off it is BPRMF (``Bi``, ``Gu``, ``Gi``).  The frozen
inputs ``Fs``, ``Fc``, ``Fe_img`` and ``Ft`` of the active families are
non-persistent buffers: checkpoints hold the parameters only.

The loss (CompVBPR.py:264-293) is BPR with the clip(-80, 1e8) quirk; L2 on
the batch rows of Gu, Gi and the active ``Tu*``, the positive bias at
``reg`` and the negative at ``reg / 10``; and on the whole ``E*`` / ``Bp*``
and the CNN's non-bias weights times ``global_reg_scale``.  Dropout in the
CNN (fc6, fc7): ``rng`` is a ``torch.Generator`` or the keep-masks in
order, the positives' tower (fc6, fc7) then the negatives'.

Evaluation encodes every item's edge image once (``encode_all_edges``, in
``eval_encode_block`` blocks, the last padded with zero images, under
``no_grad``); factored, a user is [Gu | w_s Tus | w_c Tuc | w_e Tue | w_t
Tut] and an item [Gi | Fs Es | Fc Ec | theta_e | Ft Et], D = K + 4 d (208 at
the CLI's K=128, d=20), with the item bias Bi plus the weighted visual
biases.

``packed_spec`` / ``packed_loss`` put it on the packed LazyAdam engine: Gu
and the active ``Tu*`` in the user rows, Gi and Bi in the item rows, the
projections, the visual biases and the ``cnn`` group as dense params.

Not ported yet: ``compute_dtype="bfloat16"`` (ROADMAP: bf16 encoder
towers), which raises.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.core.precision import resolve_compute_dtype
from fashionvisualexpl_tpu_torch.models.base import (
    Dropout,
    Features,
    MaskDraw,
    PackedSpec,
    RecommenderModel,
    bpr_pairwise_loss,
    frozen_buffer,
    glorot_uniform,
    l2_loss,
    param_group,
)
from fashionvisualexpl_tpu_torch.models.cnn import CNN

# the reference's activated_components order (CompVBPR.py:38-52)
FAMILIES = ("semantic", "color", "edges", "texture")
# per family: the user profile, the frozen input, the projection (None for
# the CNN) and the visual bias
USER_TABLES = ("Tus", "Tuc", "Tue", "Tut")
FROZEN = ("Fs", "Fc", "Fe_img", "Ft")
PROJ = ("Es", "Ec", None, "Et")
BIAS = ("Bps", "Bpc", "Bpe", "Bpt")
# the whole-matrix regularized params, in the JAX loss's order
WHOLE = ("Es", "Ec", "Et", "Bps", "Bpc", "Bpt", "Bpe")


class CompVBPR(RecommenderModel):
    """See the module docstring.  The feature matrices (numpy, or tensors
    made on the card) and ``edge_images`` [I, H, W, C] are those of the
    families to activate; ``activated_components`` defaults to the families
    given.  Parameters and buffers live on ``device`` (``None`` = the CUDA
    card; raises without one); ``generator`` draws the init (``None``: a
    fresh one seeded with 0)."""

    name = "comp_vbpr"

    def __init__(
        self,
        num_users: int,
        num_items: int,
        semantic_features: Optional[Features] = None,  # [I, dim_s]
        color_features: Optional[Features] = None,  # [I, dim_c]
        edge_images: Optional[Features] = None,  # [I, H, W, C]
        texture_features: Optional[Features] = None,  # [I, dim_t]
        embed_k: int = 128,
        embed_d: int = 20,
        activated_components: Optional[Tuple[bool, ...]] = None,
        weight_components: Tuple[float, ...] = (0.25, 0.25, 0.25, 0.25),
        eval_encode_block: int = 64,
        compute_dtype: str = "float32",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(num_users, num_items)
        feats = (semantic_features, color_features, edge_images, texture_features)
        if activated_components is None:
            activated_components = tuple(f is not None for f in feats)
        activated_components = tuple(bool(a) for a in activated_components)
        if len(activated_components) != 4 or len(weight_components) != 4:
            raise ValueError("activated/weight_components must have 4 entries")
        for fam, act, f in zip(FAMILIES, activated_components, feats):
            if act and f is None:
                raise ValueError(f"{fam} component activated but no features")
            if act and f.shape[0] != num_items:
                raise ValueError(f"{fam} features rows != num_items")
        if resolve_compute_dtype(compute_dtype) != torch.float32:
            raise NotImplementedError(
                "compute_dtype='bfloat16' (bf16 encoder towers) is not ported yet "
                "(ROADMAP: bf16 encoder towers)"
            )
        self.activated = activated_components
        self.weights = tuple(float(w) for w in weight_components)
        self.embed_k = embed_k
        self.embed_d = embed_d
        self.eval_encode_block = eval_encode_block
        dev = resolve_device(device)

        def empty(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        self.Bi = empty(num_items)
        self.Gu = empty(num_users, embed_k)
        self.Gi = empty(num_items, embed_k)
        self.cnn = None
        for j in self.active():
            self.register_buffer(FROZEN[j], frozen_buffer(feats[j], dev), persistent=False)
            if PROJ[j] is None:  # edges: the trainable tower
                h, w, c = feats[j].shape[1:]
                self.cnn = CNN(embed_d, in_channels=c, input_hw=(h, w), device=dev)
                setattr(self, BIAS[j], empty(embed_d, 1))
            else:
                dim = int(feats[j].shape[1])
                setattr(self, BIAS[j], empty(dim, 1))
                setattr(self, PROJ[j], empty(dim, embed_d))
            setattr(self, USER_TABLES[j], empty(num_users, embed_d))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    def active(self) -> List[int]:
        """The indices of the active families, in FAMILIES order."""
        return [j for j in range(4) if self.activated[j]]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the init anew in place, in the JAX init's order: Gu, Gi, then
        per active family Bp*, Tu*, E* (edges: the CNN's weights, Bpe,
        Tue); Bi and the CNN's biases zero."""
        self.Bi.zero_()

        def draw(p):
            p.copy_(glorot_uniform(tuple(p.shape), generator, p.device))

        draw(self.Gu)
        draw(self.Gi)
        for j in self.active():
            if PROJ[j] is None:
                self.cnn.reset_parameters(generator)
                draw(getattr(self, BIAS[j]))
                draw(getattr(self, USER_TABLES[j]))
            else:
                for name in (BIAS[j], USER_TABLES[j], PROJ[j]):
                    draw(getattr(self, name))

    # --- scoring pieces (CompVBPR.py:190-200) ---

    def _item_terms(self, p, theta_u, item_ids, draw: Optional[MaskDraw] = None):
        """The weighted visual terms of the active families for users'
        profiles ``theta_u`` ({family index: [B, d]}) against ``item_ids``
        [B]; the CNN encodes the items' edge images, its dropout masks from
        ``draw``."""
        x = 0.0
        for j in self.active():
            if PROJ[j] is None:
                theta_i = self.cnn.encode_drawn(self.take("Fe_img", self.Fe_img, item_ids),
                                                draw, params=param_group(p, "cnn"))
                bias = (theta_i @ p[BIAS[j]])[:, 0]
            else:
                f_i = self.take(FROZEN[j], getattr(self, FROZEN[j]), item_ids)
                theta_i = f_i @ p[PROJ[j]]
                bias = (f_i @ p[BIAS[j]])[:, 0]
            x = x + self.weights[j] * (torch.sum(theta_u[j] * theta_i, dim=-1) + bias)
        return x

    def score(self, users, items, params=None) -> torch.Tensor:
        p = self.params_or_own(params)
        theta_u = {j: p[USER_TABLES[j]][users] for j in self.active()}
        return (p["Bi"][items] + torch.sum(p["Gu"][users] * p["Gi"][items], dim=-1)
                + self._item_terms(p, theta_u, items))

    # --- training (CompVBPR.py:215-311) ---

    def _bpr_loss(self, p, gamma_u, theta_u, gamma_pos, gamma_neg, beta_pos, beta_neg,
                  pos, neg, reg, rng: Dropout) -> torch.Tensor:
        """The loss from the batch rows (``theta_u``: {family index: [B, d]})
        and the dense params ``p`` (dotted names); shared by ``loss`` and
        ``packed_loss``.  The positives' tower draws its dropout first."""
        draw = None if self.cnn is None else self.cnn.dropout_draw(rng)
        x_pos = (beta_pos + torch.sum(gamma_u * gamma_pos, dim=-1)
                 + self._item_terms(p, theta_u, pos, draw))
        x_neg = (beta_neg + torch.sum(gamma_u * gamma_neg, dim=-1)
                 + self._item_terms(p, theta_u, neg, draw))
        loss = bpr_pairwise_loss(x_pos, x_neg)
        reg_loss = (
            reg * (l2_loss(gamma_u) + l2_loss(gamma_pos) + l2_loss(gamma_neg)
                   + sum(l2_loss(t) for t in theta_u.values())) * 2.0
            + reg * l2_loss(beta_pos) * 2.0
            + reg * l2_loss(beta_neg) * 2.0 / 10.0
        )
        whole = sum(l2_loss(p[name]) for name in WHOLE if name in p)
        if self.cnn is not None:
            whole = whole + sum(l2_loss(v) for k, v in param_group(p, "cnn").items()
                                if not k.endswith("_b"))
        return loss + reg_loss + self.global_reg_scale * reg * whole * 2.0

    def row_sharded_params(self):
        """Bi, Gu, Gi, and the active families' user profiles and frozen
        tables (the JAX model's names)."""
        act = self.active()
        return (("Bi", "Gu", "Gi") + tuple(USER_TABLES[j] for j in act)
                + tuple(FROZEN[j] for j in act))

    def loss(self, users, pos, neg, reg: float, rng: Dropout = None) -> torch.Tensor:
        """Summed BPR loss plus the reference's L2 terms (module docstring);
        ``rng``: a generator or the CNN's four keep-masks."""
        p = dict(self.named_parameters())
        t = self.take
        theta_u = {j: t(USER_TABLES[j], p[USER_TABLES[j]], users) for j in self.active()}
        return self._bpr_loss(p, t("Gu", p["Gu"], users), theta_u, t("Gi", p["Gi"], pos),
                              t("Gi", p["Gi"], neg), t("Bi", p["Bi"], pos),
                              t("Bi", p["Bi"], neg), pos, neg, reg, rng)

    # --- packed LazyAdam engine (train/packed_generic.py) ---

    def packed_spec(self) -> PackedSpec:
        """Gu and the active Tu* in the user rows (Wu = K + 4 d with every
        family on), Gi and Bi in the item rows, the projections, the visual
        biases and the ``cnn`` group dense, in the JAX spec's order."""
        user, dense = [("Gu", self.embed_k)], []
        for j in self.active():
            user.append((USER_TABLES[j], self.embed_d))
            dense.extend(("cnn" if PROJ[j] is None else PROJ[j], BIAS[j]))
        return PackedSpec(user_tables=tuple(user), item_tables=(("Gi", self.embed_k),),
                          item_scalars=("Bi",), dense=tuple(dense))

    def packed_loss(self, user_vw, pos_vw, neg_vw, dense, frozen, ids,
                    reg, rng: Dropout = None) -> torch.Tensor:
        """``loss`` over the gathered rows; ``dense`` holds the projections,
        biases and ``cnn.*`` by their dotted names; ``frozen`` is unused
        (the model reads its own buffers by id)."""
        _, pos, neg = ids
        theta_u = {j: user_vw[USER_TABLES[j]] for j in self.active()}
        return self._bpr_loss(dense, user_vw["Gu"], theta_u, pos_vw["Gi"], neg_vw["Gi"],
                              pos_vw["Bi"], neg_vw["Bi"], pos, neg, reg, rng)

    # --- evaluation (CompVBPR.py:388-459, items encoded once) ---

    @torch.no_grad()
    def encode_all_edges(self, params=None) -> torch.Tensor:
        """[I, d] CNN codes of every item's edge image, in blocks of
        ``eval_encode_block`` images (the last padded with zero images)."""
        p = param_group(self.params_or_own(params), "cnn")
        imgs = self.Fe_img
        n = imgs.shape[0]
        blk = min(self.eval_encode_block, n)
        out = []
        for s in range(0, n, blk):
            block = imgs[s:s + blk]
            if block.shape[0] < blk:
                block = torch.cat([block, block.new_zeros((blk - block.shape[0],)
                                                          + block.shape[1:])])
            out.append(self.cnn.encode(block, params=p))
        return torch.cat(out)[:n]

    @torch.no_grad()
    def item_factors(self, params=None) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Per active family the item factors [I, d] (F* E*, or the CNN
        codes) and the summed weighted visual bias [I]."""
        p = self.params_or_own(params)
        thetas = []
        bias = torch.zeros(self.num_items, device=self.Bi.device)
        for j in self.active():
            if PROJ[j] is None:
                theta = self.encode_all_edges(p)
                b = theta @ p[BIAS[j]]
            else:
                f = getattr(self, FROZEN[j])
                theta, b = f @ p[PROJ[j]], f @ p[BIAS[j]]
            thetas.append(theta)
            bias = bias + self.weights[j] * b[:, 0]
        return thetas, bias

    def _user_factor_tables(self, p) -> List[torch.Tensor]:
        """The active user profiles times their mix weights (the weight
        rides the user side so that the item factors stay raw)."""
        return [self.weights[j] * p[USER_TABLES[j]] for j in self.active()]

    @torch.no_grad()
    def factored_eval(self, params=None):
        """(user factors [U, D], item factors [I, D], item bias [I]) for the
        streaming evaluator and the serving index: scores equal
        ``predict_all`` up to summation order."""
        p = self.params_or_own(params)
        thetas, vis_bias = self.item_factors(p)
        uf = torch.cat([p["Gu"]] + self._user_factor_tables(p), dim=1)
        vf = torch.cat([p["Gi"]] + thetas, dim=1)
        return uf, vf, p["Bi"] + vis_bias

    def precompute_eval(self, params=None):
        """The item factors, computed once per evaluation (passed back as
        ``ctx`` to every user block)."""
        return self.item_factors(params)

    @torch.no_grad()
    def predict_user_block(self, user_ids, ctx=None, params=None) -> torch.Tensor:
        p = self.params_or_own(params)
        thetas, vis_bias = ctx if ctx is not None else self.item_factors(p)
        x = p["Bi"][None, :] + p["Gu"][user_ids] @ p["Gi"].T + vis_bias[None, :]
        for tu, theta in zip(self._user_factor_tables(p), thetas):
            x = x + tu[user_ids] @ theta.T
        return x

    @torch.no_grad()
    def predict_all(self, params=None) -> torch.Tensor:
        p = self.params_or_own(params)
        thetas, vis_bias = self.item_factors(p)
        x = p["Bi"][None, :] + p["Gu"] @ p["Gi"].T + vis_bias[None, :]
        for tu, theta in zip(self._user_factor_tables(p), thetas):
            x = x + tu @ theta.T
        return x
