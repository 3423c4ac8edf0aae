"""ACF: Attentive Collaborative Filtering, Chen et al., SIGIR'17 (port of
``fashionvisualexpl_tpu/models/acf.py``; reference
src/recommender/models/ACF.py).

- component-level attention over each positive item's spatial CNN map
  [S, C]: a (64, 1) MLP over (gamma_u, f_s), softmax over S (ACF.py:135-162);
- item-level attention over the user's positive items: a (64, 1) MLP over
  (gamma_u, gamma_i, p_i, x_l), softmax over the positives with the padded
  slots masked (ACF.py:164-179);
- profile gamma_u + sum_p alpha_p p_i, score <profile, gamma_i> (ACF.py:208);
- reg on the batch embeddings and every attention matrix (ACF.py:247-256).

The spatial maps ``Fspat`` [I, S, C] and the padded positive tables
``pos_train`` / ``cnt_train`` (the training profile) and ``pos_eval`` /
``cnt_eval`` (training plus validation positives, the evaluation profile)
are non-persistent buffers: checkpoints hold the parameters only, as the
JAX package's do.  The positive tables come from ``data``'s lists, padded
(and subsampled past ``max_user_pos``) by ``_pad_user_pos`` with
``np.random.default_rng(seed)``, the JAX package's draws; or given as
arrays (``padded_positives`` / ``positive_counts``, then used for both).

``exact_eval`` / ``exact_train`` attend over every positive: the tables pad
to the true maximum and the profile runs over ``pos_chunk``-wide windows
with an online softmax (``_attentive_profile_chunked``), each window under
``torch.utils.checkpoint`` when gradients are on, so the backward pass
recomputes a [B, W, S, C] window instead of keeping every one.  Masked
logits are ``NEG_BIG`` (-1e9), never -inf: a user with no positive keeps
finite running maxima, and its profile is zeroed by the ``cnt > 0`` mask.

``compute_dtype="bfloat16"`` runs the attention einsums in bf16; both
softmaxes, the logits and the profile stay float32.

Parameters: ``Gu``, ``Gi``, ``Pi`` and the ``ParameterDict``s ``comp``
(``W0_u``, ``W0_i``, ``b0``, then ``W1``, ``b1`` ...) and ``item``
(``W0_u``, ``W0_iv``, ``W0_ip``, ``W0_ix``, ``b0``, ...), named
``"comp.W0_u"`` and so on.  The scoring methods take a ``params`` mapping
(name -> tensor) in place of the module's own.  Factored, a user is its
evaluation profile and an item its ``Gi`` row (D = embed_k, no bias).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.core.precision import (
    cast_compute,
    cast_f32,
    resolve_compute_dtype,
)
from fashionvisualexpl_tpu_torch.models.base import (
    Features,
    PackedSpec,
    RecommenderModel,
    bpr_pairwise_loss,
    frozen_buffer,
    glorot_uniform,
    l2_loss,
    normal_init,
    param_group,
)

NEG_BIG = -1e9


def _pad_user_pos(
    user_lists: Sequence[Sequence[int]], width: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """[U, width] padded (subsampled if longer) positive ids + counts."""
    U = len(user_lists)
    out = np.zeros((U, width), dtype=np.int32)
    counts = np.zeros((U,), dtype=np.int32)
    for u, row in enumerate(user_lists):
        row = list(row)
        if len(row) > width:
            row = rng.choice(row, size=width, replace=False).tolist()
        counts[u] = len(row)
        out[u, : len(row)] = row
    return out, counts


class ACF(RecommenderModel):
    """See the module docstring.  ``spatial_features`` [I, S, C] (numpy, or
    a tensor made on the card, kept without a copy when it is float32 and
    contiguous there); the parameters and buffers live on ``device``
    (``None`` = the CUDA card; raises without one).  ``generator`` draws
    the init (``None``: a fresh generator seeded with 0 on that device)."""

    name = "acf"

    def __init__(
        self,
        num_users: int,
        num_items: int,
        spatial_features: Features,
        data=None,
        embed_k: int = 128,
        layers_component: Tuple[int, ...] = (64, 1),
        layers_item: Tuple[int, ...] = (64, 1),
        max_user_pos: Optional[int] = None,
        seed: int = 0,
        padded_positives: Optional[np.ndarray] = None,
        positive_counts: Optional[np.ndarray] = None,
        exact_eval: bool = False,
        exact_train: bool = False,
        pos_chunk: int = 64,
        compute_dtype: str = "float32",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(num_users, num_items)
        if spatial_features.shape[0] != num_items:
            raise ValueError("spatial features rows != num_items")
        if layers_component[-1] != 1 or layers_item[-1] != 1:
            raise ValueError("last attention layer width must be 1")
        self.embed_k = embed_k
        self.layers_component = tuple(layers_component)
        self.layers_item = tuple(layers_item)
        self.S = int(spatial_features.shape[1])
        self.C = int(spatial_features.shape[2])
        self.exact_eval = bool(exact_eval)
        self.exact_train = bool(exact_train)
        self.pos_chunk = int(pos_chunk)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        dev = resolve_device(device)

        if padded_positives is not None:
            if positive_counts is None:
                raise ValueError("positive_counts required with padded_positives")
            width = int(padded_positives.shape[1])
            if max_user_pos is not None and int(max_user_pos) != width:
                raise ValueError(
                    f"max_user_pos={max_user_pos} != padded_positives width {width}"
                )
            self.max_user_pos = width
            pos_train = pos_eval = np.asarray(padded_positives, np.int32)
            cnt_train = cnt_eval = np.asarray(positive_counts, np.int32)
        else:
            if data is None:
                raise ValueError("either data or padded_positives is required")
            self.max_user_pos = int(max_user_pos if max_user_pos is not None else 64)
            rng = np.random.default_rng(seed)
            # the training profile reads the train positives (ACF.py:201-203),
            # the evaluation profile train + validation (ACF.py:216-218); an
            # exact side pads to the true maximum, subsampling no user
            train_width = (max(1, max(len(r) for r in data.training_list))
                           if self.exact_train else self.max_user_pos)
            pos_train, cnt_train = _pad_user_pos(data.training_list, train_width, rng)
            eval_lists = [list(t) + list(v)
                          for t, v in zip(data.training_list, data.validation_list)]
            eval_width = (max(1, max(len(r) for r in eval_lists))
                          if self.exact_eval else self.max_user_pos)
            pos_eval, cnt_eval = _pad_user_pos(eval_lists, eval_width, rng)

        self.register_buffer("Fspat", frozen_buffer(spatial_features, dev), persistent=False)
        for name, arr in (("pos_train", pos_train), ("cnt_train", cnt_train),
                          ("pos_eval", pos_eval), ("cnt_eval", cnt_eval)):
            self.register_buffer(name, torch.tensor(arr, dtype=torch.int32, device=dev),
                                 persistent=False)

        def empty(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        K, C = embed_k, self.C
        self.Gu = empty(num_users, K)
        self.Gi = empty(num_items, K)
        self.Pi = empty(num_items, K)
        # the attention groups' members in the JAX init's order (a
        # ParameterDict keeps its own, sorted, order)
        self._init_order = {}
        for group, layers, first in (
            ("comp", self.layers_component, (("W0_u", K), ("W0_i", C))),
            ("item", self.layers_item, (("W0_u", K), ("W0_iv", K), ("W0_ip", K), ("W0_ix", C))),
        ):
            members = {}
            for l, width in enumerate(layers):
                if l == 0:
                    members.update({n: empty(rows, width) for n, rows in first})
                else:
                    members[f"W{l}"] = empty(width, layers[l - 1])
                members[f"b{l}"] = empty(width)
            self._init_order[group] = tuple(members)
            setattr(self, group, nn.ParameterDict(members))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the init anew in place, in the JAX init's order: Gu, Gi, Pi
        (RandomNormal, stddev 0.01), then each attention group's members in
        order (GlorotUniform; a bias drawn as a [1, width] matrix)."""
        dev = self.device
        for p in (self.Gu, self.Gi, self.Pi):
            p.copy_(normal_init(tuple(p.shape), generator, dev))
        for group, names in self._init_order.items():
            for name in names:
                p = getattr(self, group)[name]
                shape = (1, p.shape[0]) if name.startswith("b") else tuple(p.shape)
                p.copy_(glorot_uniform(shape, generator, dev).view(p.shape))

    # --- the two-level attentive user profile (ACF.py:135-181) ---

    def _item_logits(self, comp, item, g_u, f, g_i, p_i) -> torch.Tensor:
        """Item-level attention logits [B, P] (float32) for gathered
        positives: g_u [B, K], f [B, P, S, C], g_i / p_i [B, P, K].  The
        component-level softmax over S happens inside (ACF.py:152-162)."""
        cd = self.compute_dtype
        g_u, f, g_i, p_i = (cast_compute(x, cd) for x in (g_u, f, g_i, p_i))
        comp = {k: cast_compute(v, cd) for k, v in comp.items()}
        item = {k: cast_compute(v, cd) for k, v in item.items()}
        b = ((g_u @ comp["W0_u"])[:, None, None, :]
             + torch.einsum("bpsc,ct->bpst", f, comp["W0_i"]) + comp["b0"])
        b = torch.relu(b)
        for c in range(1, len(self.layers_component)):
            b = torch.einsum("bpst,ut->bpsu", b, comp[f"W{c}"]) + comp[f"b{c}"]
        beta = torch.softmax(cast_f32(b[..., 0]), dim=2)  # [B, P, S] f32
        x_l = torch.einsum("bps,bpsc->bpc", cast_compute(beta, cd), f)
        a = ((g_u @ item["W0_u"])[:, None, :] + g_i @ item["W0_iv"] + p_i @ item["W0_ip"]
             + x_l @ item["W0_ix"] + item["b0"])
        a = torch.relu(a)
        for i in range(1, len(self.layers_item)):
            a = torch.einsum("bpt,ut->bpu", a, item[f"W{i}"]) + item[f"b{i}"]
        return cast_f32(a[..., 0])

    def _attentive_profile(self, comp, item, g_u, f, g_i, p_i, cnt) -> torch.Tensor:
        """The two-level attention over gathered inputs, shared by
        ``user_profile`` and ``packed_loss``: softmax over the valid
        positives, zero-positive users keep their plain embedding."""
        logits = self._item_logits(comp, item, g_u, f, g_i, p_i)
        valid = torch.arange(logits.shape[1], device=logits.device)[None, :] < cnt[:, None]
        alpha = torch.softmax(torch.where(valid, logits, NEG_BIG), dim=1)
        alpha = torch.where(valid, alpha, 0.0)
        profile = torch.einsum("bp,bpk->bk", alpha, p_i)
        return g_u + torch.where(cnt[:, None] > 0, profile, 0.0)

    def _attentive_profile_chunked(self, p, g_u, pos, cnt) -> torch.Tensor:
        """The exact profile over every positive (ACF.py:169-179): the
        padded list in ``pos_chunk``-wide windows with an online softmax
        (running max m, denominator s, weighted sum acc), each window
        recomputed in the backward pass (``checkpoint``) when gradients are
        on.  ``p`` maps parameter names to tensors."""
        comp, item = param_group(p, "comp"), param_group(p, "item")
        B, Pmax = pos.shape
        W = min(self.pos_chunk, Pmax)
        n_chunks = -(-Pmax // W)
        pos_p = F.pad(pos, (0, n_chunks * W - Pmax))
        ar = torch.arange(W, device=pos.device)

        def window(m, s, acc, ids, off):
            flat = ids.reshape(-1)
            f = self.Fspat[ids]  # [B, W, S, C]
            g_i = self.take("Gi", p["Gi"], flat).reshape(B, W, -1)
            p_i = self.take("Pi", p["Pi"], flat).reshape(B, W, -1)
            logits = self._item_logits(comp, item, g_u, f, g_i, p_i)
            valid = (off + ar)[None, :] < cnt[:, None]
            logits = torch.where(valid, logits, NEG_BIG)
            m_new = torch.maximum(m, logits.amax(dim=1))
            scale = torch.exp(m - m_new)
            e = torch.exp(logits - m_new[:, None]) * valid
            s = s * scale + e.sum(dim=1)
            acc = acc * scale[:, None] + torch.einsum("bw,bwk->bk", e, p_i)
            return m_new, s, acc

        m = torch.full((B,), NEG_BIG, device=g_u.device)
        s = torch.zeros(B, device=g_u.device)
        acc = torch.zeros(B, g_u.shape[-1], device=g_u.device)
        for j in range(n_chunks):
            ids = pos_p[:, j * W:(j + 1) * W].long()
            if torch.is_grad_enabled():
                m, s, acc = checkpoint(window, m, s, acc, ids, j * W, use_reentrant=False)
            else:
                m, s, acc = window(m, s, acc, ids, j * W)
        profile = acc / torch.clamp_min(s, 1e-30)[:, None]
        return g_u + torch.where(cnt[:, None] > 0, profile, 0.0)

    def user_profile(self, users: torch.Tensor, train_only: bool = True,
                     params: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """gamma_u + sum_p alpha_p p_i over the user's positives, [B, K]:
        the training table (``train_only``) or the evaluation one."""
        p = self.params_or_own(params)
        users = users.long()
        pos_t, cnt_t = ((self.pos_train, self.cnt_train) if train_only
                        else (self.pos_eval, self.cnt_eval))
        pos, cnt = pos_t[users], cnt_t[users]
        g_u = self.take("Gu", p["Gu"], users)
        if self.exact_train if train_only else self.exact_eval:
            return self._attentive_profile_chunked(p, g_u, pos, cnt)
        pos = pos.long()
        return self._attentive_profile(param_group(p, "comp"), param_group(p, "item"), g_u,
                                       self.Fspat[pos], self.take("Gi", p["Gi"], pos),
                                       self.take("Pi", p["Pi"], pos), cnt)

    # --- scoring / training ---

    def score(self, users: torch.Tensor, items: torch.Tensor, train_only: bool = True,
              params: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        p = self.params_or_own(params)
        profile = self.user_profile(users, train_only, p)
        return torch.sum(profile * p["Gi"][items.long()], dim=-1)

    def _bpr_loss(self, p, g_u_p, gamma_u, gamma_pos, gamma_neg, p_pos, p_neg, reg):
        """BPR on <profile, gamma_i> plus the reference's L2 terms: the
        batch embeddings and every attention matrix, each times 2
        (ACF.py:247-256); ``p`` holds the attention params by dotted name."""
        x_pos = torch.sum(g_u_p * gamma_pos, dim=1)
        x_neg = torch.sum(g_u_p * gamma_neg, dim=1)
        att_l2 = (sum(l2_loss(v) for v in param_group(p, "comp").values())
                  + sum(l2_loss(v) for v in param_group(p, "item").values()))
        return bpr_pairwise_loss(x_pos, x_neg) + (
            reg * (l2_loss(gamma_u) + l2_loss(gamma_pos) + l2_loss(gamma_neg)
                   + l2_loss(p_pos) + l2_loss(p_neg)) * 2.0
            + self.global_reg_scale * reg * att_l2 * 2.0)

    def row_sharded_params(self):
        return ("Gu", "Gi", "Pi")

    def loss(self, users, pos, neg, reg: float, rng=None) -> torch.Tensor:
        """``rng`` is unused: ACF has no stochastic layer."""
        del rng
        p = dict(self.named_parameters())
        users, pos, neg = users.long(), pos.long(), neg.long()
        t = self.take
        return self._bpr_loss(p, self.user_profile(users, True, p), t("Gu", p["Gu"], users),
                              t("Gi", p["Gi"], pos), t("Gi", p["Gi"], neg),
                              t("Pi", p["Pi"], pos), t("Pi", p["Pi"], neg), reg)

    # --- packed LazyAdam engine (train/packed_generic.py) ---

    def packed_spec(self) -> PackedSpec:
        """Gu in the user rows; Gi and Pi in the item rows, which the
        profile also reads for each user's ``max_user_pos`` positives
        (``extra_items``); the spatial map rides the item rows as a frozen
        table, so the extra-row gathers deliver it too; the attention as
        dense groups.  ``exact_train`` refuses: its positive sets have no
        fixed width."""
        if self.exact_train:
            raise ValueError(
                "acf exact_train requires the generic train path: the "
                "packed engine's fixed extra_items row layout is exactly "
                "the per-user positive cap exact_train removes"
            )
        return PackedSpec(
            user_tables=(("Gu", self.embed_k),),
            item_tables=(("Gi", self.embed_k), ("Pi", self.embed_k)),
            item_scalars=(),
            dense=("comp", "item"),
            extra_items=self.max_user_pos,
            frozen_item_tables=(("Fspat", self.S * self.C),),
        )

    def packed_extra_item_ids(self, frozen, ids) -> torch.Tensor:
        """[B, max_user_pos] int32: each user's padded training positives,
        a padded slot pointing at the batch element's own positive item
        (already a row of the step's dedupe), never at row 0, which would
        otherwise take LazyAdam's tail updates every step.  The profile
        masks those slots, so their gradients are zero."""
        users, p_ids, _ = (x.long() for x in ids)
        pos = frozen["pos_train"][users]
        cnt = frozen["cnt_train"][users]
        valid = torch.arange(pos.shape[1], device=pos.device)[None, :] < cnt[:, None]
        return torch.where(valid, pos.long(), p_ids[:, None]).to(torch.int32)

    def packed_loss(self, user_vw, pos_vw, neg_vw, dense, frozen, ids, reg, rng=None,
                    extra_vw=None, frozen_vw=None) -> torch.Tensor:
        """``loss`` over the gathered rows: the profile reads the extra
        rows' Gi and Pi (``extra_vw``, [B, P, K]) and, fused, their
        spatial maps (``frozen_vw["extra"]``); unfused, the maps by id from
        ``frozen`` (a padded slot reads item 0's, masked either way)."""
        del rng
        users = ids[0].long()
        cnt = frozen["cnt_train"][users]
        if frozen_vw is not None:
            x = frozen_vw["extra"]["Fspat"]  # [B, P, S*C]
            f = x.reshape(*x.shape[:2], self.S, self.C)
        else:
            f = frozen["Fspat"][frozen["pos_train"][users].long()]
        g_u_p = self._attentive_profile(param_group(dense, "comp"), param_group(dense, "item"),
                                        user_vw["Gu"], f, extra_vw["Gi"], extra_vw["Pi"],
                                        cnt)
        return self._bpr_loss(dense, g_u_p, user_vw["Gu"], pos_vw["Gi"], neg_vw["Gi"],
                              pos_vw["Pi"], neg_vw["Pi"], reg)

    # --- evaluation ---

    @torch.no_grad()
    def precompute_eval(self, params: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> torch.Tensor:
        """Evaluation profiles of every user [U, K], in blocks of 256 users
        (the last one wrapping around, as in the JAX package); computed
        once per evaluation (the reference recomputes them in a thread pool
        per predict_all call, ACF.py:213-224)."""
        p = self.params_or_own(params)
        U, blk = self.num_users, 256
        ids = torch.arange(-(-U // blk) * blk, device=self.device) % U
        out = [self.user_profile(ids[s:s + blk], False, p) for s in range(0, ids.shape[0], blk)]
        return torch.cat(out)[:U]

    @torch.no_grad()
    def predict_user_block(self, user_ids, ctx=None, params=None) -> torch.Tensor:
        p = self.params_or_own(params)
        profiles = ctx if ctx is not None else self.precompute_eval(p)
        return profiles[user_ids.long()] @ p["Gi"].T

    @torch.no_grad()
    def predict_all(self, params=None) -> torch.Tensor:
        p = self.params_or_own(params)
        return self.precompute_eval(p) @ p["Gi"].T

    def factored_eval(self, params: Optional[Mapping[str, torch.Tensor]] = None):
        """(profiles [U, K], Gi [I, K], None) for the streaming evaluator
        and the serving index: the user side is the attentive profile, the
        item side Gi, no bias."""
        p = self.params_or_own(params)
        return self.precompute_eval(p), p["Gi"], None
