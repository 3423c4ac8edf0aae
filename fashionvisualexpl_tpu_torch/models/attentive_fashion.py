"""AttentiveFashion: trainable per-modality encoders + attention fusion (port
of ``fashionvisualexpl_tpu/models/attentive_fashion.py``; reference
src/recommender/models/AttentiveFashion.py, the reference's default model).

- color encoder: Dense(256, relu) -> Dropout(0.5) -> Dense(K, no bias)
  (AttentiveFashion.py:50-55); the class encoder has the same shape (:66-71);
- edges encoder: Conv2D(64, 5x5, same, relu) -> MaxPool(2x2, same) ->
  GlobalAvgPool -> Dropout(0.5) -> Dense(K, no bias) (:57-64), the
  conv -> pool -> GAP stage through the edge-tower kernel K7
  (``ops/edge_tower.py``) or its plain version;
- attention over the 3 user-gated modality embeddings, softmax over the
  modalities in f32 (:121-166); score sum(gamma_u * (sum_m alpha_m e_m) *
  gamma_i) (:193-199);
- reg on the batch embeddings, the encoder outputs and the attention
  matrices (:228-243).

Items are encoded once per evaluation (``precompute_eval``, in
``batch_eval`` blocks) and scored in ``item_block`` blocks against the
cached [I, 3, K] encodings, as in the JAX package.

Parameters are the module's own: ``Gu``, ``Gi`` and the ``ParameterDict``s
``color_enc``, ``class_enc``, ``edges_enc`` and ``attention`` (named
``"color_enc.W1"`` and so on); the modality inputs ``Fc``, ``Fe_img`` and
``Fcls`` are buffers (JAX's ``frozen``).  With ``host_features=True`` they
stay on the host instead, as the numpy arrays (or read-only memmaps)
``_color``, ``_edges`` and ``_class``, and the model has no buffers (JAX's
empty ``frozen``): the streamed trainer (``train/streamed.py``) feeds
``loss_streamed`` each batch's rows, ``precompute_eval`` copies fixed-size
``batch_eval`` blocks (``item_block`` without it) to the device through
pinned staging buffers, and the other methods copy the rows they read.
``conv_W`` keeps JAX's HWIO layout [5, 5, 1, C].  The scoring methods take
a ``params`` mapping (name -> tensor) in place of the module's own, like
BPRMF's.

Dropout keeps with probability 1 - rate and divides by the keep rate, as
JAX's ``_dropout``.  ``loss`` and ``encode_items`` take ``rng``: a
``torch.Generator`` on the model's device, or the keep-masks themselves (a
sequence of bool tensors consumed in a fixed order: positives then
negatives, each color [B, hidden], edges [B, filters], class [B, hidden]),
which is how the parity tests feed in JAX's draws.

``packed_spec`` / ``packed_loss`` put the model on the packed LazyAdam
engine (Gu and Gi in the packed rows, the encoders and the attention as
dense groups).

Not ported yet: ``compute_dtype="bfloat16"`` (bf16 towers and a bf16 K7,
ROADMAP: bf16 encoder towers); it raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.core.precision import (
    cast_compute,
    cast_f32,
    resolve_compute_dtype,
)
from fashionvisualexpl_tpu_torch.data.pipeline import StagingRing, take_rows
from fashionvisualexpl_tpu_torch.models.base import (
    Dropout,
    MaskDraw,
    PackedSpec,
    RecommenderModel,
    bpr_pairwise_loss,
    dropout,
    glorot_uniform,
    keep_masks,
    l2_loss,
    param_group,
)
from fashionvisualexpl_tpu_torch.ops.edge_tower import edge_tower_gap, edge_tower_gap_plain
from fashionvisualexpl_tpu_torch.ops.s2d_conv import edge_tower_s2d_gap

EDGE_TOWERS = ("auto", "fused", "xla", "s2d")


class AttentiveFashion(RecommenderModel):
    """See the module docstring.  ``color_features`` [I, dim_c] (maxabs
    normalized), ``edge_images`` [I, H, W, 1] in [0, 1] and
    ``class_features`` [I, num_classes] are numpy arrays; they and the
    parameters live on ``device`` (``None`` = the CUDA card; raises without
    one), the arrays on the host with ``host_features=True`` (pass float32
    memmaps: they stay views).  ``generator`` draws the init (``None``: a
    fresh generator seeded with 0 on that device).

    ``edge_tower`` picks the conv -> pool -> GAP implementation, settled
    here and readable as ``tower_route`` ("kernel", "plain" or "s2d"):
    "fused" is K7 (``ops/edge_tower.py::edge_tower_gap``; on the CPU its
    plain version) and needs even H, W; "auto" is K7 on the CUDA card at
    even H, W and the plain tower otherwise (on the CPU, or at odd H or W,
    which the kernel does not take); "xla" is
    the plain tower; "s2d" computes the same function on a space-to-depth
    layout (``ops/s2d_conv.py``, plain PyTorch: in the JAX package an XLA
    re-expression, not a kernel) and needs even H, W.  ``tower_batch_tile`` is accepted
    and ignored: the CUDA kernel picks its own grid."""

    name = "attentive_fashion"

    def __init__(
        self,
        num_users: int,
        num_items: int,
        color_features: np.ndarray,
        edge_images: np.ndarray,
        class_features: np.ndarray,
        embed_k: int = 128,
        attention_layers: Tuple[int, ...] = (64, 1),
        encoder_hidden: int = 256,
        dropout_rate: float = 0.5,
        conv_filters: int = 64,
        item_block: int = 1024,
        compute_dtype: str = "float32",
        host_features: bool = False,
        batch_eval: Optional[int] = None,
        edge_tower: str = "auto",
        tower_batch_tile: Optional[int] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(num_users, num_items)
        for f, nm in (
            (color_features, "color"), (edge_images, "edges"),
            (class_features, "class"),
        ):
            if f.shape[0] != num_items:
                raise ValueError(f"{nm} features rows != num_items")
        self.embed_k = embed_k
        self.attention_layers = tuple(attention_layers)
        if self.attention_layers[-1] != 1:
            raise ValueError("last attention layer must have width 1")
        self.encoder_hidden = encoder_hidden
        self.dropout_rate = dropout_rate
        self.conv_filters = conv_filters
        self.item_block = item_block
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        if self.compute_dtype != torch.float32:
            raise NotImplementedError(
                "compute_dtype='bfloat16' (bf16 towers and a bf16 edge-tower "
                "kernel) is not ported yet (ROADMAP: bf16 encoder towers)"
            )
        self.batch_eval = None if batch_eval is None else int(batch_eval)
        if edge_tower not in EDGE_TOWERS:
            raise ValueError(f"edge_tower {edge_tower!r} not in auto/fused/xla/s2d")
        h_img, w_img = edge_images.shape[1:3]
        even = h_img % 2 == 0 and w_img % 2 == 0
        if edge_tower == "s2d" and not even:
            raise ValueError("edge_tower='s2d' requires even image H, W")
        if edge_tower == "fused" and not even:
            raise ValueError(
                f"edge_tower='fused' cannot run at {h_img}x{w_img}: the kernel "
                "takes even H and W (ops/edge_tower.py)"
            )
        dev = resolve_device(device)
        self.edge_tower = edge_tower
        self.tower_batch_tile = tower_batch_tile
        self.tower_route = (
            "s2d" if edge_tower == "s2d"
            else "kernel" if edge_tower == "fused"
            or (edge_tower == "auto" and even and dev.type == "cuda")
            else "plain"
        )

        self.host_features = host_features
        if host_features:
            # float32 memmaps stay no-copy views
            self._color = np.asarray(color_features, np.float32)
            self._edges = np.asarray(edge_images, np.float32)
            self._class = np.asarray(class_features, np.float32)
            self._eval_ring = None  # pinned staging for precompute_eval
        else:
            def buf(a):
                return torch.from_numpy(np.require(a, np.float32, ["C", "W"])).to(dev)

            self.register_buffer("Fc", buf(color_features))
            self.register_buffer("Fe_img", buf(edge_images))
            self.register_buffer("Fcls", buf(class_features))
        self.dim_c = int(color_features.shape[1])
        self.dim_cls = int(class_features.shape[1])

        def empty(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        K, Hd = embed_k, encoder_hidden
        self.Gu = empty(num_users, K)
        self.Gi = empty(num_items, K)
        self.color_enc = nn.ParameterDict(
            {"W1": empty(self.dim_c, Hd), "b1": empty(Hd), "W2": empty(Hd, K)})
        self.class_enc = nn.ParameterDict(
            {"W1": empty(self.dim_cls, Hd), "b1": empty(Hd), "W2": empty(Hd, K)})
        self.edges_enc = nn.ParameterDict(
            {"conv_W": empty(5, 5, 1, conv_filters), "conv_b": empty(conv_filters),
             "W2": empty(conv_filters, K)})
        att, prev = {}, K
        for l, width in enumerate(self.attention_layers):
            att[f"W{l + 1}"] = empty(prev, width)
            att[f"b{l + 1}"] = empty(width)
            prev = width
        self.attention = nn.ParameterDict(att)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the init anew in place, in the JAX init's order: Gu, Gi,
        color W1, W2, class W1, W2, conv_W, edges W2, then the attention
        layers (W, b each; GlorotUniform on the bias too, AttentiveFashion.py
        :131-143).  Encoder biases start at zero."""
        dev = self.device

        def draw(p, shape=None):
            p.copy_(glorot_uniform(shape or tuple(p.shape), generator, dev).view(p.shape))

        draw(self.Gu)
        draw(self.Gi)
        for enc in (self.color_enc, self.class_enc):
            draw(enc["W1"])
            enc["b1"].zero_()
            draw(enc["W2"])
        draw(self.edges_enc["conv_W"])
        self.edges_enc["conv_b"].zero_()
        draw(self.edges_enc["W2"])
        for l in range(len(self.attention_layers)):
            draw(self.attention[f"W{l + 1}"])
            draw(self.attention[f"b{l + 1}"], (1, self.attention_layers[l]))

    # --- encoders ---

    def _mlp_encode(self, enc, x, draw):
        cd = self.compute_dtype
        h = torch.relu(cast_compute(x, cd) @ cast_compute(enc["W1"], cd)
                       + cast_compute(enc["b1"], cd))
        h = dropout(h, self.dropout_rate, draw)
        return cast_f32(h @ cast_compute(enc["W2"], cd))

    def _edges_encode(self, enc, images, draw):
        """Conv(5x5, same, relu) -> MaxPool(2x2, same) -> GAP -> Dropout ->
        Dense (AttentiveFashion.py:57-64); the first three by the route
        settled at construction."""
        tower = {"kernel": edge_tower_gap, "plain": edge_tower_gap_plain,
                 "s2d": edge_tower_s2d_gap}[self.tower_route]
        y = tower(images, enc["conv_W"], enc["conv_b"])  # [B, filters] f32
        y = dropout(y, self.dropout_rate, draw)
        cd = self.compute_dtype
        return cast_f32(cast_compute(y, cd) @ cast_compute(enc["W2"], cd))

    def _encode(self, p, col, img, cls, draw):
        """[N, 3, K] stacked (color, edges, class) embeddings, the
        reference's concat order (AttentiveFashion.py:195-198)."""
        color_e = self._mlp_encode(param_group(p, "color_enc"), col, draw)
        edges_e = self._edges_encode(param_group(p, "edges_enc"), img, draw)
        class_e = self._mlp_encode(param_group(p, "class_enc"), cls, draw)
        return torch.stack([color_e, edges_e, class_e], dim=-2)

    def _rows(self, item_ids):
        """(color, edges, class) inputs of ``item_ids`` (all items when
        None) on the model's device; host features are copied there."""
        if not self.host_features:
            if item_ids is None:
                return self.Fc, self.Fe_img, self.Fcls
            return self.Fc[item_ids], self.Fe_img[item_ids], self.Fcls[item_ids]
        srcs = (self._color, self._edges, self._class)
        if item_ids is not None:
            ids = torch.as_tensor(item_ids).cpu().numpy()
            srcs = tuple(take_rows(a, ids, np.empty((len(ids),) + a.shape[1:], np.float32))
                         for a in srcs)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in srcs)

    def _encode_ids(self, p, item_ids, draw):
        return self._encode(p, *self._rows(item_ids), draw)

    def _draw(self, rng: Dropout) -> Optional[MaskDraw]:
        return keep_masks(rng, 1.0 - self.dropout_rate) if self.dropout_rate > 0 else None

    def encode_items(self, item_ids=None, rng: Dropout = None, params=None):
        """[N, 3, K] embeddings of ``item_ids`` (all items when None), with
        dropout when ``rng`` is given."""
        return self._encode_ids(self.params_or_own(params), item_ids, self._draw(rng))

    def encode_batch(self, col, img, cls, rng: Dropout = None, params=None):
        """[B, 3, K] from explicit per-batch modality inputs."""
        return self._encode(self.params_or_own(params), col, img, cls, self._draw(rng))

    # --- attention (AttentiveFashion.py:146-166) ---

    def _attention(self, att, gamma_u, e_items):
        """alpha over modalities: gamma_u [..., K], e_items [..., 3, K] ->
        alpha [..., 3, 1]."""
        cd = self.compute_dtype
        h = cast_compute(gamma_u.unsqueeze(-2), cd) * cast_compute(e_items, cd)
        for l in range(len(self.attention_layers)):
            h = h @ cast_compute(att[f"W{l + 1}"], cd) + cast_compute(att[f"b{l + 1}"], cd)
            if l == 0:
                h = torch.relu(h)
        return torch.softmax(cast_f32(h), dim=-2)  # over the modalities, in f32

    def _score_from_encoded(self, att, gamma_u, gamma_i, e_items):
        alpha = self._attention(att, gamma_u, e_items)
        weighted = torch.sum(alpha * e_items, dim=-2)  # [..., K]
        return torch.sum(gamma_u * weighted * gamma_i, dim=-1)

    # --- training ---

    def row_sharded_params(self):
        return ("Gu", "Gi")

    def loss(self, users, pos, neg, reg: float, rng: Dropout = None) -> torch.Tensor:
        """Summed BPR loss plus the reference's L2 terms (batch embeddings,
        encoder outputs after dropout, attention matrices; each times 2).
        ``rng``: a generator or the six keep-masks (module docstring)."""
        p = dict(self.named_parameters())
        t = self.take
        return self._bpr_loss(p, t("Gu", self.Gu, users), t("Gi", self.Gi, pos),
                              t("Gi", self.Gi, neg), self._rows(pos), self._rows(neg), reg, rng)

    def loss_streamed(self, users, pos, neg, feats, reg: float,
                      rng: Dropout = None) -> torch.Tensor:
        """``loss`` with the modality inputs of the batch given in ``feats``
        (``col_pos``, ``img_pos``, ``cls_pos``, ``col_neg``, ``img_neg``,
        ``cls_neg``: [B, ...] tensors on the model's device), the streamed
        trainer's step.  Dropout is drawn as ``loss`` draws it, so the same
        rows and the same generator give the same loss."""
        p = dict(self.named_parameters())
        return self._bpr_loss(
            p, self.Gu[users], self.Gi[pos], self.Gi[neg],
            (feats["col_pos"], feats["img_pos"], feats["cls_pos"]),
            (feats["col_neg"], feats["img_neg"], feats["cls_neg"]), reg, rng)

    def _bpr_loss(self, p, gamma_u, gamma_pos, gamma_neg, pos_in, neg_in, reg,
                  rng: Dropout) -> torch.Tensor:
        """The loss from the batch rows, the positives' and negatives'
        (color, edges, class) inputs and the encoder / attention params
        ``p`` (dotted names); shared by ``loss``, ``loss_streamed`` and
        ``packed_loss``."""
        draw = self._draw(rng)
        e_pos = self._encode(p, *pos_in, draw)  # [B, 3, K]
        e_neg = self._encode(p, *neg_in, draw)
        att = param_group(p, "attention")
        x_pos = self._score_from_encoded(att, gamma_u, gamma_pos, e_pos)
        x_neg = self._score_from_encoded(att, gamma_u, gamma_neg, e_neg)
        loss = bpr_pairwise_loss(x_pos, x_neg)
        reg_loss = (
            reg
            * (
                l2_loss(gamma_u)
                + l2_loss(gamma_pos)
                + l2_loss(gamma_neg)
                + l2_loss(e_pos)
                + l2_loss(e_neg)
            )
            * 2.0
            + self.global_reg_scale * reg * sum(l2_loss(v) for v in att.values()) * 2.0
        )
        return loss + reg_loss

    # --- packed LazyAdam engine (train/packed_generic.py) ---

    def packed_spec(self) -> PackedSpec:
        """Gu and Gi in the packed rows, the encoders and the attention as
        dense groups."""
        return PackedSpec(
            user_tables=(("Gu", self.embed_k),),
            item_tables=(("Gi", self.embed_k),),
            item_scalars=(),
            dense=("color_enc", "class_enc", "edges_enc", "attention"),
        )

    def packed_loss(self, user_vw, pos_vw, neg_vw, dense, frozen, ids,
                    reg, rng: Dropout = None) -> torch.Tensor:
        """``loss`` over the gathered rows: ``dense`` holds the encoder and
        attention params by their dotted names; dropout is drawn as
        ``loss`` draws it (positives, then negatives); ``frozen`` is unused
        (the model reads its own buffers)."""
        _, pos, neg = ids
        return self._bpr_loss(dense, user_vw["Gu"], pos_vw["Gi"], neg_vw["Gi"],
                              self._rows(pos), self._rows(neg), reg, rng)

    # --- inference ---

    def score(self, users, items, params=None) -> torch.Tensor:
        p = self.params_or_own(params)
        e_items = self._encode_ids(p, items, None)
        return self._score_from_encoded(param_group(p, "attention"), p["Gu"][users],
                                        p["Gi"][items], e_items)

    @torch.no_grad()
    def precompute_eval(self, params=None) -> torch.Tensor:
        """Encode every item once per evaluation (no dropout) -> [I, 3, K].
        With ``batch_eval`` (the reference's --batch_eval,
        AttentiveFashion.py:338-343) in blocks of that many items, the last
        one padded to a full block, as in the JAX package: one tower call
        per block.  With host features, blocks of ``batch_eval`` (else
        ``item_block``) items go through two pinned staging buffers per
        modality: one block's rows are copied on the host while the device
        encodes the one before."""
        p = self.params_or_own(params)
        if self.host_features:
            return self._precompute_eval_host(p)
        I, blk = self.num_items, self.batch_eval
        if blk is None or blk >= I:
            return self._encode_ids(p, None, None)
        out = []
        for s in range(0, I, blk):
            parts = [self.Fc[s:s + blk], self.Fe_img[s:s + blk], self.Fcls[s:s + blk]]
            n = parts[0].shape[0]
            if n < blk:
                parts = [torch.cat([a, a.new_zeros((blk - n,) + a.shape[1:])]) for a in parts]
            out.append(self._encode(p, *parts, None)[:n])
        return torch.cat(out)

    def _precompute_eval_host(self, p) -> torch.Tensor:
        I = self.num_items
        blk = min(self.item_block if self.batch_eval is None else self.batch_eval, I)
        srcs = {"col": self._color, "img": self._edges, "cls": self._class}
        ring = self._eval_ring
        if ring is None or ring.slots[0]["col"].shape[0] != blk \
                or ring.device != self.device:
            ring = self._eval_ring = StagingRing(
                2, {k: (blk,) + a.shape[1:] for k, a in srcs.items()}, self.device)
        out = []
        for s in range(0, I, blk):
            n = min(blk, I - s)
            i = ring.acquire()
            for k, a in srcs.items():
                view = ring.views[i][k]
                take_rows(a, np.arange(s, s + n, dtype=np.int32), view[:n])
                view[n:] = 0.0  # the last block padded to a full one
            x = ring.to_device(i)
            out.append(self._encode(p, x["col"], x["img"], x["cls"], None)[:n])
        return torch.cat(out)

    def _scores_against_all(self, att, gamma_u, e_items, Gi):
        """[B_u, I] scores of a user block against the cached item
        encodings, in ``item_block`` blocks that bound the [B_u, blk, 3, t]
        attention intermediate."""
        blk = min(self.item_block, e_items.shape[0])
        gu = gamma_u[:, None, :]  # [B_u, 1, K]
        out = []
        for s in range(0, e_items.shape[0], blk):
            e = e_items[None, s:s + blk]  # [1, blk, 3, K]
            alpha = self._attention(att, gu, e)
            weighted = torch.sum(alpha * e, dim=-2)  # [B_u, blk, K]
            out.append(torch.sum(gu * weighted * Gi[None, s:s + blk], dim=-1))
        return torch.cat(out, dim=1)

    @torch.no_grad()
    def predict_user_block(self, user_ids, ctx=None, params=None) -> torch.Tensor:
        p = self.params_or_own(params)
        e_items = ctx if ctx is not None else self.precompute_eval(p)
        return self._scores_against_all(param_group(p, "attention"), p["Gu"][user_ids],
                                        e_items, p["Gi"])

    def predict_all(self, params=None) -> torch.Tensor:
        ids = torch.arange(self.num_users, device=self.device)
        return self.predict_user_block(ids, self.precompute_eval(params), params)

    @torch.no_grad()
    def attention_weights(self, user_ids, ctx=None, params=None) -> torch.Tensor:
        """[B_u, I, 3] modality attention per user x item, the payload of
        the attention dump (Evaluator.py:241-259); blocked over items like
        the scoring path."""
        p = self.params_or_own(params)
        e_items = ctx if ctx is not None else self.precompute_eval(p)
        att = param_group(p, "attention")
        gu = p["Gu"][user_ids][:, None, :]
        blk = min(self.item_block, e_items.shape[0])
        out = [self._attention(att, gu, e_items[None, s:s + blk])[..., 0]
               for s in range(0, e_items.shape[0], blk)]
        return torch.cat(out, dim=1)
