"""Model base and shared init (port of ``fashionvisualexpl_tpu/models/base.py``).

In the JAX package a model is a stateless object over explicit ``(params,
frozen)`` pytrees.  In the port a model is an ``nn.Module`` that owns its
parameters, and the scoring methods read them from ``self`` unless they are
given a parameter mapping (``params=``, name -> tensor): the evaluators score
``fit``'s ``best_params`` copy that way without writing it into the model.
Random init
takes an explicit ``torch.Generator``; JAX's threefry draws cannot be
reproduced, so parity tests carry JAX's params across with
``models/convert.py`` instead.

A model opts into the packed LazyAdam engine (``train/packed_generic.py``)
with ``packed_spec`` and ``packed_loss``; the base versions raise.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

Features = Union[np.ndarray, torch.Tensor]
# a dropout source: a generator, or precomputed keep-masks in order
Dropout = Union[None, torch.Generator, Sequence[torch.Tensor]]
MaskDraw = Callable[[Tuple[int, ...], torch.device], torch.Tensor]


def keep_masks(rng: Dropout, keep: float) -> Optional[MaskDraw]:
    """A draw ``(shape, device) -> bool keep-mask`` from ``rng``: a
    ``torch.Generator`` (keep with probability ``keep``) or a sequence of
    precomputed masks handed out in order; None for no dropout."""
    if rng is None:
        return None
    if isinstance(rng, torch.Generator):
        return lambda shape, device: (
            torch.rand(shape, generator=rng, device=device) < keep
        )
    masks = iter(rng)

    def take(shape, device):
        mask = torch.as_tensor(next(masks), device=device)
        if tuple(mask.shape) != tuple(shape):
            raise ValueError(f"dropout mask {tuple(mask.shape)}, expected {tuple(shape)}")
        return mask.to(torch.bool)

    return take


def dropout(x: torch.Tensor, rate: float, draw: Optional[MaskDraw]) -> torch.Tensor:
    """Train-mode dropout (JAX's ``_dropout``): keep where ``draw`` says,
    dividing by the keep rate; ``x`` as it is without a draw."""
    if draw is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(draw(tuple(x.shape), x.device), x / keep, 0.0)


class PackedSpec(NamedTuple):
    """How a model's params map onto the packed-row engine
    (``train/packed_generic.py``): user/item row tables (name, width), item
    scalars folded into the item rows, and dense-Adam params (a parameter
    name, or a group prefix such as ``"color_enc"`` for all of
    ``"color_enc.*"``).

    ``extra_items`` > 0 declares that the loss reads E more item rows per
    batch element (ACF's profile over each user's positives);
    ``frozen_item_tables`` names per-item frozen feature tables (name,
    flattened width) that the engine may fold into the packed item rows
    (VBPR's F, GradFashion's Fc and Fe, ACF's spatial maps Fspat)."""

    user_tables: Tuple[Tuple[str, int], ...]
    item_tables: Tuple[Tuple[str, int], ...]
    item_scalars: Tuple[str, ...]
    dense: Tuple[str, ...]
    extra_items: int = 0
    frozen_item_tables: Tuple[Tuple[str, int], ...] = ()


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
    shape: Tuple[int, ...],
    generator: torch.Generator,
    device: torch.device,
) -> torch.Tensor:
    """GlorotUniform (tf.initializers.GlorotUniform / jax glorot_uniform):
    U(-l, l) with l = sqrt(6 / (fan_in + fan_out)), fan_in = shape[-2] * r,
    fan_out = shape[-1] * r, r the receptive field (the product of the other
    dims, e.g. 25 for a [5, 5, 1, C] conv kernel)."""
    receptive = math.prod(shape[:-2])
    limit = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * receptive))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.uniform_(-limit, limit, generator=generator)


def normal_init(
    shape: Tuple[int, ...],
    generator: torch.Generator,
    device: torch.device,
    stddev: float = 0.01,
) -> torch.Tensor:
    """RandomNormal(mean=0, stddev=0.01) (JAX ``normal_init``,
    AttentiveFashion.py:24)."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.normal_(0.0, stddev, generator=generator)


def frozen_buffer(features: Features, device: torch.device) -> torch.Tensor:
    """A float32 copy of ``features`` (numpy, or a tensor made on the card)
    on ``device``."""
    if isinstance(features, torch.Tensor):
        return features.detach().to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.require(features, np.float32, ["C", "W"])).to(device)


def param_group(p: Mapping[str, torch.Tensor], prefix: str) -> dict:
    """The entries of one parameter group, without the ``prefix.``."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + ".")}


class RecommenderModel(nn.Module):
    """Base interface.  Concrete models implement:

    - score(users, items) -> [B] pointwise scores
    - predict_all() -> [U, I] full score matrix
    - predict_user_block(user_ids, ctx, params) -> [B_u, I] score rows
    - factored_eval(params) -> (user [U, D], item [I, D], item bias [I] or
      None), for models whose scores factor (the serving index path)
    - precompute_eval(params) -> ctx for predict_user_block (None here)

    ``params`` is a mapping name -> tensor that takes the place of the
    model's own parameters; ``None`` reads the model's.
    """

    name: str = "base"
    # divides whole-matrix regularization under data parallelism (JAX
    # models/base.py:99-110); 1.0 on a single device
    global_reg_scale: float = 1.0

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

    def take(self, name: str, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """A table lookup inside ``loss`` / ``packed_loss`` (JAX
        ``self.take``): the plain row gather; ``name`` lets the SPMD engine
        (``parallel/spmd.py``) swap in the collective lookup for the
        row-sharded tables."""
        del name
        return table[ids]

    def row_sharded_params(self) -> tuple:
        """Names (parameters or buffers) of the tables row-sharded over the
        ``model`` mesh axis."""
        return ()

    def params_or_own(
        self, params: Optional[Mapping[str, torch.Tensor]]
    ) -> Mapping[str, torch.Tensor]:
        return dict(self.named_parameters()) if params is None else params

    # --- packed LazyAdam engine (train/packed_generic.py), optional ---

    def packed_spec(self) -> PackedSpec:
        """Row/dense layout for the packed engine; models that support
        ``train_path='packed'`` override this together with
        ``packed_loss``."""
        raise NotImplementedError(
            f"{self.name} does not implement the packed fast path"
        )

    def packed_loss(self, user_vw, pos_vw, neg_vw, dense, frozen, ids,
                    reg, rng=None, extra_vw=None):
        """``loss`` over gathered row views: ``user_vw`` / ``pos_vw`` /
        ``neg_vw`` map table names to [B, width] (scalars to [B]) slices of
        the packed rows; ``dense`` maps the dense params' names (dotted, as
        ``params=`` of the scoring methods takes them) to tensors;
        ``frozen`` is the model's buffers; ``ids = (users, pos, neg)``
        (int64) lets the model gather its own inputs; ``rng`` the step's
        dropout generator.  A model with ``extra_items`` also takes
        ``extra_vw`` (table -> [B, E, width], the rows of
        ``packed_extra_item_ids``); one with ``frozen_item_tables`` takes
        ``frozen_vw`` ({"pos" | "neg" (| "extra"): {table: [B (, E),
        width]}}, the frozen rows out of the packed item rows, when the
        step fuses them).  Must mirror ``loss`` exactly."""
        raise NotImplementedError(
            f"{self.name} does not implement the packed fast path"
        )

    def packed_extra_item_ids(self, frozen, ids):
        """[B, extra_items] int32 item ids the loss reads beyond pos/neg
        (only when ``packed_spec().extra_items > 0``: ACF); ``ids`` as
        ``packed_loss`` gets them."""
        raise NotImplementedError(
            f"{self.name} does not implement the packed fast path"
        )

    def precompute_eval(self, params: Optional[Mapping[str, torch.Tensor]] = None):
        """Optional once-per-evaluation precomputation, passed to
        ``predict_user_block`` as ``ctx``."""
        return None

    def predict_user_block(
        self,
        user_ids: torch.Tensor,
        ctx: Optional[object] = None,
        params: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        raise NotImplementedError
