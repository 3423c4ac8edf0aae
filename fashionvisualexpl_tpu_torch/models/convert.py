"""Carry the JAX package's parameters and train states into the port, bit
for bit.

The JAX package's params are a dict of arrays (nested for the encoder
models); hand them over as numpy (``{k: np.asarray(v) for k, v in
params.items()}``, or ``jax.tree.map(np.asarray, params)``) so this module
needs no JAX.  Nested groups become the port's dotted parameter names
(``params["color_enc"]["W1"]`` -> ``"color_enc.W1"``).  The copy is exact,
so both packages then compute on the same weights, and a mid-run optimizer
state (step, moments, last-touch steps, packed rows with their bit-packed
moment columns) carries across as well.  The vision backbones' params
(``resnet_from_jax``, ``vgg19_from_jax``) carry across with their conv
kernels transposed from JAX's HWIO to the port's OIHW.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.models.acf import ACF
from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
from fashionvisualexpl_tpu_torch.models.base import Features
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.models.comp_vbpr import USER_TABLES, CompVBPR
from fashionvisualexpl_tpu_torch.models.grad_fashion import GradFashion
from fashionvisualexpl_tpu_torch.models.vbpr import VBPR


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


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested JAX params -> {dotted name: array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_params(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _copy_into(model, params: Dict[str, np.ndarray]) -> None:
    """Copy the JAX params (flat names) into ``model``'s parameters, which
    must be exactly the same set."""
    own = dict(model.named_parameters())
    if set(params) != set(own):
        raise ValueError(f"JAX params {sorted(params)} != the port's {sorted(own)}")
    with torch.no_grad():
        for name, p in own.items():
            arr = _f32(params, name, p.dim())
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != the port's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))


def attentive_fashion_from_jax(
    jax_model, params, frozen, device: DeviceLike = None
) -> AttentiveFashion:
    """An ``AttentiveFashion`` holding exactly a JAX AttentiveFashion's
    params and modality inputs.  ``jax_model`` is the JAX model object
    (its configuration is read from its attributes, nothing is imported);
    ``params`` its nested params and ``frozen`` its ``Fc``, ``Fe_img``,
    ``Fcls``, all as numpy.  A ``host_features`` model has an empty
    ``frozen``: its host arrays ``_color``, ``_edges``, ``_class`` are taken
    as they are (memmaps stay memmaps).  ``conv_W`` keeps JAX's HWIO [5, 5,
    1, C]; the compute dtype is the JAX model's (``compute_dtype.name``)."""
    host = bool(getattr(jax_model, "host_features", False))
    if host:
        inputs = (jax_model._color, jax_model._edges, jax_model._class)
    else:
        inputs = tuple(np.asarray(frozen[k], np.float32) for k in ("Fc", "Fe_img", "Fcls"))
    model = AttentiveFashion(
        jax_model.num_users, jax_model.num_items, *inputs, host_features=host,
        embed_k=jax_model.embed_k, attention_layers=jax_model.attention_layers,
        encoder_hidden=jax_model.encoder_hidden, dropout_rate=jax_model.dropout_rate,
        conv_filters=jax_model.conv_filters, item_block=jax_model.item_block,
        batch_eval=jax_model.batch_eval, edge_tower=jax_model.edge_tower,
        compute_dtype=jax_model.compute_dtype.name, device=device,
    )
    _copy_into(model, flatten_params(params))
    return model


def vbpr_from_jax(params: Dict[str, np.ndarray], features: Features,
                  device: DeviceLike = None) -> VBPR:
    """A ``VBPR`` holding exactly the JAX VBPR's params (numpy) over the
    frozen ``features`` [I, dim_f], taken as given (the JAX model's
    ``frozen["F"]``, or the array it was built from)."""
    gu, tu = _f32(params, "Gu", 2), _f32(params, "Tu", 2)
    model = VBPR(gu.shape[0], features.shape[0], features, embed_k=gu.shape[1],
                 embed_d=tu.shape[1], device=device)
    _copy_into(model, params)
    return model


def grad_fashion_from_jax(params: Dict[str, np.ndarray], color_features: Features,
                          edge_features: Features, device: DeviceLike = None) -> GradFashion:
    """A ``GradFashion`` holding exactly the JAX GradFashion's params
    (numpy) over the frozen color and edge features, taken as given; the
    widths are read from the params' shapes."""
    gu, tu = _f32(params, "Gu", 2), _f32(params, "Tu", 2)
    ec, ee = _f32(params, "Ec", 2), _f32(params, "Ee", 2)
    model = GradFashion(gu.shape[0], color_features.shape[0], color_features,
                        edge_features, embed_k=gu.shape[1], embed_d=tu.shape[1],
                        embed_color=ec.shape[1], embed_edges=ee.shape[1], device=device)
    _copy_into(model, params)
    return model


def acf_from_jax(params, spatial: Features, data=None, device: DeviceLike = None,
                 **kw) -> ACF:
    """An ``ACF`` holding exactly the JAX ACF's params (nested ``comp`` /
    ``item`` groups, numpy) over the spatial maps ``spatial`` [I, S, C],
    taken as given.  ``data`` and ``kw`` (``max_user_pos``, ``seed``,
    ``padded_positives``, ``positive_counts``, ``exact_eval``,
    ``exact_train``, ``pos_chunk``, ``compute_dtype``) are ``ACF``'s, as
    the JAX model was built with them; the widths are read from the
    params' shapes."""
    flat = flatten_params(params)
    gu = _f32(flat, "Gu", 2)

    def layers(group):
        widths = [flat[f"{group}.W0_u"].shape[1]]
        while f"{group}.W{len(widths)}" in flat:
            widths.append(flat[f"{group}.W{len(widths)}"].shape[0])
        return tuple(widths)

    model = ACF(gu.shape[0], spatial.shape[0], spatial, data, embed_k=gu.shape[1],
                layers_component=layers("comp"), layers_item=layers("item"), device=device,
                **kw)
    _copy_into(model, flat)
    return model


def comp_vbpr_from_jax(params, semantic: Optional[Features] = None,
                       color: Optional[Features] = None, edges: Optional[Features] = None,
                       texture: Optional[Features] = None, device: DeviceLike = None,
                       **kw) -> CompVBPR:
    """A ``CompVBPR`` holding exactly the JAX CompVBPR's params (numpy; the
    nested ``params["cnn"]`` of HWIO convs becomes ``"cnn.conv1_W"`` ...,
    the layout the port keeps) over the frozen features and edge images,
    taken as given.  The active families are those whose ``Tu*`` the
    params hold (features of the others are ignored); K and d are read
    from the params' shapes; ``kw`` (``weight_components``,
    ``eval_encode_block``, ``compute_dtype``) are ``CompVBPR``'s, as the JAX
    model was built with them (the JAX CompVBPR hands its compute dtype to
    its CNN: ``jax_model.cnn.compute_dtype.name``)."""
    flat = flatten_params(params)
    gu = _f32(flat, "Gu", 2)
    act = tuple(t in flat for t in USER_TABLES)
    d = next((flat[t].shape[1] for t in USER_TABLES if t in flat), 20)
    feats = [f if a else None for f, a in zip((semantic, color, edges, texture), act)]
    model = CompVBPR(gu.shape[0], flat["Gi"].shape[0], *feats, embed_k=gu.shape[1],
                     embed_d=d, activated_components=act, device=device, **kw)
    _copy_into(model, flat)
    return model


def _copy_backbone(model, params):
    """Copy the JAX backbone params (nested, numpy) into ``model``'s
    parameters and buffers (the same names once flattened; the batch-norm
    statistics are buffers here), conv kernels HWIO -> OIHW."""
    flat = flatten_params(params)
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    if set(flat) != set(own):
        raise ValueError(f"JAX params {sorted(flat)} != the port's {sorted(own)}")
    with torch.no_grad():
        for name, t in own.items():
            arr = _f32(flat, name, t.dim())
            if t.dim() == 4:
                arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{name}: shape {arr.shape} != the port's {tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))
    return model


def resnet_from_jax(params, blocks: Tuple[int, ...], device: DeviceLike = None):
    """A ``vision.backbones.ResNet`` of ``blocks`` holding exactly the JAX
    ResNet's params (numpy; HWIO convs, ``fc_W`` [2048, classes])."""
    from fashionvisualexpl_tpu_torch.vision.backbones import ResNet

    num_classes = np.asarray(params["fc_W"]).shape[1]
    return _copy_backbone(ResNet(blocks, num_classes=num_classes, device=device), params)


def vgg19_from_jax(params, input_hw: Tuple[int, int] = (224, 224), device: DeviceLike = None):
    """A ``vision.backbones.VGG19`` at ``input_hw`` holding exactly the JAX
    VGG19's params (numpy; HWIO convs, ``fc1_W`` with rows in HWC order,
    kept so)."""
    from fashionvisualexpl_tpu_torch.vision.backbones import VGG19

    num_classes = np.asarray(params["fc3_W"]).shape[1]
    model = VGG19(num_classes=num_classes, input_hw=input_hw, device=device)
    return _copy_backbone(model, params)


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
    model,
    step,
    params: Dict[str, np.ndarray],
    count,
    mu: Dict[str, np.ndarray],
    nu: Dict[str, np.ndarray],
):
    """The port's ``TrainState`` for the generic trainer from a JAX
    ``TrainState`` handed over as numpy: ``params`` are copied into
    ``model``'s own parameters (which the state then holds); ``count``,
    ``mu`` and ``nu`` are optax's ``ScaleByAdamState`` fields.  Nested
    dicts are flattened to the port's dotted names."""
    from fashionvisualexpl_tpu_torch.core.train_state import AdamState, TrainState

    dev = model.device
    params, mu, nu = (flatten_params(t) for t in (params, mu, nu))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(_f32(params, name, p.dim())))
    return TrainState(
        _count(step, dev), dict(model.named_parameters()),
        AdamState(_count(count, dev), _tensors(mu, dev), _tensors(nu, dev)),
    )


def generic_packed_state_from_jax(jax_state, spec, device: DeviceLike = None):
    """The port's ``GenericPackedState`` holding exactly a JAX
    ``GenericPackedState`` (``jax.tree.map(np.asarray, state)``): the step,
    the packed user and item rows bit for bit (bf16 and fp8 moment columns
    included) and, for each of ``spec.dense``, (p, m, v) as a tensor or, for
    a nested group, ``{member: tensor}`` with dotted member names.  A state
    packed with fused frozen columns carries them in its item rows as
    they are."""
    from fashionvisualexpl_tpu_torch.train.packed_generic import GenericPackedState

    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.require(np.asarray(a), requirements=["C", "W"])).to(dev)

    def entry(x):
        if isinstance(x, dict):
            return {k: tensor(v) for k, v in flatten_params(x).items()}
        return tensor(x)

    dense = {name: tuple(entry(x) for x in jax_state.dense[name]) for name in spec.dense}
    return GenericPackedState(_count(jax_state.step, dev), tensor(jax_state.user_pmv),
                              tensor(jax_state.item_pmv), dense)


def packed_state_from_jax(jax_state, device: DeviceLike = None):
    """The port's specialized packed state (``train/packed.py``) holding
    exactly a JAX ``PackedLazyState``, ``PackedVbprState`` or
    ``PackedGradFashionState`` handed over as numpy
    (``jax.tree.map(np.asarray, state)``): the step, the packed user and
    item rows and both tau arrays bit for bit and, for VBPR and
    GradFashion, each dense (p, m, v)."""
    from fashionvisualexpl_tpu_torch.train.packed import PackedLazyState

    dev = resolve_device(device)
    t = _tensors({k: getattr(jax_state, k) for k in ("user_pmv", "item_pmv", "tau_u", "tau_i")},
                 dev)
    dense = {name: tuple(_tensors(dict(zip("pmv", pmv)), dev).values())
             for name, pmv in getattr(jax_state, "dense", {}).items()}
    return PackedLazyState(_count(jax_state.step, dev), t["user_pmv"], t["item_pmv"],
                           t["tau_u"], t["tau_i"], dense)
