"""Generic packed-state LazyAdam engine (port of
``fashionvisualexpl_tpu/train/packed_generic.py``).

A model opts in with ``packed_spec()`` (which params are user-row tables,
item-row tables, item scalars folded into the item rows, and dense params
updated by ordinary Adam) and ``packed_loss`` (its ``loss`` over the
gathered row views).  The engine owns the rest:

- row packing: a user row is [p | moments | tau (| row_align pads)], an
  item row [p | moments | scalar groups (| frozen columns) | tau (|
  pads)].  The moments are [m | v] in float32, one bf16 pair per column
  (``moment_dtype="bfloat16"``) or four e5m2 codes per column
  (``"float8"``), bit-cast to float32; tau, the row's last-touch step, is
  float32 (exact below 2**24);
- per step four row gathers (the forward user and item rows, then the
  deduped user and item rows) through K4 (``ops/gather.py::gather_rows``)
  and two row writes through K5 (``ops/row_scatter.py::scatter_rows_set``);
  a spec with ``extra_items`` E (ACF's profile over each user's positives)
  adds a fifth gather, the B * E item rows of ``packed_extra_item_ids``,
  whose gradients join the pos and neg rows' in the one item dedupe
  (2B + B * E ids), so K5 writes them back with the rest.
  On CUDA tensors those are the hand-written kernels; on CPU tensors their
  plain versions.  The JAX package uses XLA's ``take`` and ``.at[].set``
  here; the functions are the same, gathers and sets being exact copies;
- the gradient with respect to the gathered views (leaves that require
  grad), not through the gather; one dedupe per table
  (``compact_row_grads``); LazyAdam on the touched rows only, with the
  closed-form momentum tail when ``lazy_catchup``; dense Adam on the dense
  params;
- fused frozen columns (``pack_generic_state(frozen=...)`` with a
  ``fused_frozen=True`` step): a spec's ``frozen_item_tables`` (VBPR's F,
  GradFashion's Fc and Fe, ACF's Fspat) ride the item rows, so the loss
  reads them out of the forward item gathers, the extra rows' included
  (``frozen_vw``), and the item scatter writes them back unchanged.  A
  VBPR item row at K=128, dim_f=4096 and float32 moments is 4,484 columns,
  of which 388 change; an ACF row at K=128 over 7x7x512 maps 25,857, of
  which 768 change.

The dedupe pads unused segments with the id 2**30.  The unique-row gather
reads some row for them (K4 clamps, JAX's ``take`` gives NaN rows) and the
scatter drops them, so they reach no table.  ``train/fast.py::pad_safe_ids``
must not be used here: it would turn a pad into a duplicate of a real id.

The step updates ``user_pmv`` and ``item_pmv`` in place (JAX donates them)
and returns a new ``GenericPackedState`` holding them, the new step and the
new dense params.  The sharded form of the engine is
``parallel/fast_spmd.py``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
from fashionvisualexpl_tpu_torch.models.base import PackedSpec
from fashionvisualexpl_tpu_torch.ops.gather import gather_rows
from fashionvisualexpl_tpu_torch.ops.row_scatter import scatter_rows_set
from fashionvisualexpl_tpu_torch.train.fast import (
    B1,
    B2,
    EPS,
    compact_row_grads,
    dense_adam,
)
from fashionvisualexpl_tpu_torch.train.packed import (
    _lazy_rows,
    _loss_grads,
    _momentum_catchup,
    _offsets,
    ieee_sqrt,
)
from fashionvisualexpl_tpu_torch.train.trainer import fold_in, split_seed

# a dense entry: one parameter, or a group's {member name: tensor}
Dense = Union[torch.Tensor, Dict[str, torch.Tensor]]
MOMENT_DTYPES = ("float32", "bfloat16", "float8")


class GenericPackedState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    user_pmv: torch.Tensor  # [U, Wu + mom(Wu) + 1 (+ pad)]
    item_pmv: torch.Tensor  # [I, Wi + mom(Wi) + gs * nS (+ frozen) + 1 (+ pad)]
    dense: Dict[str, Tuple[Dense, Dense, Dense]]  # name -> (p, m, v)


def moment_dtype_name(moment_dtype) -> str:
    """The moment layout's name; None is "float32"."""
    if moment_dtype is None:
        return "float32"
    if moment_dtype in MOMENT_DTYPES:
        return moment_dtype
    raise ValueError(f"moment_dtype {moment_dtype!r} not float32/bfloat16/float8")


def _moment_cols(moment_dtype) -> int:
    """Columns per logical parameter column: 3 ([p | m | v] float32) or 2
    ([p | mv], the bf16 pair).  float8 moments have no uniform per-column
    width (four codes share one column): the sharded engine
    (``parallel/fast_spmd.py``), built on this helper, refuses them."""
    md = moment_dtype_name(moment_dtype)
    if md == "float8":
        raise ValueError(
            "moment_dtype 'float8' is single-device only (the sharded packed "
            "engine's column groups assume a uniform per-column moment width) "
            "— use 'bfloat16' over a mesh"
        )
    return 3 if md == "float32" else 2


def _mom_width(moment_dtype, w: int) -> int:
    """Moment columns for a ``w``-wide parameter block: float32 [m | v]
    (2w), bfloat16 one packed pair per column (w), float8 four e5m2 codes
    (m, v of two parameter columns) per column (ceil(w / 2))."""
    return {"float32": 2 * w, "bfloat16": w, "float8": (w + 1) // 2}[
        moment_dtype_name(moment_dtype)]


def _scalar_group(moment_dtype) -> int:
    """Columns per item-scalar group: [p | m | v] for float32, [p | mv]
    (the bf16 pair) for bfloat16 and float8 alike."""
    return 3 if moment_dtype_name(moment_dtype) == "float32" else 2


def _as_f32(bits: torch.Tensor) -> torch.Tensor:
    """int64 tensor of 32-bit patterns (0 <= bits < 2**32) -> float32 with
    those bits (wrapped to int32 explicitly, then bit-cast)."""
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def _u32(col: torch.Tensor) -> torch.Tensor:
    """The bits of a float32 tensor as int64 in [0, 2**32)."""
    return col.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 (round to nearest even) -> its 16 bits as int64."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def _mv_pack(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(m, v) float32 -> one float32 column carrying (bf16(m) << 16) |
    bf16(v).  Zero bits decode to (0, 0), which the zero init relies on."""
    return _as_f32((_bf16_bits(m) << 16) | _bf16_bits(v))


def _mv_unpack(col: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``_mv_pack``: a bf16 is the top half of a float32."""
    bits = _u32(col)
    return _as_f32(bits & 0xFFFF0000), _as_f32((bits & 0xFFFF) << 16)


# static pre-scale moving float8-stored moments off e5m2's subnormal floor
# (2**-16): the JAX package's choice, kept for bit-equal rows
_FP8_SCALE = 256.0


def _e5m2_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> e5m2 (round to nearest even; inf above the largest
    finite code, no saturation) -> its 8 bits as int64."""
    return x.to(torch.float8_e5m2).view(torch.uint8).to(torch.int64)


def _e5m2_value(bits: torch.Tensor) -> torch.Tensor:
    """The low 8 bits of an int64 tensor read as e5m2, as float32."""
    return (bits & 0xFF).to(torch.uint8).view(torch.float8_e5m2).to(torch.float32)


def _mv_pack_fp8(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(m, v) float32 [S, W] -> [S, ceil(W / 2)] float32 columns of four
    e5m2 codes (m0, v0, m1, v1 from the top byte down; odd W pads a zero
    pair).  v is stored as sqrt(v); both are scaled by 256 first."""
    if m.shape[1] % 2:
        m, v = F.pad(m, (0, 1)), F.pad(v, (0, 1))
    mb = _e5m2_bits(m * _FP8_SCALE)
    vb = _e5m2_bits(ieee_sqrt(v) * _FP8_SCALE)
    quad = ((mb[:, 0::2] << 24) | (vb[:, 0::2] << 16)
            | (mb[:, 1::2] << 8) | vb[:, 1::2])
    return _as_f32(quad)


def _mv_unpack_fp8(cols: torch.Tensor, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``_mv_pack_fp8``: [S, ceil(w / 2)] -> (m [S, w], v [S, w])."""
    bits = _u32(cols)
    S, H = bits.shape

    def dec(shift):
        return _e5m2_value(bits >> shift) / _FP8_SCALE

    m = torch.stack([dec(24), dec(8)], dim=2).reshape(S, 2 * H)
    s = torch.stack([dec(16), dec(0)], dim=2).reshape(S, 2 * H)
    return m[:, :w], torch.square(s[:, :w])


def _lazy_rows_fp8(rows, g, dt, t, lr, catchup: bool = False):
    """LazyAdam on gathered rows [S, K + ceil(K / 2)] (p | mv8 groups), g
    [S, K]: the moment math in float32, storage in e5m2."""
    K = g.shape[1]
    p = rows[:, :K]
    m, v = _mv_unpack_fp8(rows[:, K:], K)
    if catchup:
        p = _momentum_catchup(p, m, v, dt, t, lr)
    m = m * torch.pow(B1, dt) + (1.0 - B1) * g
    v = v * torch.pow(B2, dt) + (1.0 - B2) * torch.square(g)
    m_hat = m / (1.0 - torch.pow(B1, t))
    v_hat = v / (1.0 - torch.pow(B2, t))
    p = p - lr * m_hat / (ieee_sqrt(v_hat) + EPS)
    return torch.cat([p, _mv_pack_fp8(m, v)], dim=1)


def _lazy_rows_bf16(rows, g, dt, t, lr, catchup: bool = False):
    """LazyAdam on gathered rows [S, 2K] (p | mv groups), g [S, K]: the
    moment math in float32, storage in bf16 pairs."""
    K = g.shape[1]
    p = rows[:, :K]
    m, v = _mv_unpack(rows[:, K:2 * K])
    if catchup:
        p = _momentum_catchup(p, m, v, dt, t, lr)
    m = m * torch.pow(B1, dt) + (1.0 - B1) * g
    v = v * torch.pow(B2, dt) + (1.0 - B2) * torch.square(g)
    m_hat = m / (1.0 - torch.pow(B1, t))
    v_hat = v / (1.0 - torch.pow(B2, t))
    p = p - lr * m_hat / (ieee_sqrt(v_hat) + EPS)
    return torch.cat([p, _mv_pack(m, v)], dim=1)


def _row_pad(width: int, row_align: int) -> int:
    """Dead trailing columns that make a packed-row width a multiple of
    ``row_align`` (the JAX package's capacity mode; the columns pass
    through the step untouched)."""
    if row_align <= 1:
        return 0
    if row_align > 128:
        raise ValueError("row_align > 128 defeats moment-dtype inference")
    return (-width) % row_align


def _dense_params(params: Mapping[str, torch.Tensor], name: str) -> Dense:
    """Copies of dense entry ``name``: the parameter itself, or the group's
    members ``name.*`` keyed without the prefix."""
    if name in params:
        return params[name].detach().clone()
    n = len(name) + 1
    group = {k[n:]: v.detach().clone() for k, v in params.items()
             if k.startswith(name + ".")}
    if not group:
        raise KeyError(f"dense entry {name!r} is neither a parameter nor a group")
    return group


def _flat_dense(name: str, p: Dense) -> Dict[str, torch.Tensor]:
    """A dense entry under the model's parameter names."""
    if isinstance(p, torch.Tensor):
        return {name: p}
    return {f"{name}.{k}": v for k, v in p.items()}


def _zeros_like(p: Dense) -> Dense:
    if isinstance(p, torch.Tensor):
        return torch.zeros_like(p)
    return {k: torch.zeros_like(v) for k, v in p.items()}


@torch.no_grad()
def pack_generic_state(model, params: Mapping[str, torch.Tensor], frozen=None,
                       moment_dtype="float32", row_align: int = 1) -> GenericPackedState:
    """Pack ``params`` (the model's parameters by name, e.g.
    ``dict(model.named_parameters())``) into fresh rows with zero moments
    and tau; the dense entries are copied with zero moments.  Nothing
    shares storage with ``params``.  With ``frozen`` (name -> tensor, e.g.
    ``dict(model.named_buffers())``) the spec's ``frozen_item_tables`` are
    copied into the item rows after the scalar groups, for a
    ``fused_frozen=True`` step.  ``moment_dtype``: see the module
    docstring; ``row_align`` pads each row width to a multiple of it."""
    spec: PackedSpec = model.packed_spec()
    md = moment_dtype_name(moment_dtype)
    u_offs, Wu = _offsets(spec.user_tables)
    i_offs, Wi = _offsets(spec.item_tables)
    gs = _scalar_group(md)
    first = params[spec.user_tables[0][0]]
    U, dtype, dev = first.shape[0], first.dtype, first.device
    I = params[spec.item_tables[0][0]].shape[0]

    u_base = Wu + _mom_width(md, Wu) + 1
    user = torch.cat(
        [params[n].detach() for n, _, _ in u_offs]
        + [torch.zeros(U, _mom_width(md, Wu) + 1 + _row_pad(u_base, row_align),
                       dtype=dtype, device=dev)],
        dim=1,
    )  # m, v (packed) + tau (+ alignment pad)
    parts = [params[n].detach() for n, _, _ in i_offs] + [
        torch.zeros(I, _mom_width(md, Wi), dtype=dtype, device=dev)]
    for s in spec.item_scalars:
        parts += [params[s].detach()[:, None],
                  torch.zeros(I, gs - 1, dtype=dtype, device=dev)]
    if frozen is not None:
        for name, w in spec.frozen_item_tables:
            col = frozen[name].detach().reshape(I, -1).to(dtype)
            if col.shape[1] != w:
                raise ValueError(f"frozen table {name!r}: declared width {w} != "
                                 f"flattened width {col.shape[1]}")
            parts.append(col)
    i_base = 1 + sum(int(p.shape[1]) for p in parts)  # + tau
    parts.append(torch.zeros(I, 1 + _row_pad(i_base, row_align), dtype=dtype,
                             device=dev))  # tau (+ alignment pad)
    item = torch.cat(parts, dim=1)

    dense = {}
    for name in spec.dense:
        p = _dense_params(params, name)
        dense[name] = (p, _zeros_like(p), _zeros_like(p))
    return GenericPackedState(torch.zeros((), dtype=torch.int32, device=dev),
                              user, item, dense)


def infer_moment_dtype(state: GenericPackedState, spec: PackedSpec) -> str:
    """The moment layout from the user row width Wu + mom(Wu) + 1 (+ pad):
    unique for unpadded rows; raises when row_align padding leaves several
    layouts possible (pass ``moment_dtype`` then) or none."""
    _, Wu = _offsets(spec.user_tables)
    wu_total = state.user_pmv.shape[1]
    order = ("bfloat16", "float32", "float8")
    bases = {c: Wu + _mom_width(c, Wu) + 1 for c in order}
    exact = [c for c in order if bases[c] == wu_total]
    viable = [c for c in order if 0 <= wu_total - bases[c] < 128]
    if exact:
        return exact[0]
    if len(viable) == 1:
        return viable[0]
    if viable:
        raise ValueError(
            f"user row width {wu_total} is row_align-padded and matches several "
            f"moment layouts {viable} for Wu={Wu} — pass moment_dtype explicitly"
        )
    raise ValueError(f"user row width {wu_total} does not match any moment layout "
                     f"for Wu={Wu}")


@torch.no_grad()
def unpack_generic_params(state: GenericPackedState, spec: PackedSpec,
                          moment_dtype=None) -> Dict[str, torch.Tensor]:
    """The standard params mapping (the model's parameter names) from the
    packed state, as fresh contiguous copies: the step writes the packed
    tables in place, so no view of them is handed out.  The moment layout
    is ``moment_dtype`` when given, else inferred (``infer_moment_dtype``)."""
    u_offs, _ = _offsets(spec.user_tables)
    i_offs, Wi = _offsets(spec.item_tables)
    md = (moment_dtype_name(moment_dtype) if moment_dtype is not None
          else infer_moment_dtype(state, spec))
    gs = _scalar_group(md)
    sc0 = Wi + _mom_width(md, Wi)

    def copy(x):
        return x.clone(memory_format=torch.contiguous_format)

    params = {}
    for n, off, w in u_offs:
        params[n] = copy(state.user_pmv[:, off:off + w])
    for n, off, w in i_offs:
        params[n] = copy(state.item_pmv[:, off:off + w])
    for j, s in enumerate(spec.item_scalars):
        params[s] = copy(state.item_pmv[:, sc0 + gs * j])
    for name, (p, _, _) in state.dense.items():
        params.update({k: copy(v) for k, v in _flat_dense(name, p).items()})
    return params


def make_generic_packed_step(model, lr: float, reg: float, fused_frozen: bool = False,
                             moment_dtype: str = "float32",
                             lazy_catchup: bool = False) -> Callable:
    """``step(state, (frozen, (users, pos, neg), rng)) -> (state, loss)``:
    one packed LazyAdam step (module docstring).  ``fused_frozen=True``
    needs a state packed with ``frozen`` (for a spec without frozen tables
    it changes nothing); the loss then gets the frozen rows as
    ``frozen_vw``.  A spec with ``extra_items`` E also hands the loss
    ``extra_vw`` (table -> [B, E, width]).  ``moment_dtype`` must be
    the one the state was packed with; ``lazy_catchup=True`` applies the
    closed-form momentum tail of the skipped steps on touch
    (``train/packed.py::_momentum_catchup``).  ``rng`` goes to
    ``model.packed_loss`` (a dropout generator, masks or None)."""
    spec: PackedSpec = model.packed_spec()
    E = spec.extra_items
    md = moment_dtype_name(moment_dtype)
    u_offs, Wu = _offsets(spec.user_tables)
    i_offs, Wi = _offsets(spec.item_tables)
    nS = len(spec.item_scalars)
    f_offs, frozen_w = _offsets(spec.frozen_item_tables)
    fused_frozen = bool(fused_frozen and spec.frozen_item_tables)
    rows_fn = {"float32": _lazy_rows, "bfloat16": _lazy_rows_bf16,
               "float8": _lazy_rows_fp8}[md]
    lazy_rows = functools.partial(rows_fn, catchup=lazy_catchup)
    # float8 scalars keep the bf16 pair layout (see _scalar_group)
    sc_fn = _lazy_rows_bf16 if md == "float8" else rows_fn
    lazy_scalar_rows = functools.partial(sc_fn, catchup=lazy_catchup)
    gs = _scalar_group(md)
    sc0 = Wi + _mom_width(md, Wi)  # scalar groups start here
    tau_u = Wu + _mom_width(md, Wu)  # row_align pads trail after tau
    F0 = sc0 + gs * nS  # frozen columns start here, when fused
    tau_i = F0 + (frozen_w if fused_frozen else 0)

    def stamp(rows, t):
        """The new rows' tau column: the step t."""
        return t.reshape(1, 1).expand(rows.shape[0], 1)

    @torch.no_grad()
    def step(state: GenericPackedState, batch):
        frozen, (u, p_ids, n_ids), rng = batch
        u, p_ids, n_ids = (x.to(torch.int32) for x in (u, p_ids, n_ids))
        B = u.shape[0]
        ii = torch.cat([p_ids, n_ids])
        ids = (u.long(), p_ids.long(), n_ids.long())

        UR = gather_rows(state.user_pmv, u)  # [B, Wu_total]
        IR = gather_rows(state.item_pmv, ii)  # [2B, Wi_total]
        user_vw = {n: UR[:, off:off + w] for n, off, w in u_offs}
        pos_vw = {n: IR[:B, off:off + w] for n, off, w in i_offs}
        neg_vw = {n: IR[B:, off:off + w] for n, off, w in i_offs}
        for j, s in enumerate(spec.item_scalars):
            col = sc0 + gs * j
            pos_vw[s] = IR[:B, col]
            neg_vw[s] = IR[B:, col]
        # the extra item rows the loss reads (ACF's positive sets): gathered
        # here, differentiated with pos and neg, written back through the
        # same item dedupe below
        extra_vw = {}
        if E:
            xids = model.packed_extra_item_ids(frozen, ids).reshape(-1).to(torch.int32)
            XR = gather_rows(state.item_pmv, xids)  # [B * E, Wi_total]
            extra_vw = {n: XR[:, off:off + w].reshape(B, E, w) for n, off, w in i_offs}
            for j, s in enumerate(spec.item_scalars):
                extra_vw[s] = XR[:, sc0 + gs * j].reshape(B, E)
            ii = torch.cat([ii, xids])
        dense_p = {}
        for name in spec.dense:
            dense_p.update(_flat_dense(name, state.dense[name][0]))
        kw = {}
        if fused_frozen:  # constants of the loss, out of the same gathers
            sides = [("pos", IR[:B], (B,)), ("neg", IR[B:], (B,))]
            if E:
                sides.append(("extra", XR, (B, E)))
            kw["frozen_vw"] = {
                side: {n: rows[:, F0 + off:F0 + off + w].reshape(*lead, w)
                       for n, off, w in f_offs}
                for side, rows, lead in sides}

        loss, (gU, gP, gN, gD, gX) = _loss_grads(
            model, user_vw, pos_vw, neg_vw, dense_p, frozen, ids, reg, rng,
            extra_vw=extra_vw if E else None, **kw)
        t = (state.step + 1).to(torch.float32)

        # users: all user tables share one packed row and one dedupe; the
        # tau column rides the same gather and scatter
        uids, cg = compact_row_grads(u, torch.cat([gU[n] for n, _, _ in u_offs], dim=1), B)
        rows = gather_rows(state.user_pmv, uids)  # pads read some row ...
        dt = (t - rows[:, tau_u])[:, None]
        new_rows = torch.cat([lazy_rows(rows[:, :tau_u], cg, dt, t, lr),
                              stamp(rows, t), rows[:, tau_u + 1:]], dim=1)
        scatter_rows_set(state.user_pmv, uids, new_rows)  # ... and are dropped

        # items: vector tables and scalars (and the extra rows) share one dedupe
        gi_parts = [torch.cat([gP[n], gN[n]] + ([gX[n].reshape(B * E, w)] if E else []))
                    for n, _, w in i_offs]
        gi_parts += [torch.cat([gP[s], gN[s]] + ([gX[s].reshape(B * E)] if E else []))[:, None]
                     for s in spec.item_scalars]
        iids, cgi = compact_row_grads(ii, torch.cat(gi_parts, dim=1), 2 * B + B * E)
        rows = gather_rows(state.item_pmv, iids)
        dt = (t - rows[:, tau_i])[:, None]
        parts = [lazy_rows(rows[:, :sc0], cgi[:, :Wi], dt, t, lr)]
        if nS:
            S = rows.shape[0]
            sc_rows = rows[:, sc0:F0].reshape(S * nS, gs)
            sc_g = cgi[:, Wi:].reshape(S * nS, 1)
            sc_dt = dt.expand(S, nS).reshape(S * nS, 1)
            parts.append(lazy_scalar_rows(sc_rows, sc_g, sc_dt, t, lr).reshape(S, gs * nS))
        # frozen columns and alignment pads pass through
        parts += [rows[:, F0:tau_i], stamp(rows, t), rows[:, tau_i + 1:]]
        scatter_rows_set(state.item_pmv, iids, torch.cat(parts, dim=1))

        # dense params (tensors or groups): ordinary Adam, out of place
        dense = {}
        for name in spec.dense:
            p, m, v = state.dense[name]
            if isinstance(p, torch.Tensor):
                dense[name] = dense_adam(p, m, v, gD[name], lr, t)
            else:
                outs = {k: dense_adam(p[k], m[k], v[k], gD[f"{name}.{k}"], lr, t)
                        for k in p}
                dense[name] = tuple({k: o[i] for k, o in outs.items()} for i in range(3))

        return (GenericPackedState(state.step + 1, state.user_pmv, state.item_pmv, dense),
                loss.detach())

    return step


def run_packed_steps(step_fn: Callable, state: GenericPackedState, frozen,
                     triples, step_key: int):
    """The packed steps over one epoch's triples ([steps, batch] each), step
    s with a dropout generator on the state's device seeded with
    ``fold_in(step_key, s)``, as the generic ``Trainer`` seeds it.  Returns
    (state, summed loss as a 0-d device tensor)."""
    users, pos, neg = (t.to(torch.int32) for t in triples)
    dev = state.user_pmv.device
    losses = torch.empty(users.shape[0], dtype=torch.float32, device=dev)
    for s in range(users.shape[0]):
        rng = torch.Generator(device=dev).manual_seed(fold_in(step_key, s))
        state, losses[s] = step_fn(state, (frozen, (users[s], pos[s], neg[s]), rng))
    return state, torch.sum(losses)


def make_generic_packed_epoch_fn(
    model, lr: float, reg: float, num_items: int, steps: int, batch: int,
    with_replacement=True, fused_frozen: bool = False,
    moment_dtype: str = "float32", lazy_catchup: bool = False,
    device: DeviceLike = None,
) -> Callable:
    """``epoch(state, frozen, key, train_pairs, padded_pos, pos_counts) ->
    (state, summed loss)``: the triples of one epoch sampled on ``device``
    (``None`` = the CUDA card; raises without one) from ``split_seed(key)``'s
    first seed, then ``run_packed_steps`` with its second, as the generic
    ``Trainer``'s epoch.  Options: see ``make_generic_packed_step``."""
    dev = resolve_device(device)
    step_fn = make_generic_packed_step(model, lr, reg, fused_frozen=fused_frozen,
                                       moment_dtype=moment_dtype,
                                       lazy_catchup=lazy_catchup)

    def epoch(state: GenericPackedState, frozen, key: int, train_pairs,
              padded_pos, pos_counts):
        sample_key, step_key = split_seed(key)
        triples = sample_triplets(sample_key, train_pairs, padded_pos, pos_counts,
                                  num_items, steps, batch,
                                  with_replacement=with_replacement, device=dev)
        return run_packed_steps(step_fn, state, frozen, triples, step_key)

    return epoch


class GenericPackedTrainState:
    """A packed state as ``fit`` sees a train state: ``.step``, and
    ``.params``, the standard mapping as fresh copies (for evaluation, the
    best-params copy and the dumps; never used inside the step).
    ``moment_dtype`` is kept (inferred from the widths when None) so that
    row_align-padded layouts unpack unambiguously; a checkpoint stores the
    fields named in ``_fields`` (``core/checkpoint.py``)."""

    _fields = ("inner", "moment_dtype")

    def __init__(self, inner: GenericPackedState, spec: PackedSpec,
                 moment_dtype: Optional[str] = None):
        self.inner = inner
        self.spec = spec
        self.moment_dtype = (moment_dtype_name(moment_dtype) if moment_dtype is not None
                             else infer_moment_dtype(inner, spec))

    def with_inner(self, inner: GenericPackedState) -> "GenericPackedTrainState":
        return GenericPackedTrainState(inner, self.spec, self.moment_dtype)

    @property
    def step(self) -> torch.Tensor:
        return self.inner.step

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return unpack_generic_params(self.inner, self.spec, self.moment_dtype)
