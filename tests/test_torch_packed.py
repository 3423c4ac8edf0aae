"""Port packed LazyAdam engine (``train/packed.py``,
``train/packed_generic.py``, the Trainer's ``train_path="packed"``, the
packed checkpoints) vs the JAX package, on the CPU.

- ``_mv_pack*`` / ``_mv_unpack*``, ``_lazy_rows*`` and ``_momentum_catchup``:
  bit-equal on equal inputs (packed columns and results compared as
  uint32), the e5m2 casts at ties, subnormals, zero and above the largest
  finite code included.  JAX runs op by op here (no fusion), and the steps
  and ages stay below 31, where XLA's and torch's float32 ``pow`` agree to
  the bit;
- ``pack_generic_state`` / ``unpack_generic_params``: bit-equal for every
  moment dtype at row_align 1 and 128, with JAX's width-inference errors;
- the generic step over 6 steps from one state carried across by
  ``generic_packed_state_from_jax``: BPRMF over fp32 / bf16 / fp8 x catchup
  on / off x row_align 1 / 128, AttentiveFashion without dropout and with
  JAX's own dropout masks.  Losses rtol 1e-5 per step; params, decoded
  moments and dense (p, m, v) rtol 2e-4, atol 1e-6 (f32 sums in another
  order over the steps); tau and pad columns bit-equal;
- full coverage (``tests/test_packed_generic.py:158-231``): when every row
  is touched every step the packed step equals the port's generic Trainer
  (rtol 2e-5, atol 1e-5, the JAX test's);
- ACF's extra item rows (``packed_extra_item_ids``: each user's padded
  positives, padded slots on the batch element's own positive) over 3
  steps against JAX's: fp32 / bf16 / fp8 moments x the spatial maps fused
  into the item rows or read by id x catch-up on (row_align 128) / off
  (row_align 1), a zero-positive user among them: losses rtol 1e-5,
  states rtol 2e-4, atol 1e-6, the fused Fspat columns, tau and pads
  bit-equal; the extra ids bit-equal; fused bit-equal to unfused; full
  coverage as above; ``fit(train_path="packed")`` trains;
- ``Trainer(train_path="packed")`` from JAX's packed init, fed JAX's sampler
  draws, against JAX's ``Trainer``: losses rtol 1e-5, params rtol 2e-4,
  atol 1e-6;
- packed checkpoints: the round trip and ``fit(..., resume=True)`` are
  bit-equal to the uninterrupted run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.features import synthetic_features
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.models.acf import ACF as JACF
from fashionvisualexpl_tpu.models.attentive_fashion import AttentiveFashion as JAF
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu.train import packed as jpacked
from fashionvisualexpl_tpu.train import packed_generic as jpg
from fashionvisualexpl_tpu.train.trainer import Trainer as JTrainer
from fashionvisualexpl_tpu_torch.core.checkpoint import CheckpointManager
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.base import PackedSpec, RecommenderModel
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.models.convert import (
    acf_from_jax,
    attentive_fashion_from_jax,
    bprmf_from_jax,
    flatten_params,
    generic_packed_state_from_jax,
)
from fashionvisualexpl_tpu_torch.train import packed as tpacked
from fashionvisualexpl_tpu_torch.train import packed_generic as tpg
from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fit

STATE_TOL = dict(rtol=2e-4, atol=1e-6)
LR = 0.05


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _eq_bits(got, want, msg=""):
    np.testing.assert_array_equal(_bits(got.numpy() if isinstance(got, torch.Tensor) else got),
                                  _bits(want), err_msg=msg)


# --- bit mechanics -------------------------------------------------------


def _moments(rng, S, W):
    m = (rng.normal(size=(S, W)) * 10.0 ** rng.integers(-6, 1, (S, W))).astype(np.float32)
    v = (np.abs(rng.normal(size=(S, W))) * 10.0 ** rng.integers(-12, -1, (S, W))).astype(
        np.float32)
    m[0, :3], v[0, :3] = 0.0, 0.0
    return m, v


def _random_bit_cols(rng, S, W):
    return rng.integers(0, 2**32, (S, W), dtype=np.uint64).astype(np.uint32).view(np.float32)


def test_bf16_pair_packing_is_bit_equal():
    rng = np.random.default_rng(0)
    m, v = _moments(rng, 40, 9)
    # halfway cases of the bf16 rounding (ties to even both ways) and signs
    m[1, :4] = np.asarray([0x3F808000, 0x3F818000, 0xBF808000, 0x00018000],
                          np.uint32).view(np.float32)
    _eq_bits(tpg._mv_pack(_t(m), _t(v)), jpg._mv_pack(jnp.asarray(m), jnp.asarray(v)))
    cols = _random_bit_cols(rng, 40, 9)
    finite = np.isfinite(cols)
    for got, want in zip(tpg._mv_unpack(_t(cols)), jpg._mv_unpack(jnp.asarray(cols))):
        nan = np.isnan(np.asarray(want))
        _eq_bits(got.numpy()[~nan], np.asarray(want)[~nan])
        assert np.array_equal(np.isnan(got.numpy()), nan)
    assert finite.any()


def _e5m2_edges():
    """Values that exercise the e5m2 cast after the x256 pre-scale: every
    finite code, the midpoints between codes and their float32 neighbours
    (ties to even), subnormals, zero, and the region above 57344 (inf,
    not saturation)."""
    import ml_dtypes

    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e5m2).astype(np.float32)
    grid = np.unique(np.abs(grid[np.isfinite(grid)]))
    mids = ((grid[:-1].astype(np.float64) + grid[1:]) / 2).astype(np.float32)
    top = np.asarray([57344, 57345, 61439, 61440, 61441, 65536, 1e6], np.float32)
    vals = np.concatenate([grid, mids, np.nextafter(mids, np.float32(np.inf)),
                           np.nextafter(mids, np.float32(0)), top, [2.0**-17, 2.0**-18]])
    return vals.astype(np.float32) / 256.0


def test_fp8_quad_packing_is_bit_equal():
    rng = np.random.default_rng(1)
    edges = _e5m2_edges()
    n = len(edges) + (len(edges) % 2)
    m = np.zeros(n, np.float32)
    m[:len(edges)] = edges
    m = np.concatenate([m, -m]).reshape(-1, 2)
    v = np.square(np.abs(m[::-1]))  # stored as sqrt(v): the same edges
    # the edges at W = 2, random moments at W = 2 and 7 (odd W pads a zero pair)
    for a, b in [(m, v)] + [_moments(rng, 30, W) for W in (2, 7)]:
        want = jpg._mv_pack_fp8(jnp.asarray(a), jnp.asarray(b))
        _eq_bits(tpg._mv_pack_fp8(_t(a), _t(b)), want)
        for got, w in zip(tpg._mv_unpack_fp8(_t(np.asarray(want)), a.shape[1]),
                          jpg._mv_unpack_fp8(want, a.shape[1])):
            _eq_bits(got, w)
    packed = tpg._mv_pack_fp8(_t(np.asarray([[61441 / 256.0, 1.0]], np.float32)),
                              _t(np.zeros((1, 2), np.float32)))
    assert int(_bits(packed.numpy())[0, 0]) >> 24 == 0x7C  # +inf, not the largest code
    cols = _random_bit_cols(rng, 20, 5)
    for got, want in zip(tpg._mv_unpack_fp8(_t(cols), 9), jpg._mv_unpack_fp8(jnp.asarray(cols), 9)):
        nan = np.isnan(np.asarray(want))
        _eq_bits(got.numpy()[~nan], np.asarray(want)[~nan])
        assert np.array_equal(np.isnan(got.numpy()), nan)


def _row_case(moment_dtype, seed, S=24, K=6):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(S, K)).astype(np.float32)
    m, v = _moments(rng, S, K)
    pack = {"float32": lambda: np.concatenate([m, v], axis=1),
            "bfloat16": lambda: np.asarray(jpg._mv_pack(jnp.asarray(m), jnp.asarray(v))),
            "float8": lambda: np.asarray(jpg._mv_pack_fp8(jnp.asarray(m), jnp.asarray(v)))}
    rows = np.concatenate([p, pack[moment_dtype]()], axis=1)
    g = (rng.normal(size=(S, K)) * 0.01).astype(np.float32)
    t = np.float32(29.0)
    dt = rng.integers(0, 30, (S, 1)).astype(np.float32)
    return rows, g, dt, t


@pytest.mark.parametrize("catchup", [False, True], ids=["plain", "catchup"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "float8"])
def test_lazy_rows_are_bit_equal(moment_dtype, catchup):
    rows, g, dt, t = _row_case(moment_dtype, seed=3)
    jfn = {"float32": jpacked._lazy_rows, "bfloat16": jpg._lazy_rows_bf16,
           "float8": jpg._lazy_rows_fp8}[moment_dtype]
    tfn = {"float32": tpacked._lazy_rows, "bfloat16": tpg._lazy_rows_bf16,
           "float8": tpg._lazy_rows_fp8}[moment_dtype]
    want = jfn(jnp.asarray(rows), jnp.asarray(g), jnp.asarray(dt), jnp.asarray(t), LR,
               catchup=catchup)
    got = tfn(_t(rows), _t(g), _t(dt), torch.tensor(t), LR, catchup=catchup)
    _eq_bits(got, want)


def test_momentum_catchup_is_bit_equal():
    rng = np.random.default_rng(4)
    p = rng.normal(size=(16, 5)).astype(np.float32)
    m, v = _moments(rng, 16, 5)
    dt = rng.integers(0, 30, (16, 1)).astype(np.float32)
    t = np.float32(30.0)
    want = jpacked._momentum_catchup(*(jnp.asarray(a) for a in (p, m, v, dt, t)), LR)
    _eq_bits(tpacked._momentum_catchup(*(_t(a) for a in (p, m, v, dt)), torch.tensor(t), LR),
             want)


# --- packing -------------------------------------------------------------

U, I, K = 30, 40, 8


def _jax_bprmf(seed=0):
    jm = JBPRMF(U, I, embed_k=K)
    params, frozen = jm.init(jax.random.PRNGKey(seed))
    params["Bi"] = jnp.asarray(np.random.default_rng(seed).normal(size=I).astype(np.float32)
                               * 0.1)
    return jm, params, frozen


def _assert_tables_bit_equal(got: "tpg.GenericPackedState", want):
    _eq_bits(got.user_pmv, want.user_pmv, "user_pmv")
    _eq_bits(got.item_pmv, want.item_pmv, "item_pmv")
    assert int(got.step) == int(want.step)


@pytest.mark.parametrize("row_align", [1, 128])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "float8"])
def test_pack_and_unpack_are_bit_equal(moment_dtype, row_align):
    jm, params, _ = _jax_bprmf()
    model = bprmf_from_jax(_np(params), device="cpu")
    want = jpg.pack_generic_state(jm, params, moment_dtype=moment_dtype, row_align=row_align)
    got = tpg.pack_generic_state(model, dict(model.named_parameters()),
                                 moment_dtype=moment_dtype, row_align=row_align)
    _assert_tables_bit_equal(got, want)
    assert got.user_pmv.shape[1] % row_align == 0
    for t_ in (got.user_pmv, got.item_pmv):  # fresh storage, no view of the model
        assert all(t_.untyped_storage().data_ptr() != p.untyped_storage().data_ptr()
                   for p in model.parameters())
    md = moment_dtype if row_align > 1 else None  # padded widths need it
    jp = jpg.unpack_generic_params(want, jm.packed_spec(), md)
    tp = tpg.unpack_generic_params(got, model.packed_spec(), md)
    assert sorted(tp) == sorted(jp) == ["Bi", "Gi", "Gu"]
    for name in tp:
        assert tp[name].is_contiguous()
        _eq_bits(tp[name], jp[name], name)


def test_unpack_width_inference_and_its_errors():
    jm, params, _ = _jax_bprmf()
    model = bprmf_from_jax(_np(params), device="cpu")
    spec, jspec = model.packed_spec(), jm.packed_spec()
    for md in ("float32", "bfloat16", "float8"):  # exact widths infer
        st = tpg.pack_generic_state(model, dict(model.named_parameters()), moment_dtype=md)
        assert tpg.infer_moment_dtype(st, spec) == md
        assert tpg.GenericPackedTrainState(st, spec).moment_dtype == md
    padded = tpg.pack_generic_state(model, dict(model.named_parameters()), row_align=128)
    jpadded = jpg.pack_generic_state(jm, params, row_align=128)
    with pytest.raises(ValueError) as jerr:
        jpg.unpack_generic_params(jpadded, jspec)
    with pytest.raises(ValueError) as perr:
        tpg.unpack_generic_params(padded, spec)
    assert str(perr.value) == str(jerr.value) and "several" in str(perr.value)
    wide = padded._replace(user_pmv=torch.zeros(U, 300))
    with pytest.raises(ValueError, match="does not match any"):
        tpg.unpack_generic_params(wide, spec)
    with pytest.raises(ValueError, match="row_align > 128"):
        tpg.pack_generic_state(model, dict(model.named_parameters()), row_align=256)
    with pytest.raises(ValueError, match="float32/bfloat16/float8"):
        tpg.pack_generic_state(model, dict(model.named_parameters()), moment_dtype="fp16")


# --- the step ------------------------------------------------------------


def _batches(rng, B, n, full_coverage=False, Un=U, In=I):
    for _ in range(n):
        if full_coverage:
            u = np.concatenate([np.arange(Un), rng.integers(0, Un, B - Un)])
            p = np.concatenate([np.arange(In), rng.integers(0, In, B - In)])
        else:
            u, p = rng.integers(0, Un, B), rng.integers(0, In, B)
        yield tuple(np.asarray(a, np.int32) for a in (u, p, rng.integers(0, In, B)))


def _decoded(table, W, md, tau, mid_end):
    """(p, m, v, the scalar groups, the fused frozen columns, tau, pads) of
    a packed table (numpy), decoded by the port."""
    t = torch.from_numpy(np.array(table))
    mw = tpg._mom_width(md, W)
    cols = t[:, W:W + mw]
    if md == "float32":
        m, v = cols[:, :W], cols[:, W:]
    elif md == "bfloat16":
        m, v = tpg._mv_unpack(cols)
    else:
        m, v = tpg._mv_unpack_fp8(cols, W)
    return {"p": t[:, :W].numpy(), "m": m.numpy(), "v": v.numpy(),
            "tau": t[:, tau].numpy(), "pads": t[:, tau + 1:].numpy(),
            "mid": t[:, W + mw:mid_end].numpy(), "frozen": t[:, mid_end:tau].numpy()}


def _assert_packed_close(got, want, spec, md, fused=False):
    Wu, Wi = (sum(w for _, w in tables) for tables in (spec.user_tables, spec.item_tables))
    nS = len(spec.item_scalars)
    tau_u = Wu + tpg._mom_width(md, Wu)
    F0 = Wi + tpg._mom_width(md, Wi) + tpg._scalar_group(md) * nS
    tau_i = F0 + (sum(w for _, w in spec.frozen_item_tables) if fused else 0)
    for name, W, tau, mid_end in (("user_pmv", Wu, tau_u, tau_u), ("item_pmv", Wi, tau_i, F0)):
        a = _decoded(getattr(got, name).numpy(), W, md, tau, mid_end)
        b = _decoded(np.asarray(getattr(want, name)), W, md, tau, mid_end)
        for key in ("p", "m", "v"):
            np.testing.assert_allclose(a[key], b[key], err_msg=f"{name} {key}", **STATE_TOL)
        _eq_bits(a["tau"], b["tau"], f"{name} tau")
        _eq_bits(a["pads"], b["pads"], f"{name} pads")
        _eq_bits(a["frozen"], b["frozen"], f"{name} frozen columns")
        if md == "float32":  # the item scalar groups [p | m | v]
            np.testing.assert_allclose(a["mid"], b["mid"], err_msg=f"{name} scalars",
                                       **STATE_TOL)
        elif nS:  # [p | bf16 pair]: p as floats, the pair decoded
            np.testing.assert_allclose(a["mid"][:, 0::2], b["mid"][:, 0::2], **STATE_TOL)
            for x, y in zip(tpg._mv_unpack(_t(a["mid"][:, 1::2])),
                            tpg._mv_unpack(_t(b["mid"][:, 1::2]))):
                np.testing.assert_allclose(x.numpy(), y.numpy(), **STATE_TOL)
    assert int(got.step) == int(want.step)
    for name, (p, m, v) in got.dense.items():
        for label, x, y in zip("pmv", (p, m, v), want.dense[name]):
            xs, ys = tpg._flat_dense(name, x), flatten_params({name: _np(y)})
            for k in xs:
                np.testing.assert_allclose(xs[k].numpy(), ys[k], err_msg=f"{label} {k}",
                                           **STATE_TOL)


@pytest.mark.parametrize("row_align", [1, 128])
@pytest.mark.parametrize("catchup", [False, True], ids=["plain", "catchup"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "float8"])
def test_bprmf_packed_step_matches_jax(moment_dtype, catchup, row_align):
    jm, params, frozen = _jax_bprmf(seed=2)
    jstate = jpg.pack_generic_state(jm, params, moment_dtype=moment_dtype,
                                    row_align=row_align)
    jstep = jax.jit(jpg.make_generic_packed_step(jm, LR, 0.01, moment_dtype=moment_dtype,
                                                 lazy_catchup=catchup))
    model = bprmf_from_jax(_np(params), device="cpu")
    state = generic_packed_state_from_jax(_np(jstate), model.packed_spec(), device="cpu")
    _assert_tables_bit_equal(state, jstate)
    step = tpg.make_generic_packed_step(model, LR, 0.01, moment_dtype=moment_dtype,
                                        lazy_catchup=catchup)
    for u, p, n in _batches(np.random.default_rng(3), 16, 6):
        jstate, jl = jstep(jstate, (frozen, tuple(map(jnp.asarray, (u, p, n))), None))
        state, tl = step(state, ({}, (_t(u), _t(p), _t(n)), None))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_packed_close(state, jstate, model.packed_spec(), moment_dtype)


UA, IA, KA, HID, FILTERS, IMG = 12, 16, 8, 16, 4, 8


def _jax_af(dropout, U_=UA, I_=IA, key=0):
    rng = np.random.default_rng(7)
    jm = JAF(U_, I_, synthetic_features(I_, 10, seed=1),
             rng.random((I_, IMG, IMG, 1)).astype(np.float32),
             np.eye(5, dtype=np.float32)[rng.integers(0, 5, I_)], embed_k=KA,
             attention_layers=(6, 1), encoder_hidden=HID, conv_filters=FILTERS,
             dropout_rate=0.5 if dropout else 0.0)
    params, frozen = jm.init(jax.random.PRNGKey(key))
    return jm, params, frozen, attentive_fashion_from_jax(jm, _np(params), _np(frozen), "cpu")


def _jax_masks(jm, key, B):
    """JAX's dropout keep-masks of ``packed_loss(rng=key)`` in the port's
    order: positives then negatives, each color, edges, class."""
    keep = 1.0 - jm.dropout_rate
    return [torch.from_numpy(np.array(jax.random.bernoulli(k, keep, (B, w))))
            for r in jax.random.split(key)
            for k, w in zip(jax.random.split(r, 3), (HID, FILTERS, HID))]


@pytest.mark.parametrize("dropout", [False, True], ids=["no-dropout", "jax-masks"])
def test_attentive_fashion_packed_step_matches_jax(dropout):
    jm, params, frozen, model = _jax_af(dropout)
    jstate = jpg.pack_generic_state(jm, params, moment_dtype="float32")
    jstep = jax.jit(jpg.make_generic_packed_step(jm, 0.01, 0.01, lazy_catchup=True))
    state = generic_packed_state_from_jax(_np(jstate), model.packed_spec(), device="cpu")
    assert sorted(state.dense["attention"][0]) == ["W1", "W2", "b1", "b2"]
    step = tpg.make_generic_packed_step(model, 0.01, 0.01, lazy_catchup=True)
    rng = np.random.default_rng(5)
    for s, (u, p, n) in enumerate(_batches(rng, 8, 6, Un=UA, In=IA)):
        key = jax.random.PRNGKey(100 + s)
        jstate, jl = jstep(jstate, (frozen, tuple(map(jnp.asarray, (u, p, n))),
                                    key if dropout else None))
        masks = _jax_masks(jm, key, 8) if dropout else None
        state, tl = step(state, (None, (_t(u), _t(p), _t(n)), masks))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_packed_close(state, jstate, model.packed_spec(), "float32")


def _full_coverage(model, B, steps, seed):
    """Packed step vs the port's generic Trainer when every user and item
    row is touched every step (LazyAdam == dense Adam there)."""
    data = synthetic_interactions(model.num_users, model.num_items, interactions_per_user=8,
                                  seed=0)
    trainer = Trainer(model, data, TrainConfig(batch_size=B, lr=0.02, reg=0.01))
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    packed = tpg.pack_generic_state(model, params)
    step = tpg.make_generic_packed_step(model, 0.02, 0.01)
    dense, frozen = trainer.init_state()
    rng = np.random.default_rng(seed)
    for u, p, n in _batches(rng, B, steps, full_coverage=True, Un=model.num_users,
                            In=model.num_items):
        packed, pl = step(packed, (frozen, (_t(u), _t(p), _t(n)), None))
        dense, dl = trainer.run_steps(dense, frozen, tuple(_t(x)[None] for x in (u, p, n)), 0)
        np.testing.assert_allclose(float(pl), float(dl), rtol=1e-6)
    got = tpg.unpack_generic_params(packed, model.packed_spec())
    assert sorted(got) == sorted(dense.params)
    for name, want in dense.params.items():
        np.testing.assert_allclose(got[name].numpy(), want.detach().numpy(), rtol=2e-5,
                                   atol=1e-5, err_msg=name)


def test_bprmf_packed_equals_generic_under_full_coverage():
    _, params, _ = _jax_bprmf(seed=4)
    _full_coverage(bprmf_from_jax(_np(params), device="cpu"), 48, 4, seed=11)


def test_attentive_fashion_packed_equals_generic_under_full_coverage():
    _full_coverage(_jax_af(False, U_=6, I_=8)[3], 16, 4, seed=13)


# --- ACF: the extra item rows ---------------------------------------------

UX, IX, SX, CX, KX, PX = 20, 24, 3, 5, 6, 6


def _jax_acf(seed=0, U_=UX, I_=IX, blank=3):
    """(JAX ACF, params, frozen, the port's ACF): 4 train positives a user
    under a cap of 6 (two padded slots), user ``blank`` with none."""
    spat = np.random.default_rng(9 + seed).normal(size=(I_, SX, CX)).astype(np.float32)
    kw = dict(embed_k=KX, layers_component=(4, 1), layers_item=(4, 1), max_user_pos=PX)
    jm = JACF(U_, I_, spat, jsynth(U_, I_, interactions_per_user=6, seed=seed), **kw)
    params, frozen = jm.init(jax.random.PRNGKey(seed))
    model = acf_from_jax(_np(params), spat,
                         synthetic_interactions(U_, I_, interactions_per_user=6, seed=seed),
                         max_user_pos=PX, device="cpu")
    if blank is not None:
        for k in ("pos_train", "cnt_train"):
            frozen[k] = frozen[k].at[blank].set(0)
            getattr(model, k)[blank] = 0
    return jm, params, frozen, model


def test_acf_extra_item_ids_are_bit_equal():
    jm, _, frozen, model = _jax_acf()
    rng = np.random.default_rng(1)
    u = np.concatenate([[3], rng.integers(0, UX, 15)]).astype(np.int32)
    p, n = (rng.integers(0, IX, 16).astype(np.int32) for _ in range(2))
    want = np.asarray(jm.packed_extra_item_ids(frozen, tuple(map(jnp.asarray, (u, p, n)))))
    got = model.packed_extra_item_ids(dict(model.named_buffers()), (_t(u), _t(p), _t(n)))
    assert got.dtype == torch.int32 and got.shape == (16, PX)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0] == p[0]).all() and (got[1:, 4:] == _t(p[1:, None])).all()


ACF_CASES = [(md, fused, catchup) for md in ("float32", "bfloat16", "float8")
             for fused in (True, False) for catchup in (True, False)]


@pytest.mark.parametrize("moment_dtype,fused,catchup", ACF_CASES,
                         ids=[f"{m}-{'fused' if f else 'by-id'}-{'catchup' if c else 'plain'}"
                              for m, f, c in ACF_CASES])
def test_acf_packed_step_matches_jax(moment_dtype, fused, catchup):
    row_align = 128 if catchup else 1
    jm, params, frozen, model = _jax_acf(seed=2)
    fr = dict(model.named_buffers())
    jstate = jpg.pack_generic_state(jm, params, frozen=frozen if fused else None,
                                    moment_dtype=moment_dtype, row_align=row_align)
    state = tpg.pack_generic_state(model, dict(model.named_parameters()),
                                   frozen=fr if fused else None, moment_dtype=moment_dtype,
                                   row_align=row_align)
    _assert_tables_bit_equal(state, jstate)
    assert state.item_pmv.shape[1] % row_align == 0
    if fused:  # the maps ride the item rows, bit for bit
        F0 = 2 * KX + tpg._mom_width(moment_dtype, 2 * KX)
        _eq_bits(state.item_pmv[:, F0:F0 + SX * CX], fr["Fspat"].reshape(IX, -1).numpy())
    jstep = jax.jit(jpg.make_generic_packed_step(jm, LR, 0.01, fused_frozen=fused,
                                                 moment_dtype=moment_dtype,
                                                 lazy_catchup=catchup))
    step = tpg.make_generic_packed_step(model, LR, 0.01, fused_frozen=fused,
                                        moment_dtype=moment_dtype, lazy_catchup=catchup)
    rng = np.random.default_rng(3)
    for s_, (u, p, n) in enumerate(_batches(rng, 16, 3, Un=UX, In=IX)):
        u[0] = 3  # the zero-positive user
        jstate, jl = jstep(jstate, (frozen, tuple(map(jnp.asarray, (u, p, n))), None))
        state, tl = step(state, (fr, (_t(u), _t(p), _t(n)), None))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"step {s_}")
    _assert_packed_close(state, jstate, model.packed_spec(), moment_dtype, fused=fused)


def test_acf_fused_frozen_equals_unfused():
    """tests/test_packed_generic.py:429 on the port: the maps read out of
    the extra rows give the bits of the maps read by id."""
    _, _, _, model = _jax_acf(seed=4)
    params, fr = dict(model.named_parameters()), dict(model.named_buffers())
    fused = tpg.pack_generic_state(model, params, frozen=fr)
    plain = tpg.pack_generic_state(model, params)
    f_step, p_step = (tpg.make_generic_packed_step(model, 0.05, 0.01, fused_frozen=f)
                      for f in (True, False))
    for u, p, n in _batches(np.random.default_rng(5), 16, 4, Un=UX, In=IX):
        fused, fl = f_step(fused, (fr, (_t(u), _t(p), _t(n)), None))
        plain, pl = p_step(plain, (fr, (_t(u), _t(p), _t(n)), None))
        assert float(fl) == float(pl)
    F0, fw = plain.item_pmv.shape[1] - 1, SX * CX
    _eq_bits(fused.user_pmv, plain.user_pmv.numpy())
    _eq_bits(fused.item_pmv[:, :F0], plain.item_pmv[:, :F0].numpy())
    _eq_bits(fused.item_pmv[:, F0 + fw:], plain.item_pmv[:, F0:].numpy())
    _eq_bits(fused.item_pmv[:, F0:F0 + fw], fr["Fspat"].reshape(IX, -1).numpy())
    for name in ("comp", "item"):
        for x, y in zip(fused.dense[name], plain.dense[name]):
            for k in x:
                _eq_bits(x[k], y[k].numpy(), f"{name}.{k}")


def test_acf_packed_equals_generic_under_full_coverage():
    """tests/test_packed_generic.py:234 on the port."""
    _full_coverage(_jax_acf(U_=6, I_=8, blank=None)[3], 16, 4, seed=17)


def test_fit_packed_acf():
    """tests/test_packed_generic.py:251 on the port."""
    from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator
    from fashionvisualexpl_tpu_torch.models.acf import ACF

    data = synthetic_interactions(24, 30, interactions_per_user=6, seed=0)
    spat = np.random.default_rng(4).normal(size=(30, 3, 6)).astype(np.float32)
    model = ACF(24, 30, spat, data, embed_k=6, layers_component=(4, 1), layers_item=(4, 1),
                max_user_pos=6, device="cpu")
    cfg = TrainConfig(batch_size=24, epochs=4, lr=0.01, reg=0.001, top_k=5,
                      train_path="packed", eval_every=4)
    state, frozen, results, extra = fit(model, data, cfg,
                                        evaluator=Evaluator(model, data, k=5, user_block=32))
    history = extra["history"]
    assert history[-1].loss < history[0].loss and results
    assert isinstance(state, tpg.GenericPackedTrainState)
    assert state.inner.item_pmv.shape[1] == 3 * 12 + 1 + 18  # Gi|Pi, m, v, tau, Fspat
    with torch.no_grad():
        s = model.score(torch.tensor([0, 1]), torch.tensor([2, 3]), params=state.params)
    assert s.shape == (2,) and torch.isfinite(s).all()


# --- the Trainer, fit and checkpoints ------------------------------------

TRAIN_KW = dict(batch_size=16, lr=0.05, reg=0.001, epochs=2, train_path="packed")


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_trainer_packed_matches_jax_from_carried_init_and_draws(moment_dtype):
    kw = dict(TRAIN_KW, moment_dtype=moment_dtype)
    jdata = jsynth(U, I, interactions_per_user=6, seed=0)
    jm = JBPRMF(U, I, embed_k=K)
    jtrainer = JTrainer(jm, jdata, JTrainConfig(**kw))
    init_rng, epoch_rng = jax.random.split(jax.random.PRNGKey(3))
    jstate, jfrozen = jtrainer.init_state(init_rng)
    model = bprmf_from_jax(_np(jstate.params), device="cpu")
    trainer = Trainer(model, synthetic_interactions(U, I, interactions_per_user=6, seed=0),
                      TrainConfig(**kw))
    state, frozen = trainer.init_state()
    assert isinstance(state, tpg.GenericPackedTrainState)
    _assert_tables_bit_equal(state.inner, jstate.inner)
    for epoch in (1, 2):
        key = jax.random.fold_in(epoch_rng, epoch)
        sample_key, _ = jax.random.split(key)
        triples = jsampler.sample_triplets(
            sample_key, jtrainer._train_pairs, jtrainer._padded_pos, jtrainer._pos_counts,
            I, jtrainer.steps_per_epoch, kw["batch_size"],
            with_replacement=jtrainer.cfg.sampling_scheme)
        state, loss = trainer.run_steps(
            state, frozen, tuple(torch.from_numpy(np.array(t)) for t in triples), step_key=1)
        jstate, jloss = jtrainer.run_epoch(jstate, jfrozen, key)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_packed_close(state.inner, jstate.inner, model.packed_spec(), moment_dtype)
    jparams = _np(jstate.params)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), jparams[name], err_msg=name, **STATE_TOL)
    # the model's own parameters stay as they were: the packed rows are copies
    np.testing.assert_array_equal(model.Gu.detach().numpy(),
                                  np.asarray(jtrainer.init_state(init_rng)[0].params["Gu"]))


def test_epoch_fn_is_the_trainers_epoch():
    data = synthetic_interactions(U, I, interactions_per_user=6, seed=0)
    cfg = TrainConfig(**dict(TRAIN_KW, moment_dtype="float8", row_align=128))
    trainer = Trainer(BPRMF(U, I, embed_k=K, device="cpu"), data, cfg)
    by_trainer, frozen = trainer.init_state(9)
    by_fn, _ = trainer.init_state(9)
    epoch = tpg.make_generic_packed_epoch_fn(
        trainer.model, cfg.lr, cfg.reg, I, trainer.steps_per_epoch, cfg.batch_size,
        with_replacement=cfg.sampling_scheme, moment_dtype="float8", lazy_catchup=True,
        device="cpu")
    by_trainer, l1 = trainer.run_epoch(by_trainer, frozen, 17)
    inner, l2 = epoch(by_fn.inner, frozen, 17, trainer._train_pairs, trainer._padded_pos,
                      trainer._pos_counts)
    assert float(l1) == float(l2)
    _eq_bits(by_trainer.inner.user_pmv, inner.user_pmv.numpy())
    _eq_bits(by_trainer.inner.item_pmv, inner.item_pmv.numpy())


class _Rising:
    """Duck-typed evaluator whose validation metric rises every epoch, so
    the best params are the last epoch's."""

    def __init__(self):
        self.n = 0

    def evaluate(self, params, frozen):
        self.n += 1
        return {"ndcg_v": float(self.n)}

    def print_epoch(self, *a):
        pass


def _packed_fit_setup(model_kind, epochs, moment_dtype="bfloat16", row_align=128):
    data = synthetic_interactions(20, 16, interactions_per_user=6, seed=2)
    if model_kind == "bprmf":
        model = BPRMF(20, 16, embed_k=K, device="cpu")
    else:
        from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion

        rng = np.random.default_rng(3)
        model = AttentiveFashion(20, 16, synthetic_features(16, 10, seed=3),
                                 rng.random((16, IMG, IMG, 1)).astype(np.float32),
                                 np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)],
                                 embed_k=KA, attention_layers=(6, 1), encoder_hidden=HID,
                                 conv_filters=FILTERS, device="cpu")
    cfg = TrainConfig(batch_size=16, epochs=epochs, lr=0.01, reg=0.001, seed=5, verbose=1,
                      train_path="packed", moment_dtype=moment_dtype, row_align=row_align)
    return model, data, cfg


def _state_bits(state):
    flat = {"user_pmv": state.inner.user_pmv, "item_pmv": state.inner.item_pmv,
            "step": state.step}
    for name, (p, m, v) in state.inner.dense.items():
        for label, x in zip("pmv", (p, m, v)):
            flat.update({f"{label}/{k}": t for k, t in tpg._flat_dense(name, x).items()})
    return {k: v.detach().clone() for k, v in flat.items()}


def _assert_same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k].view(torch.int32) if a[k].dtype == torch.float32 else a[k],
                           b[k].view(torch.int32) if b[k].dtype == torch.float32 else b[k]), k


@pytest.mark.parametrize("model_kind", ["bprmf", "attentive_fashion"])
def test_packed_checkpoint_round_trip_and_resume_bit_for_bit(model_kind, tmp_path):
    model, data, cfg = _packed_fit_setup(model_kind, 3)
    logs = []
    full, _, _, extra = fit(model, data, cfg, evaluator=_Rising(), log=logs.append,
                            ckpt_dir=str(tmp_path / "full"))
    assert np.isfinite([r["loss"] for r in logs]).all()
    want = _state_bits(full)

    # round trip: restore the epoch-3 checkpoint into a fresh template
    m2, _, _ = _packed_fit_setup(model_kind, 3)
    template, _ = Trainer(m2, data, cfg).init_state(0)
    restored = CheckpointManager(str(tmp_path / "full")).restore(template)
    assert restored is template and restored.moment_dtype == "bfloat16"
    _assert_same_bits(_state_bits(restored), want)

    # a run cut after epoch 2 and resumed ends where the uninterrupted run ends
    cut, _, cfg2 = _packed_fit_setup(model_kind, 2)
    fit(cut, data, cfg2, ckpt_dir=str(tmp_path / "cut"))
    resumed, _, _ = _packed_fit_setup(model_kind, 3)
    rstate, _, _, rextra = fit(resumed, data, cfg, evaluator=_Rising(),
                               ckpt_dir=str(tmp_path / "cut"), resume=True)
    assert extra["best_epoch"] == rextra["best_epoch"] == 3
    _assert_same_bits(_state_bits(rstate), want)
    for name, p in extra["best_params"].items():
        assert torch.equal(rextra["best_params"][name], p), name
    # the best params are the model's names and restore into the model
    best = CheckpointManager(str(tmp_path / "cut")).restore_best(dict(resumed.named_parameters()))
    assert sorted(best) == sorted(dict(resumed.named_parameters()))

    # a template of another moment layout is refused
    m3, _, cfg3 = _packed_fit_setup(model_kind, 3, moment_dtype="float32", row_align=128)
    other, _ = Trainer(m3, data, cfg3).init_state(0)
    with pytest.raises(ValueError, match="moment_dtype"):
        CheckpointManager(str(tmp_path / "full")).restore(other)


def test_best_params_and_state_params_are_copies():
    model, data, cfg = _packed_fit_setup("bprmf", 2, moment_dtype="float32", row_align=1)
    trainer = Trainer(model, data, cfg)
    state, frozen = trainer.init_state(1)
    before = state.params
    state, _ = trainer.run_epoch(state, frozen, 3)
    after = state.params
    assert not torch.equal(before["Gu"], after["Gu"])  # the copy did not move
    assert torch.equal(model.Gu.detach(), before["Gu"])  # nor did the model


class _NoPacked(RecommenderModel):
    name = "nopacked"

    def __init__(self):
        super().__init__(4, 4)
        self.w = torch.nn.Parameter(torch.zeros(4, 2))


class _WithExtras(BPRMF):
    def __init__(self, extra_items=0, frozen_tables=()):
        super().__init__(6, 8, embed_k=2, device="cpu")
        self._extras = (extra_items, frozen_tables)

    def packed_spec(self):
        return super().packed_spec()._replace(extra_items=self._extras[0],
                                              frozen_item_tables=self._extras[1])


class _WithFrozen(_WithExtras):
    """BPRMF declaring a frozen F [8, 4] whose rows its packed loss reads
    out of ``frozen_vw`` (and records the shapes of)."""

    def __init__(self):
        super().__init__(frozen_tables=(("F", 4),))
        self.seen = []

    def packed_loss(self, user_vw, pos_vw, neg_vw, dense, frozen, ids, reg, rng=None,
                    frozen_vw=None):
        self.seen += [tuple(frozen_vw[side]["F"].shape) for side in ("pos", "neg")]
        return (super().packed_loss(user_vw, pos_vw, neg_vw, dense, frozen, ids, reg, rng)
                + frozen_vw["pos"]["F"].sum() * 0)


class _WithExtraRows(_WithExtras):
    """BPRMF declaring 3 extra item rows a batch element (the three items
    after its positive) whose Gi its packed loss adds to the score."""

    def __init__(self):
        super().__init__(extra_items=3)
        self.seen = []

    def packed_extra_item_ids(self, frozen, ids):
        return ((ids[1][:, None] + torch.arange(1, 4)) % 8).to(torch.int32)

    def packed_loss(self, user_vw, pos_vw, neg_vw, dense, frozen, ids, reg, rng=None,
                    extra_vw=None):
        self.seen.append(tuple(extra_vw["Gi"].shape))
        return (super().packed_loss(user_vw, pos_vw, neg_vw, dense, frozen, ids, reg, rng)
                + (extra_vw["Gi"].sum(1) * user_vw["Gu"]).sum())


def test_unported_branches_raise_naming_their_items():
    data = synthetic_interactions(4, 4, interactions_per_user=2, seed=0)
    with pytest.raises(NotImplementedError, match="does not implement"):
        Trainer(_NoPacked(), data, TrainConfig(batch_size=2, train_path="packed"))
    # a spec with extra_items steps: the extra rows are read, differentiated
    # and written back through the item dedupe (ACF's parity: the ACF tests
    # above)
    extra = _WithExtraRows()
    state = tpg.pack_generic_state(extra, dict(extra.named_parameters()))
    before = state.item_pmv.clone()
    ids = (_t(np.array([0, 5], np.int32)), _t(np.array([1, 7], np.int32)),
           _t(np.array([2, 2], np.int32)))
    state, loss = tpg.make_generic_packed_step(extra, 0.01, 0.0)(state, (None, ids, None))
    assert np.isfinite(float(loss)) and extra.seen == [(2, 3, 2)]
    touched = torch.zeros(8, dtype=torch.bool)
    touched[[0, 1, 2, 3, 4, 7]] = True  # pos, neg and the extra rows 2, 3, 4 / 0, 1, 2
    assert torch.equal(state.item_pmv[:, -1], touched.float())  # tau
    assert not torch.equal(state.item_pmv[3, :2], before[3, :2])  # an extra row only
    assert torch.equal(state.item_pmv[~touched], before[~touched])
    # a model declaring frozen item tables packs them and steps (VBPR's and
    # GradFashion's parity: test_torch_vbpr.py, test_torch_grad_fashion.py)
    frozen_model = _WithFrozen()
    fr = {"F": torch.arange(32.0).reshape(8, 4)}
    state = tpg.pack_generic_state(frozen_model, dict(frozen_model.named_parameters()),
                                   frozen=fr)
    assert state.item_pmv.shape[1] == 2 + 4 + 3 + 4 + 1  # Gi, m, v, Bi group, F, tau
    step = tpg.make_generic_packed_step(frozen_model, 0.01, 0.0, fused_frozen=True)
    ids = (_t(np.array([0, 5], np.int32)), _t(np.array([1, 7], np.int32)),
           _t(np.array([2, 2], np.int32)))
    state, loss = step(state, (fr, ids, None))
    assert np.isfinite(float(loss)) and int(state.step) == 1
    assert frozen_model.seen == [(2, 4)] * 2  # the F rows of pos and neg
    assert torch.equal(state.item_pmv[:, 9:13], fr["F"])  # passed through
    assert torch.equal(state.item_pmv[[1, 2, 7], 13], torch.ones(3))  # tau
    with pytest.raises(ValueError, match="declared width 4"):
        tpg.pack_generic_state(frozen_model, dict(frozen_model.named_parameters()),
                               frozen={"F": torch.zeros(8, 5)})
    # BPRMF declares no frozen tables: fused_frozen=True is a no-op
    tpg.make_generic_packed_step(BPRMF(4, 4, embed_k=2, device="cpu"), 0.01, 0.0,
                                 fused_frozen=True)
    assert isinstance(BPRMF(4, 4, embed_k=2, device="cpu").packed_spec(), PackedSpec)
    with pytest.raises(NotImplementedError, match="ROADMAP: Multi-device"):
        Trainer(BPRMF(4, 4, embed_k=2, device="cpu"), data,
                TrainConfig(batch_size=2, train_path="packed",
                            mesh=TrainConfig().mesh.__class__(data=2)))
