"""Port VBPR (``models/vbpr.py``, ``train/fast.py::make_fast_vbpr_step``,
the fused frozen columns of ``train/packed_generic.py``, VBPR through the
``Trainer``, both evaluators and ``RecServer``) vs the JAX package, on the
CPU, from JAX's params carried across (``models/convert.py``) over the same
numpy-seeded features.

- model functions (``score``, ``predict_all``, ``factored_eval``,
  ``predict_user_block`` with and without the precomputed ctx): rtol 1e-6,
  atol 5e-7 (four f32 ulps at 1, the summands' scale: the projections sum
  dim_f products and the dots K in another order than XLA's, and differ
  by up to 2 ulps of 1; BPRMF's K-term dots alone hold atol 1e-7); the loss rtol 1e-5, atol 1e-7 and its gradients against
  ``jax.grad`` rtol 1e-4 (atol 1e-7); zero visual weights reduce to BPRMF
  (``tests/test_vbpr.py``);
- the fast step over 6 steps, lazy and not: loss rtol 1e-5 a step, state
  rtol 2e-4, atol 1e-6 (``tests/test_torch_fast.py``'s);
- the packed step with fused frozen columns, against JAX's
  ``make_generic_packed_step(fused_frozen=True)``: packing bit-equal as
  uint32 (frozen columns, pads and tau included) for fp32, bf16 and e5m2
  moments with and without ``row_align``; states after 6 steps rtol 2e-4,
  atol 1e-6, frozen columns, tau and pads bit-equal, at lr 0.01 (as
  ``test_torch_packed.py``'s AttentiveFashion step): at lr 0.05 with bf16
  moments one GradFashion user param whose gradient nearly cancels takes
  an Adam step 1e-4 apart (the two libraries' gradients differ in the
  last ulps, and m / sqrt(v) amplifies that where v is tiny), and E's
  moments follow it past rtol 2e-4; ``fused_frozen=False``
  bit-equal to ``True``;
- ``Trainer`` (generic and packed) from JAX's init fed JAX's draws: losses
  rtol 1e-5, params rtol 2e-4, atol 1e-6;
- evaluation (dense, mask, bucketed, kernel engines): per-user metrics
  equal on quantized data (ndcg rtol 1e-6), means rtol 1e-6; Gaussian
  data rtol 2e-3, atol 2e-4; serving: ``RecServer`` ids equal on tie-free
  data, values rtol 1e-5, atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.features import synthetic_features
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.eval.evaluator import Evaluator as JEvaluator
from fashionvisualexpl_tpu.eval.factored import FactoredEvaluator as JFactored
from fashionvisualexpl_tpu.models.vbpr import VBPR as JVBPR
from fashionvisualexpl_tpu.serve import RecServer as JRecServer
from fashionvisualexpl_tpu.train import fast as jfast
from fashionvisualexpl_tpu.train import packed_generic as jpg
from fashionvisualexpl_tpu.train.trainer import Trainer as JTrainer
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator
from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.models.convert import (
    fast_state_from_jax,
    generic_packed_state_from_jax,
    vbpr_from_jax,
)
from fashionvisualexpl_tpu_torch.models.vbpr import VBPR
from fashionvisualexpl_tpu_torch.serve import RecServer
from fashionvisualexpl_tpu_torch.train import fast as tfast
from fashionvisualexpl_tpu_torch.train import packed_generic as tpg
from fashionvisualexpl_tpu_torch.train.trainer import Trainer

FN_TOL = dict(rtol=1e-6, atol=5e-7)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
STATE_TOL = dict(rtol=2e-4, atol=1e-6)
GOLDEN = dict(rtol=2e-3, atol=2e-4)
U, I, K, D, DIM_F = 200, 300, 16, 4, 32
ROW_TABLES = ("Gu", "Tu", "Gi", "Bi")
PACKED_LR = 0.01


def np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def t(x):
    return torch.from_numpy(np.array(x))


def bits(x):
    x = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint32)


def assert_bits(got, want, msg=""):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=msg)


def assert_grad_close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_FLOOR * float(np.abs(want).max()), err_msg=name)


def quarters(x):
    """Onto the 1/4 grid: with few terms every score is exact in f32."""
    return (np.round(np.asarray(x) * 4) / 4).astype(np.float32)


def jax_vbpr(seed=0, quantized=False, Un=U, In=I, k=K, d=D, dim_f=DIM_F):
    """(JAX model, params, frozen, the port's model from them); Bi drawn
    with numpy (JAX inits it to zeros)."""
    feats = synthetic_features(In, dim_f, seed=seed + 1)
    if quantized:
        feats = quarters(feats)
    jm = JVBPR(Un, In, feats, embed_k=k, embed_d=d)
    params, frozen = jm.init(jax.random.PRNGKey(seed))
    p = np_tree(params)
    p["Bi"] = np.random.default_rng(seed).normal(size=In).astype(np.float32) * 0.1
    if quantized:  # scaled up so that the quarters differ
        p = {name: quarters(v * 4) for name, v in p.items()}
    return jm, {k_: jnp.asarray(v) for k_, v in p.items()}, frozen, vbpr_from_jax(
        p, feats, device="cpu")


# --- model functions -------------------------------------------------------


def test_buffers_params_and_checkpoint_tree():
    _, params, frozen, model = jax_vbpr()
    assert sorted(dict(model.named_parameters())) == sorted(params)
    assert list(dict(model.named_buffers())) == ["F"]
    assert "F" not in model.state_dict()  # checkpoints carry the params only
    np.testing.assert_array_equal(model.F.numpy(), np.asarray(frozen["F"]))
    assert model.packed_spec().frozen_item_tables == (("F", DIM_F),)
    with pytest.raises(ValueError, match="features rows"):
        VBPR(4, 5, np.zeros((6, 3), np.float32), device="cpu")


def test_reset_parameters_draws_glorot_in_jax_order():
    model = VBPR(U, I, synthetic_features(I, DIM_F), embed_k=K, embed_d=D, device="cpu",
                 generator=torch.Generator().manual_seed(1))
    assert float(model.Bi.detach().abs().max()) == 0.0
    for name, (fan_in, fan_out) in (("Gu", (U, K)), ("Gi", (I, K)), ("Tu", (U, D)),
                                    ("E", (DIM_F, D)), ("Bp", (DIM_F, 1))):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        x = getattr(model, name).detach()
        assert float(x.abs().max()) <= lim and float(x.std()) > lim / 4, name
    again = VBPR(U, I, synthetic_features(I, DIM_F), embed_k=K, embed_d=D, device="cpu",
                 generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(again.E, model.E, rtol=0, atol=0)


@pytest.mark.parametrize("fn", ["score", "predict_all", "factored_eval",
                                "predict_user_block", "predict_user_block_ctx"])
def test_model_functions_match_jax(fn):
    jm, params, frozen, model = jax_vbpr(seed=2)
    users = np.array([0, 7, 199, 55, 7], np.int32)
    items = np.array([3, 299, 0, 150, 3], np.int32)
    with torch.no_grad():
        if fn == "score":
            got = [model.score(t(users).long(), t(items).long())]
            want = [jm.score(params, frozen, jnp.asarray(users), jnp.asarray(items))]
        elif fn == "predict_all":
            got, want = [model.predict_all()], [jm.predict_all(params, frozen)]
        elif fn == "factored_eval":
            got = model.factored_eval()
            want = jm.factored_eval(params, frozen)
            assert got[0].shape == (U, K + D) and got[1].shape == (I, K + D)
        else:
            ctx = model.precompute_eval() if fn.endswith("ctx") else None
            jctx = jm.precompute_eval(params, frozen) if fn.endswith("ctx") else None
            got = [model.predict_user_block(t(users).long(), ctx)]
            want = [jm.predict_user_block(params, frozen, jnp.asarray(users), jctx)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FN_TOL)


def test_params_mapping_replaces_the_models_own():
    _, params, frozen, model = jax_vbpr(seed=3)
    other = {k: v.detach() * 2 for k, v in model.named_parameters()}
    twice = vbpr_from_jax({k: v.numpy() for k, v in other.items()}, model.F.numpy(),
                          device="cpu")
    with torch.no_grad():
        for a, b in zip(model.factored_eval(other), twice.factored_eval()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        ids = torch.arange(9)
        torch.testing.assert_close(model.predict_user_block(ids, params=other),
                                   twice.predict_user_block(ids), rtol=0, atol=0)


@pytest.mark.parametrize("reg", [0.0, 0.05])
def test_loss_and_grads_match_jax(reg):
    jm, params, frozen, model = jax_vbpr(seed=4)
    rng = np.random.default_rng(5)
    u, p, n = (rng.integers(0, hi, 64).astype(np.int32) for hi in (U, I, I))
    jl, jg = jax.value_and_grad(lambda pr: jm.loss(pr, frozen, jnp.asarray(u), jnp.asarray(p),
                                                   jnp.asarray(n), reg))(params)
    names = [k for k, _ in model.named_parameters()]
    loss = model.loss(t(u).long(), t(p).long(), t(n).long(), reg)
    grads = torch.autograd.grad(loss, [getattr(model, k) for k in names])
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOSS_TOL)
    for name, g in zip(names, grads):
        assert_grad_close(g, jg[name], name)


def test_zero_visual_weights_reduce_to_bprmf():
    """tests/test_vbpr.py's integration criterion: with Tu, E, Bp at zero
    VBPR scores and trains as BPRMF."""
    _, _, _, model = jax_vbpr(seed=6)
    with torch.no_grad():
        for name in ("Tu", "E", "Bp"):
            getattr(model, name).zero_()
    bpr = BPRMF(U, I, embed_k=K, device="cpu")
    with torch.no_grad():
        for name in ("Gu", "Gi", "Bi"):
            getattr(bpr, name).copy_(getattr(model, name))
        torch.testing.assert_close(model.predict_all(), bpr.predict_all(), rtol=1e-6,
                                   atol=1e-7)
    rng = np.random.default_rng(7)
    u, p, n = (t(rng.integers(0, hi, 32)).long() for hi in (U, I, I))
    torch.testing.assert_close(model.loss(u, p, n, 0.01), bpr.loss(u, p, n, 0.01),
                               rtol=1e-6, atol=1e-7)


# --- the fast step ---------------------------------------------------------


def batches(rng, B, n, Un=U, In=I):
    return [tuple(rng.integers(0, hi, B).astype(np.int32) for hi in (Un, In, In))
            for _ in range(n)]


@pytest.mark.parametrize("lazy", [False, True], ids=["sparse", "lazy"])
def test_fast_step_matches_jax(lazy):
    jm, params, frozen, model = jax_vbpr(seed=8)
    lr, reg = 0.01, 0.02
    jstate = (jfast.init_lazy_state(params, ROW_TABLES) if lazy
              else jfast.init_fast_state(params))
    jstep = jax.jit(jfast.make_fast_vbpr_step(jm, lr, reg, lazy=lazy))
    tstate = fast_state_from_jax(jstate.step, np_tree(jstate.params), np_tree(jstate.mu),
                                 np_tree(jstate.nu),
                                 tau=np_tree(jstate.tau) if lazy else None, device="cpu")
    tstep = tfast.make_fast_vbpr_step(model, lr, reg, lazy=lazy)
    for u, p, n in batches(np.random.default_rng(9), 32, 6):
        jstate, jl = jstep(jstate, (frozen["F"], tuple(map(jnp.asarray, (u, p, n)))))
        tstate, tl = tstep(tstate, (model.F, (t(u), t(p), t(n))))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert int(tstate.step) == int(jstate.step) == 6
    for name in jstate.params:
        for field in ("params", "mu", "nu"):
            np.testing.assert_allclose(getattr(tstate, field)[name].numpy(),
                                       np.asarray(getattr(jstate, field)[name]),
                                       err_msg=f"{field}[{name}]", **STATE_TOL)
        if lazy and name in ROW_TABLES:
            np.testing.assert_array_equal(tstate.tau[name].numpy(),
                                          np.asarray(jstate.tau[name]))


def test_fast_epoch_fn_is_the_sampler_then_the_steps():
    data = synthetic_interactions(U, I, interactions_per_user=6, seed=0)
    tabs = [torch.as_tensor(np.asarray(a, np.int32))
            for a in (data.train_pairs, data.padded_pos, data.pos_counts)]
    _, _, _, model = jax_vbpr(seed=10)
    params = {k: v.detach() for k, v in model.named_parameters()}
    by_epoch = tfast.init_lazy_state({k: v.clone() for k, v in params.items()}, ROW_TABLES)
    by_steps = tfast.init_lazy_state({k: v.clone() for k, v in params.items()}, ROW_TABLES)
    epoch = tfast.make_fast_vbpr_epoch_fn(model, 0.01, 0.01, I, 4, 16, lazy=True,
                                          device="cpu")
    step = tfast.make_fast_vbpr_step(model, 0.01, 0.01, lazy=True)
    by_epoch, total = epoch(by_epoch, model.F, 11, *tabs)
    triples = sample_triplets(11, *tabs, I, 4, 16, device="cpu")
    losses = []
    for s in range(4):
        by_steps, loss = step(by_steps, (model.F, tuple(x[s] for x in triples)))
        losses.append(loss)
    assert int(by_epoch.step) == 4
    torch.testing.assert_close(total, torch.stack(losses).sum(), rtol=0, atol=0)
    for name in params:
        torch.testing.assert_close(by_epoch.params[name], by_steps.params[name], rtol=0,
                                   atol=0)


# --- the packed step with fused frozen columns -----------------------------


def decoded_item_rows(table, spec, md, fused):
    """{p, m, v, scalars, frozen, tau, pads} of packed item rows (numpy)."""
    x = t(table)
    (_, W), = spec.item_tables
    mw = tpg._mom_width(md, W)
    F0 = W + mw + tpg._scalar_group(md) * len(spec.item_scalars)
    tau = F0 + (sum(w for _, w in spec.frozen_item_tables) if fused else 0)
    m, v = decode(x[:, W:W + mw], W, md)
    return {"p": x[:, :W].numpy(), "m": m, "v": v, "scalars": x[:, W + mw:F0].numpy(),
            "frozen": x[:, F0:tau].numpy(), "tau": x[:, tau].numpy(),
            "pads": x[:, tau + 1:].numpy()}


def decode(cols, W, md):
    if md == "float32":
        return cols[:, :W].numpy(), cols[:, W:].numpy()
    m, v = tpg._mv_unpack(cols) if md == "bfloat16" else tpg._mv_unpack_fp8(cols, W)
    return m.numpy(), v.numpy()


def assert_packed_close(got, want, spec, md, fused=True):
    """Params and decoded moments within STATE_TOL, frozen columns, tau and
    pads bit-equal, dense (p, m, v) within STATE_TOL."""
    a = decoded_item_rows(got.item_pmv.numpy(), spec, md, fused)
    b = decoded_item_rows(np.asarray(want.item_pmv), spec, md, fused)
    for key in ("p", "m", "v"):
        np.testing.assert_allclose(a[key], b[key], err_msg=f"item {key}", **STATE_TOL)
    for key in ("frozen", "tau", "pads"):
        assert_bits(a[key], b[key], f"item {key}")
    sa, sb = a["scalars"], b["scalars"]
    if md == "float32":
        np.testing.assert_allclose(sa, sb, **STATE_TOL)
    else:  # [p | bf16 pair]
        np.testing.assert_allclose(sa[:, 0::2], sb[:, 0::2], **STATE_TOL)
        for x, y in zip(tpg._mv_unpack(t(sa[:, 1::2])), tpg._mv_unpack(t(sb[:, 1::2]))):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **STATE_TOL)
    Wu = sum(w for _, w in spec.user_tables)
    mw = tpg._mom_width(md, Wu)
    gu, wu = got.user_pmv, t(want.user_pmv)
    np.testing.assert_allclose(gu[:, :Wu].numpy(), wu[:, :Wu].numpy(), **STATE_TOL)
    for x, y in zip(decode(gu[:, Wu:Wu + mw], Wu, md), decode(wu[:, Wu:Wu + mw], Wu, md)):
        np.testing.assert_allclose(x, y, **STATE_TOL)
    assert_bits(gu[:, Wu + mw:], wu[:, Wu + mw:], "user tau and pads")
    assert int(got.step) == int(want.step)
    for name, (p, m, v) in got.dense.items():
        for label, x, y in zip("pmv", (p, m, v), want.dense[name]):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), err_msg=f"{label} {name}",
                                       **STATE_TOL)


def packed_setup(jax_model_fn, moment_dtype, row_align, seed):
    """JAX's state packed with its frozen pytree, the port's packed from
    the carried model's buffers: bit-equal as uint32."""
    jm, params, frozen, model = jax_model_fn(seed=seed)
    jstate = jpg.pack_generic_state(jm, params, frozen=frozen, moment_dtype=moment_dtype,
                                    row_align=row_align)
    state = tpg.pack_generic_state(model, dict(model.named_parameters()),
                                   frozen=dict(model.named_buffers()),
                                   moment_dtype=moment_dtype, row_align=row_align)
    assert_bits(state.user_pmv, jstate.user_pmv, "user_pmv")
    assert_bits(state.item_pmv, jstate.item_pmv, "item_pmv")
    assert state.item_pmv.shape[1] % row_align == 0
    return jm, params, frozen, model, jstate, state


MOMENTS = [("float32", 1), ("float32", 128), ("bfloat16", 1), ("bfloat16", 128),
           ("float8", 1), ("float8", 128)]


def packed_step_matches_jax(jax_model_fn, moment_dtype, row_align, seed, Un, In, B=32):
    jm, params, frozen, model, jstate, state = packed_setup(jax_model_fn, moment_dtype,
                                                            row_align, seed)
    spec = model.packed_spec()
    md = moment_dtype if row_align > 1 else None
    jp = np_tree(jpg.unpack_generic_params(jstate, jm.packed_spec(), md))
    tp = tpg.unpack_generic_params(state, spec, md)  # the frozen columns dropped
    assert sorted(tp) == sorted(jp) == sorted(dict(model.named_parameters()))
    for name in tp:
        assert_bits(tp[name], jp[name], name)
    state = generic_packed_state_from_jax(jax.tree.map(np.asarray, jstate), spec,
                                          device="cpu")
    jstep = jax.jit(jpg.make_generic_packed_step(jm, PACKED_LR, 0.01, fused_frozen=True,
                                                 moment_dtype=moment_dtype,
                                                 lazy_catchup=True))
    step = tpg.make_generic_packed_step(model, PACKED_LR, 0.01, fused_frozen=True,
                                        moment_dtype=moment_dtype, lazy_catchup=True)
    fr = dict(model.named_buffers())
    for u, p, n in batches(np.random.default_rng(seed + 1), B, 6, Un, In):
        jstate, jl = jstep(jstate, (frozen, tuple(map(jnp.asarray, (u, p, n))), None))
        state, tl = step(state, (fr, (t(u), t(p), t(n)), None))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_packed_close(state, jstate, spec, moment_dtype)


@pytest.mark.parametrize("moment_dtype,row_align", MOMENTS)
def test_fused_packed_step_matches_jax(moment_dtype, row_align):
    packed_step_matches_jax(jax_vbpr, moment_dtype, row_align, 12, U, I)


def fused_equals_unfused(model, Un, In, seed):
    """The packed step reading the frozen rows out of the item rows gives
    the bits of the step reading them by id."""
    params = dict(model.named_parameters())
    fr = dict(model.named_buffers())
    fused = tpg.pack_generic_state(model, params, frozen=fr)
    plain = tpg.pack_generic_state(model, params)
    f_step = tpg.make_generic_packed_step(model, 0.05, 0.01, fused_frozen=True)
    p_step = tpg.make_generic_packed_step(model, 0.05, 0.01, fused_frozen=False)
    for u, p, n in batches(np.random.default_rng(seed), 32, 4, Un, In):
        fused, fl = f_step(fused, (fr, (t(u), t(p), t(n)), None))
        plain, pl = p_step(plain, (fr, (t(u), t(p), t(n)), None))
        assert float(fl) == float(pl)
    assert_bits(fused.user_pmv, plain.user_pmv)
    fw = sum(w for _, w in model.packed_spec().frozen_item_tables)
    F0 = plain.item_pmv.shape[1] - 1
    assert_bits(fused.item_pmv[:, :F0], plain.item_pmv[:, :F0])
    assert_bits(fused.item_pmv[:, F0 + fw:], plain.item_pmv[:, F0:])
    for name, frozen_t in fr.items():  # the frozen columns pass through
        off = sum(w for n_, w in model.packed_spec().frozen_item_tables[
            :[n_ for n_, _ in model.packed_spec().frozen_item_tables].index(name)])
        assert_bits(fused.item_pmv[:, F0 + off:F0 + off + frozen_t.shape[1]], frozen_t)
    a = tpg.unpack_generic_params(fused, model.packed_spec())
    b = tpg.unpack_generic_params(plain, model.packed_spec())
    for name in a:
        assert_bits(a[name], b[name], name)


def test_fused_frozen_false_equals_true():
    fused_equals_unfused(jax_vbpr(seed=13)[3], U, I, seed=14)


# --- Trainer, evaluation, serving -------------------------------------------


def trainer_matches_jax(jax_model_fn, train_path, Un, In, seed=3):
    kw = dict(batch_size=32, lr=0.01, reg=0.01, epochs=2, train_path=train_path)
    jdata = jsynth(Un, In, interactions_per_user=6, seed=0)
    jm, _, _, port = jax_model_fn(seed=seed, Un=Un, In=In)
    jtrainer = JTrainer(jm, jdata, JTrainConfig(**kw))
    init_rng, epoch_rng = jax.random.split(jax.random.PRNGKey(seed))
    jstate, jfrozen = jtrainer.init_state(init_rng)
    with torch.no_grad():  # JAX's init, carried across
        for name, p in port.named_parameters():
            p.copy_(t(jstate.params[name]))
    trainer = Trainer(port, synthetic_interactions(Un, In, interactions_per_user=6, seed=0),
                      TrainConfig(**kw))
    state, frozen = trainer.init_state()
    if train_path == "packed":
        assert_bits(state.inner.item_pmv, jstate.inner.item_pmv, "packed with frozen")
    for epoch in (1, 2):
        key = jax.random.fold_in(epoch_rng, epoch)
        sample_key, _ = jax.random.split(key)
        triples = jsampler.sample_triplets(
            sample_key, jtrainer._train_pairs, jtrainer._padded_pos, jtrainer._pos_counts,
            In, jtrainer.steps_per_epoch, kw["batch_size"],
            with_replacement=jtrainer.cfg.sampling_scheme)
        state, loss = trainer.run_steps(state, frozen, tuple(t(x) for x in triples),
                                        step_key=epoch)
        jstate, jloss = jtrainer.run_epoch(jstate, jfrozen, key)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jparams = np_tree(jstate.params)
    assert sorted(state.params) == sorted(jparams)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jparams[name], err_msg=name,
                                   **STATE_TOL)


@pytest.mark.parametrize("train_path", ["generic", "packed"])
def test_trainer_matches_jax_from_carried_init_and_draws(train_path):
    trainer_matches_jax(jax_vbpr, train_path, 60, 80)


ENGINES = [("dense", None), ("mask", "mask"), ("bucketed", "bucketed"),
           ("kernel", "pallas")]


def evaluators(engine, jm, model, jdata, data, k=10):
    kind, jkind = engine
    if kind == "dense":
        return (Evaluator(model, data, k=k, user_block=16),
                JEvaluator(jm, jdata, k=k, user_block=16))
    return (FactoredEvaluator(model, data, k=k, user_block=16, item_block=16,
                              counts_impl=kind),
            JFactored(jm, jdata, k=k, user_block=16, item_block=16, counts_impl=jkind))


def metrics_match_jax(jax_model_fn, engine, quantized, Un, In):
    jdata = jsynth(Un, In, interactions_per_user=9, seed=7)
    data = synthetic_interactions(Un, In, interactions_per_user=9, seed=7)
    jm, params, frozen, model = jax_model_fn(seed=4, quantized=quantized, Un=Un, In=In)
    ev, jev = evaluators(engine, jm, model, jdata, data)
    got = ev.evaluate(None, None)
    want = jev.evaluate(params, frozen)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **(dict(rtol=1e-6, atol=0) if quantized else GOLDEN))
    if not quantized or engine[0] == "dense":
        return
    uf, iv, ib = model.factored_eval()
    juf, jiv, jib = jm.factored_eval(params, frozen)
    idx = np.arange(16) + 16
    for split in ("val", "test"):
        pm = ev._eval_block(split, uf.detach()[idx], iv.detach(), ib.detach(), t(idx))
        jm_ = jev._block_fn(split, juf[idx], jiv, jib, jnp.asarray(idx))
        for f in ("hr", "prec", "rec", "auc", "valid"):
            np.testing.assert_array_equal(getattr(pm, f).numpy(), np.asarray(getattr(jm_, f)))
        np.testing.assert_allclose(pm.ndcg.numpy(), np.asarray(jm_.ndcg), rtol=1e-6, atol=0)


@pytest.mark.parametrize("engine", ENGINES, ids=[e[0] for e in ENGINES])
@pytest.mark.parametrize("quantized", [True, False], ids=["quantized", "gaussian"])
def test_metrics_match_jax(engine, quantized):
    metrics_match_jax(jax_vbpr, engine, quantized, 40, 60)


def serving_matches_jax(jax_model_fn, Un, In):
    jdata = jsynth(Un, In, interactions_per_user=6, seed=1)
    data = synthetic_interactions(Un, In, interactions_per_user=6, seed=1)
    jm, params, frozen, model = jax_model_fn(seed=5, Un=Un, In=In)
    srv = RecServer(model, data, k=10, device="cpu")
    srv.refresh()
    jsrv = JRecServer(jm, jdata, k=10, segmax_kernel="interpret")
    jsrv.refresh(params, frozen)
    users = np.arange(Un, dtype=np.int32)
    ids, vals = srv.query(users)
    jids, jvals = jsrv.query(users)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(vals, np.asarray(jvals), rtol=1e-5, atol=1e-6)
    # the served ids are the dense scores' top 10 with the history masked
    with torch.no_grad():
        scores = model.predict_all().numpy()
    for u, row in enumerate(data.training_list):
        scores[u, list(row)] = -np.inf
    np.testing.assert_array_equal(ids, np.argsort(-scores, axis=1, kind="stable")[:, :10])


def test_recserver_ids_equal_jax():
    serving_matches_jax(jax_vbpr, 50, 120)
