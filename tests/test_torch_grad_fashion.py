"""Port GradFashion (``models/grad_fashion.py``) vs the JAX package, on the
CPU, from JAX's params carried across over the same numpy-seeded color and
edge features; the same checks and tolerances as ``test_torch_vbpr.py``
(whose helpers run them), plus:

- the loss regularizes both biases at full reg (``tests/test_grad_fashion.py``'s
  ``test_loss_no_neg_bias_discount``);
- ``feature_attributions`` and ``feature_attributions_block`` against
  JAX's vmapped ``jax.grad``: rtol 1e-5, atol 1e-6 (JAX's own pin in
  ``tests/test_grad_fashion.py``), and against the analytic attribution of
  the bilinear score."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.data.features import synthetic_features
from fashionvisualexpl_tpu.models.grad_fashion import GradFashion as JGradFashion
from fashionvisualexpl_tpu_torch.models.base import l2_loss
from fashionvisualexpl_tpu_torch.models.convert import grad_fashion_from_jax
from fashionvisualexpl_tpu_torch.models.grad_fashion import GradFashion
from tests.test_torch_vbpr import (
    ENGINES,
    FN_TOL,
    LOSS_TOL,
    MOMENTS,
    assert_grad_close,
    fused_equals_unfused,
    metrics_match_jax,
    np_tree,
    packed_step_matches_jax,
    quarters,
    serving_matches_jax,
    t,
    trainer_matches_jax,
)

U, I, K, D, DC, DE, EC, EE = 200, 300, 16, 4, 24, 32, 6, 5
ATT_TOL = dict(rtol=1e-5, atol=1e-6)


def jax_grad_fashion(seed=0, quantized=False, Un=U, In=I):
    """(JAX model, params, frozen, the port's model from them); Bi drawn
    with numpy (JAX inits it to zeros)."""
    color = synthetic_features(In, DC, seed=seed + 1)
    edges = synthetic_features(In, DE, seed=seed + 2)
    if quantized:
        color, edges = quarters(color), quarters(edges)
    jm = JGradFashion(Un, In, color, edges, embed_k=K, embed_d=D, embed_color=EC,
                      embed_edges=EE)
    params, frozen = jm.init(jax.random.PRNGKey(seed))
    p = np_tree(params)
    p["Bi"] = np.random.default_rng(seed).normal(size=In).astype(np.float32) * 0.1
    if quantized:  # scaled up so that the quarters differ
        p = {name: quarters(v * 4) for name, v in p.items()}
    return jm, {k: jnp.asarray(v) for k, v in p.items()}, frozen, grad_fashion_from_jax(
        p, color, edges, device="cpu")


def test_buffers_params_and_checkpoint_tree():
    jm, params, frozen, model = jax_grad_fashion()
    assert sorted(dict(model.named_parameters())) == sorted(params)
    assert list(dict(model.named_buffers())) == ["Fc", "Fe"]
    assert not {"Fc", "Fe"} & set(model.state_dict())
    for name in ("Fc", "Fe"):
        np.testing.assert_array_equal(getattr(model, name).numpy(), np.asarray(frozen[name]))
    assert model.packed_spec() == model.packed_spec()._replace(
        dense=("E", "Bp", "Ec", "Ee"), frozen_item_tables=(("Fc", DC), ("Fe", DE)))
    with pytest.raises(ValueError, match="edge features rows"):
        GradFashion(4, 5, np.zeros((5, 3), np.float32), np.zeros((6, 3), np.float32),
                    device="cpu")


def test_reset_parameters_draws_glorot_in_jax_order():
    color, edges = synthetic_features(I, DC), synthetic_features(I, DE, seed=1)
    kw = dict(embed_k=K, embed_d=D, embed_color=EC, embed_edges=EE, device="cpu")
    model = GradFashion(U, I, color, edges, generator=torch.Generator().manual_seed(1), **kw)
    assert float(model.Bi.detach().abs().max()) == 0.0
    for name, (fan_in, fan_out) in (("Gu", (U, K)), ("Gi", (I, K)), ("Ec", (DC, EC)),
                                    ("Ee", (DE, EE)), ("Bp", (EC + EE, 1)),
                                    ("E", (EC + EE, D)), ("Tu", (U, D))):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        x = getattr(model, name).detach()
        assert x.shape == (fan_in, fan_out) and float(x.abs().max()) <= lim, name
    again = GradFashion(U, I, color, edges, generator=torch.Generator().manual_seed(1), **kw)
    torch.testing.assert_close(again.Tu, model.Tu, rtol=0, atol=0)


@pytest.mark.parametrize("fn", ["score", "predict_all", "factored_eval",
                                "predict_user_block", "predict_user_block_ctx"])
def test_model_functions_match_jax(fn):
    jm, params, frozen, model = jax_grad_fashion(seed=2)
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


@pytest.mark.parametrize("reg", [0.0, 0.05])
def test_loss_and_grads_match_jax(reg):
    jm, params, frozen, model = jax_grad_fashion(seed=4)
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


def test_loss_no_neg_bias_discount():
    """Both biases at full reg (GradFashion.py:171-181): with Bi = 1 the
    bias terms add reg * (l2(pos) + l2(neg)) * 2 = 4 at reg 1."""
    _, _, _, model = jax_grad_fashion(seed=1)
    with torch.no_grad():
        model.Bi.fill_(1.0)
        users, pos, neg = t([0, 1]).long(), t([2, 3]).long(), t([4, 5]).long()
        l0 = float(model.loss(users, pos, neg, 0.0))
        l1 = float(model.loss(users, pos, neg, 1.0))
        emb = float(2.0 * (l2_loss(model.Gu[users]) + l2_loss(model.Gi[pos])
                           + l2_loss(model.Gi[neg]) + l2_loss(model.Tu[users]))
                    + 2.0 * (l2_loss(model.Ec) + l2_loss(model.Ee) + l2_loss(model.E)
                             + l2_loss(model.Bp)))
    np.testing.assert_allclose((l1 - l0) - emb, 4.0, rtol=1e-4)


@pytest.mark.parametrize("moment_dtype,row_align", MOMENTS)
def test_fused_packed_step_matches_jax(moment_dtype, row_align):
    packed_step_matches_jax(jax_grad_fashion, moment_dtype, row_align, 12, U, I)


def test_fused_frozen_false_equals_true():
    fused_equals_unfused(jax_grad_fashion(seed=13)[3], U, I, seed=14)


@pytest.mark.parametrize("train_path", ["generic", "packed"])
def test_trainer_matches_jax_from_carried_init_and_draws(train_path):
    trainer_matches_jax(jax_grad_fashion, train_path, 60, 80)


@pytest.mark.parametrize("engine", ENGINES, ids=[e[0] for e in ENGINES])
@pytest.mark.parametrize("quantized", [True, False], ids=["quantized", "gaussian"])
def test_metrics_match_jax(engine, quantized):
    metrics_match_jax(jax_grad_fashion, engine, quantized, 40, 60)


def test_recserver_ids_equal_jax():
    serving_matches_jax(jax_grad_fashion, 50, 120)


# --- attributions ----------------------------------------------------------


def test_feature_attributions_match_jax():
    jm, params, frozen, model = jax_grad_fashion(seed=6)
    rng = np.random.default_rng(7)
    for u in (0, 3, 199):
        items = rng.integers(0, I, 9).astype(np.int32)
        got = model.feature_attributions(u, t(items))
        want = jm.feature_attributions(params, frozen, u, jnp.asarray(items))
        assert got.shape == (9, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("B,W", [(1, 1), (8, 4), (16, 32)])
def test_feature_attributions_block_matches_jax(B, W):
    jm, params, frozen, model = jax_grad_fashion(seed=8)
    rng = np.random.default_rng(B * W)
    users = rng.integers(0, U, B).astype(np.int32)
    items = rng.integers(0, I, (B, W)).astype(np.int32)
    got = model.feature_attributions_block(t(users), t(items))
    want = jm.feature_attributions_block(params, frozen, jnp.asarray(users), jnp.asarray(items))
    assert got.shape == (B, W, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)
    # a params mapping takes the place of the model's own
    doubled = {k: v.detach() * 2 for k, v in model.named_parameters()}
    jdoubled = {k: v * 2 for k, v in params.items()}
    np.testing.assert_allclose(
        model.feature_attributions_block(t(users), t(items), params=doubled).numpy(),
        np.asarray(jm.feature_attributions_block(jdoubled, frozen, jnp.asarray(users),
                                                 jnp.asarray(items))), **ATT_TOL)


def test_attributions_are_each_familys_score_contribution():
    """tests/test_grad_fashion.py's analytic check: for this bilinear score
    grad-x-input per family is the family's additive score term."""
    _, _, _, model = jax_grad_fashion(seed=9)
    p = {k: v.detach().numpy() for k, v in model.named_parameters()}
    u, items = 3, np.array([0, 5, 9])
    att = model.feature_attributions(u, t(items)).numpy()
    for j, it in enumerate(items):
        pc = model.Fc[it].numpy() @ p["Ec"]
        pe = model.Fe[it].numpy() @ p["Ee"]
        color = p["Tu"][u] @ (pc @ p["E"][:EC]) + pc @ p["Bp"][:EC, 0]
        edges = p["Tu"][u] @ (pe @ p["E"][EC:]) + pe @ p["Bp"][EC:, 0]
        np.testing.assert_allclose(att[j], [color, edges], rtol=1e-4, atol=1e-6)
