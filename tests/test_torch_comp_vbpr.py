"""Port CompVBPR (``models/comp_vbpr.py``) vs the JAX package, on the CPU,
from JAX's params carried across (``models/convert.py::comp_vbpr_from_jax``)
over the same numpy-seeded features and edge images (19x19: the CNN's odd
pool shapes).

- the eight checks of ``tests/test_comp_vbpr.py`` (the reference formula,
  factored eval, eval encode blocking, all families off is BPRMF, one
  family's delta, the frozen families' loss oracle, the CNN's weights
  regularized and its biases not, training lowers the loss);
- ``score``, ``predict_all``, ``factored_eval`` (D = K + 4 d),
  ``predict_user_block`` with and without the precomputed ctx: rtol 1e-5,
  atol 1e-6; the loss rtol 1e-5 and its gradients against ``jax.grad``
  rtol 1e-4 (atol 1e-5 of each gradient's largest entry), with JAX's own
  dropout masks fed in and without dropout; ``packed_loss`` over the
  gathered rows against JAX's;
- every ablation pattern of ``tests/test_cli.py`` (all four families at
  weights 0.4 / 0.2 / 0.2 / 0.2, and semantic + texture) and single
  families: predict_all and the loss against JAX;
- the packed step against JAX's (fp32 moments, and fp8 with ``row_align``
  128): packing bit-equal, states after 3 steps rtol 2e-4, atol 1e-6
  (``tests/test_torch_vbpr.py``'s checks), tau and pads bit-equal; the
  ``cnn`` group member by member within the same tolerance but for at
  most a 1% share of each tensor, each within 2 lr a step
  (``assert_cnn_close`` says why);
- the generic and packed ``Trainer`` from JAX's init fed JAX's sampler
  draws (dropout off on both sides): losses rtol 1e-5, params rtol 2e-4,
  atol 1e-6, the CNN's as in the packed step;
- both evaluators (the dense one through ``precompute_eval`` /
  ``predict_user_block``, the factored one's kernel engine at D = K + 4 d,
  whose plain version runs here) against
  JAX's: quantized data with the edges off (the CNN's codes lie on no
  grid) equal per user, Gaussian data with every family rtol 2e-3, atol
  2e-4; ``RecServer`` ids equal to JAX's on tie-free data;
- checkpoints round-trip the nested CNN, generic and packed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.features import synthetic_features
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.models.comp_vbpr import CompVBPR as JCompVBPR
from fashionvisualexpl_tpu.train import packed_generic as jpg
from fashionvisualexpl_tpu.train.trainer import Trainer as JTrainer
from fashionvisualexpl_tpu_torch.core.checkpoint import CheckpointManager
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.base import l2_loss
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.models.comp_vbpr import CompVBPR
from fashionvisualexpl_tpu_torch.models.convert import (
    comp_vbpr_from_jax,
    flatten_params,
    generic_packed_state_from_jax,
)
from fashionvisualexpl_tpu_torch.train import packed_generic as tpg
from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fit
from tests.test_torch_vbpr import (
    ENGINES,
    STATE_TOL,
    assert_bits,
    assert_packed_close,
    metrics_match_jax,
    quarters,
    serving_matches_jax,
    t,
)

TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-5
U, I, K, D = 40, 50, 8, 3
DIM_S, DIM_C, DIM_T = 6, 5, 4
HW = (19, 19)
ALL = (True, True, True, True)
PACKED_LR = 0.01


def families(In=I, seed=0, quantized=False):
    """(semantic, color, edges, texture) made with numpy."""
    sem, col, tex = (synthetic_features(In, dim, seed=seed + j)
                     for j, dim in enumerate((DIM_S, DIM_C, DIM_T)))
    edges = np.random.default_rng(seed + 3).uniform(size=(In, *HW, 1)).astype(np.float32)
    if quantized:
        sem, col, tex = quarters(sem), quarters(col), quarters(tex)
    return sem, col, edges, tex


def jax_comp(seed=0, quantized=False, Un=U, In=I, act=ALL,
             weights=(0.25, 0.25, 0.25, 0.25)):
    """(JAX model, params, frozen, the port's model from them); Bi drawn
    with numpy (JAX inits it to zeros); quantized: features and params
    (the edges must be off) on the 1/4 grid."""
    feats = families(In, seed, quantized)
    given = [f if a else None for f, a in zip(feats, act)]
    jm = JCompVBPR(Un, In, *given, embed_k=K, embed_d=D, weight_components=weights)
    params, frozen = jm.init(jax.random.PRNGKey(seed))
    p = flatten_params(jax.tree.map(np.asarray, params))
    p["Bi"] = np.random.default_rng(seed).normal(size=In).astype(np.float32) * 0.1
    if quantized:
        assert not act[2], "the CNN's codes lie on no grid"
        p = {name: quarters(v * 4) for name, v in p.items()}
    model = comp_vbpr_from_jax(p, *given, device="cpu", weight_components=weights)
    nested = {k: jnp.asarray(v) for k, v in p.items() if not k.startswith("cnn.")}
    if act[2]:
        nested["cnn"] = {k[4:]: jnp.asarray(v) for k, v in p.items() if k.startswith("cnn.")}
    return jm, nested, frozen, model


def ids(seed, B=16, Un=U, In=I):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, hi, B).astype(np.int32) for hi in (Un, In, In))


def jax_masks(key, B):
    """JAX's dropout keep-masks of ``loss(rng=key)`` in the port's order:
    the positives' tower (fc6, fc7), then the negatives'."""
    masks = []
    for r in jax.random.split(key):
        for k in jax.random.split(r):
            masks.append(torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (B, 4096)))))
    return masks


def assert_grad_close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_FLOOR * float(np.abs(want).max()), err_msg=name)


def np_params(model):
    return {k: v.detach().numpy() for k, v in model.named_parameters()}


# --- tests/test_comp_vbpr.py ------------------------------------------------


def predict_all_oracle(p, f, weights, fe):
    """Reference predict_all (CompVBPR.py:410-459) in numpy; ``fe`` is the
    CNN-encoded edge matrix [I, D]."""
    x = p["Bi"][None, :] + p["Gu"] @ p["Gi"].T
    for w, tu, e, bp, fam in ((weights[0], "Tus", "Es", "Bps", "Fs"),
                              (weights[1], "Tuc", "Ec", "Bpc", "Fc"),
                              (weights[3], "Tut", "Et", "Bpt", "Ft")):
        x = x + w * (p[tu] @ (f[fam] @ p[e]).T + (f[fam] @ p[bp]).reshape(-1))
    return x + weights[2] * (p["Tue"] @ fe.T + (fe @ p["Bpe"]).reshape(-1))


def test_predict_all_matches_reference_formula():
    _, _, _, model = jax_comp(seed=0)
    f = {k: v.numpy() for k, v in model.named_buffers()}
    fe = model.encode_all_edges().numpy()
    got = model.predict_all().numpy()
    np.testing.assert_allclose(got, predict_all_oracle(np_params(model), f, model.weights, fe),
                               rtol=1e-4, atol=1e-5)
    users, items = torch.tensor([0, 3, 6]), torch.tensor([1, 5, 10])
    with torch.no_grad():
        np.testing.assert_allclose(model.score(users, items).numpy(), got[users, items],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(model.predict_user_block(users).numpy(), got[users],
                               rtol=1e-4, atol=1e-5)


def test_factored_eval_matches_predict_all():
    _, _, _, model = jax_comp(seed=1)
    uf, vf, bias = model.factored_eval()
    assert uf.shape == (U, K + 4 * D) and vf.shape == (I, K + 4 * D)
    np.testing.assert_allclose((uf @ vf.T + bias[None, :]).numpy(),
                               model.predict_all().numpy(), rtol=1e-4, atol=1e-5)


def test_eval_encode_blocking_invariant():
    """Blocked CNN encode == one-shot encode at any block size (one that
    does not divide num_items included)."""
    _, _, _, model = jax_comp(seed=2)
    with torch.no_grad():
        whole = model.cnn.encode(model.Fe_img).numpy()
    for blk in (1, 4, I, I + 3):
        model.eval_encode_block = blk
        np.testing.assert_allclose(model.encode_all_edges().numpy(), whole, rtol=1e-5,
                                   atol=1e-5)


def test_all_components_off_reduces_to_bprmf():
    model = CompVBPR(U, I, activated_components=(False,) * 4, embed_k=K, device="cpu")
    assert sorted(dict(model.named_parameters())) == ["Bi", "Gi", "Gu"]
    assert not dict(model.named_buffers()) and model.cnn is None
    bpr = BPRMF(U, I, embed_k=K, device="cpu")
    with torch.no_grad():
        for name in ("Gu", "Gi", "Bi"):
            getattr(bpr, name).copy_(getattr(model, name))
    torch.testing.assert_close(model.predict_all(), bpr.predict_all(), rtol=1e-5, atol=0)
    uf, vf, _ = model.factored_eval()
    assert uf.shape == (U, K) and vf.shape == (I, K)
    u, p, n = (t(x).long() for x in ids(3))
    torch.testing.assert_close(model.loss(u, p, n, 0.01), bpr.loss(u, p, n, 0.01),
                               rtol=1e-6, atol=1e-7)


def test_single_component_toggle_matches_manual_delta():
    """Activating only the color family adds exactly the weighted color term
    (CompVBPR.py:190-200)."""
    _, col, _, _ = families()
    w = 0.7
    model = CompVBPR(U, I, color_features=col, embed_k=K, embed_d=D,
                     weight_components=(0.25, w, 0.25, 0.25), device="cpu",
                     generator=torch.Generator().manual_seed(4))
    assert model.activated == (False, True, False, False)
    p = np_params(model)
    base = p["Bi"][None, :] + p["Gu"] @ p["Gi"].T
    color_term = w * (p["Tuc"] @ (col @ p["Ec"]).T + (col @ p["Bpc"]).reshape(-1)[None, :])
    np.testing.assert_allclose(model.predict_all().numpy(), base + color_term, rtol=1e-4,
                               atol=1e-5)


def test_loss_matches_reference_oracle_frozen_families():
    """Loss parity against a numpy port of CompVBPR.py:264-293 (frozen
    families only): gathered-factor reg, neg-bias reg/10, whole-matrix E*
    / Bp* reg."""
    _, _, _, model = jax_comp(seed=7, act=(True, True, False, True),
                              weights=(0.5, 0.25, 0.25, 2.0))
    u, pp, nn = ids(11)
    reg = 0.37
    with torch.no_grad():
        got = float(model.loss(t(u).long(), t(pp).long(), t(nn).long(), reg))
    p, f = np_params(model), {k: v.numpy() for k, v in model.named_buffers()}
    ws = model.weights

    def score(items):
        x = p["Bi"][items] + np.sum(p["Gu"][u] * p["Gi"][items], axis=1)
        for w, tu, e, bp, fam in ((ws[0], "Tus", "Es", "Bps", "Fs"),
                                  (ws[1], "Tuc", "Ec", "Bpc", "Fc"),
                                  (ws[3], "Tut", "Et", "Bpt", "Ft")):
            x = x + w * (np.sum(p[tu][u] * (f[fam][items] @ p[e]), axis=1)
                         + (f[fam][items] @ p[bp])[:, 0])
        return x

    def l2(x):
        return 0.5 * float(np.sum(np.square(x, dtype=np.float64)))

    diff = np.clip(score(pp) - score(nn), -80.0, 1e8)
    want = float(np.sum(np.logaddexp(0.0, -diff)))
    want += (reg * (l2(p["Gu"][u]) + l2(p["Gi"][pp]) + l2(p["Gi"][nn]) + l2(p["Tus"][u])
                    + l2(p["Tuc"][u]) + l2(p["Tut"][u])) * 2
             + reg * l2(p["Bi"][pp]) * 2 + reg * l2(p["Bi"][nn]) * 2 / 10
             + reg * sum(l2(p[k]) for k in ("Es", "Ec", "Et", "Bps", "Bpc", "Bpt")) * 2)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_cnn_weights_regularized_biases_not():
    """The reg part of the CNN's gradient is 2 reg W for its weights and 0
    for its biases (CompVBPR.py:286-290 filters 'bias' out)."""
    model = CompVBPR(U, I, edge_images=families()[2], embed_k=K, embed_d=D, device="cpu",
                     generator=torch.Generator().manual_seed(6))
    u, p, n = torch.tensor([0, 1]), torch.tensor([1, 2]), torch.tensor([3, 4])
    cnn = dict(model.cnn.named_parameters())
    with torch.enable_grad():
        reg_only = model.loss(u, p, n, 1.0) - model.loss(u, p, n, 0.0)
        g = dict(zip(cnn, torch.autograd.grad(reg_only, list(cnn.values()),
                                              allow_unused=True)))
    torch.testing.assert_close(g["conv1_W"], 2.0 * cnn["conv1_W"].detach(), rtol=1e-4,
                               atol=1e-5)
    for name in ("conv1_b", "fc8_b"):
        assert g[name] is None or float(g[name].abs().max()) < 1e-8


def test_training_reduces_loss():
    """End-to-end learning: 6 epochs of fit (dropout on) lower the loss over
    the training pairs, dropout off (the per-epoch losses of a few triples
    are too noisy to compare)."""
    data = synthetic_interactions(20, 30, interactions_per_user=6, seed=0)
    pairs = np.asarray(data.train_pairs)
    neg = np.random.default_rng(0).integers(0, 30, len(pairs))
    u, p, n = (torch.from_numpy(np.asarray(x, np.int64)) for x in (pairs[:, 0], pairs[:, 1], neg))
    model = CompVBPR(20, 30, *families(30), embed_k=8, embed_d=4, device="cpu")
    with torch.no_grad():
        before = float(model.loss(u, p, n, 0.0))
    cfg = TrainConfig(batch_size=40, epochs=6, lr=0.001, reg=0.0, validation=False)
    fit(model, data, cfg)
    with torch.no_grad():
        assert float(model.loss(u, p, n, 0.0)) < before


# --- against JAX --------------------------------------------------------------


def test_buffers_params_and_spec():
    jm, params, frozen, model = jax_comp()
    own = dict(model.named_parameters())
    assert sorted(own) == sorted(flatten_params(jax.tree.map(np.asarray, params)))
    assert sorted(dict(model.named_buffers())) == sorted(frozen) == ["Fc", "Fe_img", "Fs", "Ft"]
    assert not set(dict(model.named_buffers())) & set(model.state_dict())
    spec, jspec = model.packed_spec(), jm.packed_spec()
    assert spec.user_tables == jspec.user_tables and spec.dense == jspec.dense
    assert spec.user_tables == (("Gu", K), ("Tus", D), ("Tuc", D), ("Tue", D), ("Tut", D))
    assert spec.item_tables == (("Gi", K),) and spec.item_scalars == ("Bi",)
    with pytest.raises(ValueError, match="edges component activated but no features"):
        CompVBPR(U, I, activated_components=(False, False, True, False), device="cpu")
    with pytest.raises(ValueError, match="color features rows"):
        CompVBPR(U, I + 1, color_features=families()[1], device="cpu")
    bf16 = CompVBPR(U, I, *families(), embed_k=K, embed_d=D, compute_dtype="bfloat16",
                    device="cpu")
    assert bf16.compute_dtype == bf16.cnn.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert bf16.predict_all().dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype must be one of"):
        CompVBPR(U, I, color_features=families()[1], compute_dtype="float16", device="cpu")


def test_reset_parameters_draws_glorot_in_jax_order():
    sem, col, edges, tex = families()
    kw = dict(embed_k=K, embed_d=D, device="cpu")
    a = CompVBPR(U, I, sem, col, edges, tex, generator=torch.Generator().manual_seed(1), **kw)
    b = CompVBPR(U, I, sem, col, edges, tex, generator=torch.Generator().manual_seed(1), **kw)
    for name, p in a.named_parameters():
        x = p.detach()
        torch.testing.assert_close(x, dict(b.named_parameters())[name], rtol=0, atol=0)
        if name == "Bi" or name.endswith("_b"):
            assert float(x.abs().max()) == 0.0, name
            continue
        lim = np.sqrt(6.0 / ((x.shape[-2] + x.shape[-1]) * int(np.prod(x.shape[:-2]))))
        assert float(x.abs().max()) <= lim * (1 + 1e-6), name  # the f32 limit
        assert x.numel() < 64 or float(x.std()) > lim / 4, name


@pytest.mark.parametrize("fn", ["score", "predict_all", "factored_eval", "predict_user_block",
                                "predict_user_block_ctx"])
def test_model_functions_match_jax(fn):
    jm, params, frozen, model = jax_comp(seed=2)
    users = np.array([0, 7, 39, 25, 7], np.int32)
    items = np.array([3, 49, 0, 30, 3], np.int32)
    with torch.no_grad():
        if fn == "score":
            got = [model.score(t(users).long(), t(items).long())]
            want = [jm.score(params, frozen, jnp.asarray(users), jnp.asarray(items))]
        elif fn == "predict_all":
            got, want = [model.predict_all()], [jm.predict_all(params, frozen)]
        elif fn == "factored_eval":
            got, want = model.factored_eval(), jm.factored_eval(params, frozen)
        else:
            ctx = model.precompute_eval() if fn.endswith("ctx") else None
            jctx = jm.precompute_eval(params, frozen) if fn.endswith("ctx") else None
            got = [model.predict_user_block(t(users).long(), ctx)]
            want = [jm.predict_user_block(params, frozen, jnp.asarray(users), jctx)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_params_mapping_replaces_the_models_own():
    _, _, _, model = jax_comp(seed=3)
    other = {k: v.detach() * 2 for k, v in model.named_parameters()}
    sem, col, edges, tex = (getattr(model, n).numpy() for n in ("Fs", "Fc", "Fe_img", "Ft"))
    twice = comp_vbpr_from_jax({k: v.numpy() for k, v in other.items()}, sem, col, edges, tex,
                               device="cpu")
    with torch.no_grad():
        for a, b in zip(model.factored_eval(other), twice.factored_eval()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        users = torch.arange(9)
        torch.testing.assert_close(model.predict_user_block(users, params=other),
                                   twice.predict_user_block(users), rtol=0, atol=0)
        torch.testing.assert_close(model.score(users, users, params=other),
                                   twice.score(users, users), rtol=0, atol=0)


@pytest.mark.parametrize("dropout,reg", [(True, 0.05), (False, 0.0)],
                         ids=["jax-masks", "no-dropout"])
def test_loss_and_grads_match_jax(dropout, reg):
    jm, params, frozen, model = jax_comp(seed=4)
    u, p, n = ids(5)
    key = jax.random.PRNGKey(6)
    jfn = jax.jit(jax.value_and_grad(lambda pr: jm.loss(
        pr, frozen, jnp.asarray(u), jnp.asarray(p), jnp.asarray(n), reg,
        rng=key if dropout else None)))
    jl, jg = jfn(params)
    names = [k for k, _ in model.named_parameters()]
    loss = model.loss(t(u).long(), t(p).long(), t(n).long(), reg,
                      rng=jax_masks(key, len(u)) if dropout else None)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    jg = flatten_params(jax.tree.map(np.asarray, jg))
    for name, g in zip(names, grads):
        assert_grad_close(g, jg[name], name)


def gathered(model, u, p, n):
    """packed_loss's arguments from the model's own params."""
    own = dict(model.named_parameters())
    spec = model.packed_spec()
    user_vw = {name: own[name][u] for name, _ in spec.user_tables}
    pos_vw, neg_vw = ({"Gi": own["Gi"][x], "Bi": own["Bi"][x]} for x in (p, n))
    dense = {k: v for k, v in own.items() if k not in ("Gu", "Gi", "Bi")
             and not k.startswith("Tu")}
    return user_vw, pos_vw, neg_vw, dense


def test_packed_loss_matches_loss_and_jax():
    jm, params, frozen, model = jax_comp(seed=8)
    u, p, n = ids(9)
    key = jax.random.PRNGKey(10)
    user_vw, pos_vw, neg_vw, dense = gathered(model, *(t(x).long() for x in (u, p, n)))
    with torch.no_grad():
        got = model.packed_loss(user_vw, pos_vw, neg_vw, dense, None,
                                tuple(t(x).long() for x in (u, p, n)), 0.02,
                                rng=jax_masks(key, len(u)))
        own = model.loss(*(t(x).long() for x in (u, p, n)), 0.02, rng=jax_masks(key, len(u)))
    assert float(got) == float(own)
    ju, jp_, jn = (jnp.asarray(x) for x in (u, p, n))
    spec = jm.packed_spec()
    juser = {name: params[name][ju] for name, _ in spec.user_tables}
    jpos, jneg = ({"Gi": params["Gi"][x], "Bi": params["Bi"][x]} for x in (jp_, jn))
    jdense = {name: params[name] for name in spec.dense}
    want = jax.jit(lambda *a: jm.packed_loss(*a, frozen, (ju, jp_, jn), 0.02, rng=key))(
        juser, jpos, jneg, jdense)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


ABLATIONS = {"all-0.4": (ALL, (0.4, 0.2, 0.2, 0.2)),
             "semantic+texture": ((True, False, False, True), (0.25,) * 4),
             "edges": ((False, False, True, False), (0.25,) * 4),
             "color": ((False, True, False, False), (0.25,) * 4)}


@pytest.mark.parametrize("pattern", list(ABLATIONS))
def test_ablation_patterns_match_jax(pattern):
    act, weights = ABLATIONS[pattern]
    jm, params, frozen, model = jax_comp(seed=12, act=act, weights=weights)
    assert model.activated == act and model.weights == weights
    assert set(flatten_params(jax.tree.map(np.asarray, params))) == set(np_params(model))
    u, p, n = ids(13)
    with torch.no_grad():
        np.testing.assert_allclose(model.predict_all().numpy(),
                                   np.asarray(jm.predict_all(params, frozen)), **TOL)
        got = model.loss(t(u).long(), t(p).long(), t(n).long(), 0.01)
    want = jax.jit(lambda pr: jm.loss(pr, frozen, jnp.asarray(u), jnp.asarray(p),
                                      jnp.asarray(n), 0.01))(params)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert model.factored_eval()[0].shape[1] == K + D * sum(act)


# --- the packed step, the Trainer, checkpoints --------------------------------


def split_cnn(state):
    """(the state with its non-CNN dense entries only, {"cnn.<member>": (p,
    m, v)})."""
    dense = {k: v for k, v in state.dense.items() if k != "cnn"}
    cnn = {f"cnn.{k}": tuple(x[k] for x in state.dense["cnn"]) for k in state.dense["cnn"][0]}
    return state._replace(dense=dense), cnn


def assert_cnn_close(got, want, lr, steps, share=0.01):
    """The CNN's params (and moments): within STATE_TOL but for at most a
    ``share`` of each tensor, each within 2 lr a step.  Its ReLUs pass or
    stop a gradient by the sign of a pre-activation, which the two
    libraries' summation orders may set apart near 0; the Adam step of an
    entry whose gradient so changed follows its sign (the JAX test calls
    the tower chaotic, ``tests/test_comp_vbpr.py::test_training_reduces_loss``)."""
    for name, g in got.items():
        g, w = np.asarray(g), np.asarray(want[name])
        beyond = ~(np.abs(g - w) <= STATE_TOL["atol"] + STATE_TOL["rtol"] * np.abs(w))
        assert beyond.mean() <= share, (name, int(beyond.sum()), g.size)
        assert not beyond.any() or float(np.abs(g - w)[beyond].max()) <= 2 * lr * steps, name


@pytest.mark.parametrize("moment_dtype,row_align", [("float32", 1), ("float8", 128)])
def test_packed_step_matches_jax(moment_dtype, row_align):
    jm, params, frozen, model = jax_comp(seed=14)
    jstate = jpg.pack_generic_state(jm, params, moment_dtype=moment_dtype,
                                    row_align=row_align)
    state = tpg.pack_generic_state(model, dict(model.named_parameters()),
                                   moment_dtype=moment_dtype, row_align=row_align)
    assert_bits(state.user_pmv, jstate.user_pmv, "user_pmv")
    assert_bits(state.item_pmv, jstate.item_pmv, "item_pmv")
    assert state.user_pmv.shape[1] % row_align == 0
    spec = model.packed_spec()
    md = moment_dtype if row_align > 1 else None
    tp = tpg.unpack_generic_params(state, spec, md)
    jp = flatten_params(jax.tree.map(np.asarray, jpg.unpack_generic_params(
        jstate, jm.packed_spec(), md)))
    assert sorted(tp) == sorted(jp) == sorted(np_params(model))
    for name in tp:
        assert_bits(tp[name], jp[name], name)
    state = generic_packed_state_from_jax(jax.tree.map(np.asarray, jstate), spec,
                                          device="cpu")
    jstep = jax.jit(jpg.make_generic_packed_step(jm, PACKED_LR, 0.01,
                                                 moment_dtype=moment_dtype, lazy_catchup=True))
    step = tpg.make_generic_packed_step(model, PACKED_LR, 0.01, moment_dtype=moment_dtype,
                                        lazy_catchup=True)
    steps = 3
    for s in range(steps):
        u, p, n = ids(15 + s, B=12)
        jstate, jl = jstep(jstate, (frozen, tuple(map(jnp.asarray, (u, p, n))), None))
        state, tl = step(state, (None, (t(u), t(p), t(n)), None))
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    (got, got_cnn), (want, want_cnn) = (split_cnn(x) for x in (
        state, jax.tree.map(np.asarray, jstate)))
    assert_packed_close(got, want, spec, moment_dtype, fused=False)
    for i, label in enumerate("pmv"):
        assert_cnn_close({k: v[i].numpy() for k, v in got_cnn.items()},
                         {k: v[i] for k, v in want_cnn.items()}, PACKED_LR, steps)


@pytest.mark.parametrize("train_path", ["generic", "packed"])
def test_trainer_matches_jax_from_carried_init_and_draws(train_path):
    """Two epochs fed JAX's sampler draws, the CNN's dropout off on both
    sides (its masks cannot follow JAX's per-step keys).  The CNN's params
    are held only within the drift of two Adam trajectories, 2 lr a step:
    its codes (~1e-3) move the scores little, so its gradients are tiny
    sums whose sign the two libraries' summation orders may set apart, and
    Adam steps each entry by about lr in its gradient's sign; after the
    first step the biases' moves (lr) outweigh the pre-activations and
    every later sign follows them.  The losses and every other param stay
    within the tolerances above.  At lr 0.001: at 0.01 the CNN's parted
    params move the second epoch's loss by 1.06e-5 relative."""
    Un, In = 24, 30
    kw = dict(batch_size=24, lr=0.001, reg=0.01, epochs=2, train_path=train_path)
    jdata = jsynth(Un, In, interactions_per_user=6, seed=0)
    jm, _, _, port = jax_comp(seed=3, Un=Un, In=In)
    jm.cnn.dropout_rate = port.cnn.dropout_rate = 0.0
    jtrainer = JTrainer(jm, jdata, JTrainConfig(**kw))
    init_rng, epoch_rng = jax.random.split(jax.random.PRNGKey(3))
    jstate, jfrozen = jtrainer.init_state(init_rng)
    jinit = flatten_params(jax.tree.map(np.asarray, jstate.params))
    with torch.no_grad():  # JAX's init, carried across
        for name, p in port.named_parameters():
            p.copy_(t(jinit[name]))
    trainer = Trainer(port, synthetic_interactions(Un, In, interactions_per_user=6, seed=0),
                      TrainConfig(**kw))
    state, frozen = trainer.init_state()
    if train_path == "packed":
        assert_bits(state.inner.user_pmv, jstate.inner.user_pmv, "packed user rows")
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
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    jparams = flatten_params(jax.tree.map(np.asarray, jstate.params))
    assert sorted(state.params) == sorted(jparams)
    drift = 2 * kw["lr"] * 2 * trainer.steps_per_epoch
    for name, p in state.params.items():
        if name.startswith("cnn."):  # see the docstring
            np.testing.assert_allclose(p.detach().numpy(), jparams[name], rtol=0, atol=drift,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(p.detach().numpy(), jparams[name], err_msg=name,
                                       **STATE_TOL)


@pytest.mark.parametrize("train_path", ["generic", "packed"])
def test_checkpoint_round_trips_the_nested_cnn(train_path, tmp_path):
    data = synthetic_interactions(12, 20, interactions_per_user=4, seed=1)
    model = CompVBPR(12, 20, *families(20), embed_k=K, embed_d=D, device="cpu")
    cfg = TrainConfig(batch_size=8, epochs=1, lr=0.01, reg=0.01, train_path=train_path,
                      moment_dtype="bfloat16")
    trainer = Trainer(model, data, cfg)
    state, frozen = trainer.init_state(seed=2)
    state, _ = trainer.run_epoch(state, frozen, 3)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(1, state)
    ckpt.save_best(state.params)
    fresh = CompVBPR(12, 20, *families(20), embed_k=K, embed_d=D, device="cpu")
    other = Trainer(fresh, data, cfg)
    template, _ = other.init_state(seed=9)
    restored = ckpt.restore(template)
    got, want = restored.params, state.params
    assert any(k.startswith("cnn.") for k in got)
    for name in want:
        assert_bits(got[name], want[name], name)
    if train_path == "packed":
        for a, b in zip(restored.inner.dense["cnn"], state.inner.dense["cnn"]):
            for k in b:
                assert_bits(a[k], b[k], f"cnn {k}")
    best = ckpt.restore_best(dict(fresh.named_parameters()))
    for name in want:
        assert_bits(best[name], want[name], name)


# --- evaluation and serving ----------------------------------------------------


def _frozen_only(seed=0, quantized=False, Un=U, In=I):
    return jax_comp(seed=seed, quantized=quantized, Un=Un, In=In,
                    act=(True, True, False, True))


@pytest.mark.parametrize("engine", [ENGINES[0], ENGINES[3]], ids=["dense", "kernel"])
def test_metrics_match_jax_gaussian(engine):
    metrics_match_jax(jax_comp, engine, False, 40, 60)


@pytest.mark.parametrize("engine", [ENGINES[0], ENGINES[3]], ids=["dense", "kernel"])
def test_metrics_match_jax_quantized_frozen_families(engine):
    metrics_match_jax(_frozen_only, engine, True, 40, 60)


def test_recserver_ids_equal_jax():
    serving_matches_jax(jax_comp, 30, 80)


def test_whole_matrix_reg_counts_the_cnn_weights_once():
    """loss(reg) - loss(0) is the reference's L2 sum, the CNN's non-bias
    weights included, at global_reg_scale 1."""
    _, _, _, model = jax_comp(seed=16)
    u, p, n = (t(x).long() for x in ids(17))
    own = dict(model.named_parameters())
    with torch.no_grad():
        got = float(model.loss(u, p, n, 0.5) - model.loss(u, p, n, 0.0))
        rows = (l2_loss(own["Gu"][u]) + l2_loss(own["Gi"][p]) + l2_loss(own["Gi"][n])
                + sum(l2_loss(own[tu][u]) for tu in ("Tus", "Tuc", "Tue", "Tut")))
        whole = sum(l2_loss(own[k]) for k in ("Es", "Ec", "Et", "Bps", "Bpc", "Bpt", "Bpe"))
        whole = whole + sum(l2_loss(v) for k, v in own.items()
                            if k.startswith("cnn.") and k.endswith("_W"))
        want = float(0.5 * rows * 2 + 0.5 * l2_loss(own["Bi"][p]) * 2
                     + 0.5 * l2_loss(own["Bi"][n]) * 2 / 10 + 0.5 * whole * 2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
