"""Port ACF (``models/acf.py``, ``models/convert.py::acf_from_jax``,
``data/pipeline.py::load_spatial_feature_stack``, ``models/base.py::
normal_init``; ACF through the generic ``Trainer``, both evaluators and
``RecServer``) vs the JAX package, on the CPU, from JAX's params carried
across over the same numpy-seeded spatial maps.

- the mirror of every test in ``tests/test_acf.py``, on the port;
- ``_pad_user_pos`` and the four positive tables bit-equal (the same
  ``default_rng(seed)`` draws: subsampled ids equal), ``load_spatial_
  feature_stack`` bit-equal on [H, W, C] and [S, C] files and its error;
- ``user_profile`` (train and eval), ``score``, ``predict_all``,
  ``predict_user_block``, ``factored_eval``: rtol 1e-5, atol 1e-7 (the
  attention sums S*C and K products in another order than XLA's);
- ``loss`` and its gradients with a zero-positive user: loss rtol 1e-5,
  gradients rtol 1e-4, atol 1e-5 of each tensor's max;
- the chunked profile (``exact_eval`` / ``exact_train``) against JAX's,
  with a P_max off the chunk, a chunk wider than P_max, a zero-positive
  user and a window with no valid slot, and its gradients as above;
- ``compute_dtype="bfloat16"`` against the port's own f32 at
  ``tests/test_acf.py:231``'s rtol = atol = 0.02;
- the generic ``Trainer`` from JAX's init fed JAX's draws: losses rtol
  1e-5, params rtol 2e-4, atol 1e-6; evaluation (dense and streaming
  engines) metrics rtol 2e-3, atol 2e-4 (``tests/test_golden.py``'s), the
  port's streaming equal to its dense; serving ids equal to JAX's on
  tie-free data, values rtol 1e-5, atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import pipeline as jpipeline
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.eval.evaluator import Evaluator as JEvaluator
from fashionvisualexpl_tpu.eval.factored import FactoredEvaluator as JFactored
from fashionvisualexpl_tpu.models import acf as jacf
from fashionvisualexpl_tpu.serve import RecServer as JRecServer
from fashionvisualexpl_tpu.train.trainer import Trainer as JTrainer
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data import pipeline as tpipeline
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator
from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
from fashionvisualexpl_tpu_torch.models import acf as tacf
from fashionvisualexpl_tpu_torch.models.acf import ACF
from fashionvisualexpl_tpu_torch.models.base import normal_init
from fashionvisualexpl_tpu_torch.models.convert import acf_from_jax, flatten_params
from fashionvisualexpl_tpu_torch.serve import RecServer
from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fit

FN_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
STATE_TOL = dict(rtol=2e-4, atol=1e-6)
GOLDEN = dict(rtol=2e-3, atol=2e-4)


def t(x):
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def spatial(I, S, C, seed):
    return np.random.default_rng(seed).normal(size=(I, S, C)).astype(np.float32)


def pair(U=15, I=20, S=4, C=6, K=8, seed=0, key=0, per_user=7, layers=(5, 1), **kw):
    """(JAX model, params, frozen, the port's model from them, port data)
    over the same interactions and spatial maps."""
    spat = spatial(I, S, C, seed)
    jm = jacf.ACF(U, I, spat, jsynth(U, I, interactions_per_user=per_user, seed=seed),
                  embed_k=K, layers_component=layers, layers_item=layers, seed=seed, **kw)
    params, frozen = jm.init(jax.random.PRNGKey(key))
    data = synthetic_interactions(U, I, interactions_per_user=per_user, seed=seed)
    model = acf_from_jax(np_tree(params), spat, data, device="cpu", seed=seed, **kw)
    return jm, params, frozen, model, data


def assert_grad_close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_FLOOR * float(np.abs(want).max()), err_msg=name)


def blank_user(jm, frozen, model, u, eval_too=False):
    """User u with no positive in both packages (the tables and frozen)."""
    keys = ("train", "eval") if eval_too else ("train",)
    for k in keys:
        getattr(model, f"pos_{k}")[u] = 0
        getattr(model, f"cnt_{k}")[u] = 0
        frozen[f"pos_{k}"] = frozen[f"pos_{k}"].at[u].set(0)
        frozen[f"cnt_{k}"] = frozen[f"cnt_{k}"].at[u].set(0)


# --- the mirror of tests/test_acf.py ----------------------------------------


def _make(U=15, I=20, S=4, C=6, K=8, seed=0, max_user_pos=5):
    data = synthetic_interactions(U, I, interactions_per_user=7, seed=seed)
    model = ACF(U, I, spatial(I, S, C, seed), data, embed_k=K, layers_component=(5, 1),
                layers_item=(5, 1), max_user_pos=max_user_pos, seed=seed, device="cpu")
    return model, data


def test_profile_shapes_and_zero_pos_user():
    model, data = _make()
    model.pos_train[3] = 0
    model.cnt_train[3] = 0
    with torch.no_grad():
        prof = model.user_profile(torch.tensor([0, 3, 7]))
    assert prof.shape == (3, model.embed_k)
    np.testing.assert_allclose(prof[1].numpy(), model.Gu[3].detach().numpy(), rtol=1e-6)
    assert not np.allclose(prof[0].numpy(), model.Gu[0].detach().numpy())


def test_padding_invariance():
    m5, data = _make(max_user_pos=5)
    m9, _ = _make(max_user_pos=9)
    with torch.no_grad():
        for a, b in zip(m5.parameters(), m9.parameters()):
            b.copy_(a)
        users = torch.tensor([u for u in range(data.num_users)
                              if len(data.training_list[u]) <= 5])
        np.testing.assert_allclose(m5.user_profile(users).numpy(),
                                   m9.user_profile(users).numpy(), rtol=1e-5, atol=1e-6)


def test_predict_consistency():
    model, _ = _make()
    full = model.predict_all().numpy()
    users = torch.tensor([0, 6, 14])
    np.testing.assert_allclose(model.predict_user_block(users).numpy(), full[[0, 6, 14]],
                               rtol=2e-5, atol=1e-6)
    items = torch.tensor([2, 9, 19])
    with torch.no_grad():
        pw = model.score(users, items, train_only=False).numpy()
    np.testing.assert_allclose(pw, full[[0, 6, 14], [2, 9, 19]], rtol=2e-5, atol=1e-6)


def test_trains_end_to_end():
    model, data = _make(U=25, I=30, seed=2)
    cfg = TrainConfig(batch_size=32, epochs=8, lr=0.01, reg=0.0001, top_k=5, eval_every=8)
    ev = Evaluator(model, data, k=5, user_block=16)
    _, _, results, _ = fit(model, data, cfg, evaluator=ev)
    assert np.isfinite(results[8]["auc_t"]) and results[8]["auc_t"] > 0.5


def test_exact_eval_chunked_matches_oneshot():
    model, data = _make(max_user_pos=9)
    users = torch.arange(data.num_users)
    with torch.no_grad():
        oneshot = model.user_profile(users, train_only=False).numpy()
        g_u = model.Gu[users]
        p = dict(model.named_parameters())
        for w in (1, 2, 3, 4, 9, 16):
            model.pos_chunk = w
            chunked = model._attentive_profile_chunked(p, g_u, model.pos_eval,
                                                       model.cnt_eval).numpy()
            np.testing.assert_allclose(chunked, oneshot, rtol=2e-6, atol=2e-6)


def _three(U, I, per_user, S, C, seed, kw, **extra):
    data = synthetic_interactions(U, I, interactions_per_user=per_user, seed=seed)
    spat = spatial(I, S, C, seed)
    return data, [ACF(U, I, spat, data, device="cpu", **kw, **e)
                  for e in ({"max_user_pos": 4}, dict(max_user_pos=4, **extra),
                            {"max_user_pos": 64})]


def _same_params(models):
    with torch.no_grad():
        for m in models[1:]:
            for a, b in zip(models[0].parameters(), m.parameters()):
                b.copy_(a)


def test_exact_eval_uses_all_positives_beyond_cap():
    kw = dict(embed_k=6, layers_component=(4, 1), layers_item=(4, 1), seed=0)
    data, (capped, exact, uncapped) = _three(10, 30, 12, 3, 5, 3, kw, exact_eval=True,
                                             pos_chunk=3)
    _same_params((capped, exact, uncapped))
    users = torch.arange(10)
    with torch.no_grad():
        p_e, p_u, p_c = (m.user_profile(users, train_only=False).numpy()
                         for m in (exact, uncapped, capped))
    np.testing.assert_allclose(p_e, p_u, rtol=2e-5, atol=2e-5)
    assert np.abs(p_c - p_u).max() > 1e-4
    assert exact.pos_train.shape[1] == 4 and exact.pos_eval.shape[1] > 4
    np.testing.assert_allclose(exact.predict_all().numpy(), uncapped.predict_all().numpy(),
                               rtol=2e-4, atol=2e-5)


def test_exact_train_gradients_match_padded_when_under_cap():
    U, I = 12, 16
    data = synthetic_interactions(U, I, interactions_per_user=5, seed=7)
    spat = spatial(I, 3, 5, 7)
    m_pad, m_ex = (ACF(U, I, spat, data, embed_k=6, layers_component=(4, 1),
                       layers_item=(4, 1), max_user_pos=8, seed=7, exact_train=e,
                       pos_chunk=3, device="cpu") for e in (False, True))
    _same_params((m_pad, m_ex))
    ids = (torch.tensor([0, 4, 9]), torch.tensor([1, 5, 10]), torch.tensor([2, 6, 11]))
    out = []
    for m in (m_pad, m_ex):
        loss = m.loss(*ids, 0.001)
        out.append((float(loss.detach()), torch.autograd.grad(loss, list(m.parameters()))))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-4, atol=1e-6)


def test_exact_train_uses_all_positives_beyond_cap():
    kw = dict(embed_k=6, layers_component=(4, 1), layers_item=(4, 1), seed=9)
    _, (capped, exact, uncapped) = _three(8, 30, 12, 3, 5, 9, kw, exact_train=True,
                                          pos_chunk=5)
    _same_params((capped, exact, uncapped))
    users = torch.arange(8)
    with torch.no_grad():
        p_c, p_e, p_u = (m.user_profile(users).numpy() for m in (capped, exact, uncapped))
    assert not np.allclose(p_e, p_c, rtol=1e-3)
    np.testing.assert_allclose(p_e, p_u, rtol=2e-5, atol=2e-6)


def test_exact_train_rejects_packed_path():
    model, _ = _make()
    model.exact_train = True
    with pytest.raises(ValueError, match="generic"):
        model.packed_spec()


def test_exact_train_end_to_end():
    U, I = 20, 24
    data = synthetic_interactions(U, I, interactions_per_user=8, seed=11)
    model = ACF(U, I, spatial(I, 3, 5, 11), data, embed_k=8, layers_component=(4, 1),
                layers_item=(4, 1), max_user_pos=4, seed=11, exact_train=True,
                exact_eval=True, pos_chunk=4, device="cpu")
    cfg = TrainConfig(batch_size=32, epochs=6, lr=0.01, reg=0.0001, top_k=5, eval_every=6)
    _, _, results, _ = fit(model, data, cfg, evaluator=Evaluator(model, data, k=5,
                                                                 user_block=16))
    assert np.isfinite(results[6]["auc_t"])


def test_acf_bf16_attention_tracks_fp32():
    data = synthetic_interactions(16, 20, interactions_per_user=6, seed=0)
    spat = np.asarray(np.random.default_rng(3).normal(size=(20, 3, 5)), np.float32)
    kw = dict(embed_k=8, layers_component=(4, 1), layers_item=(4, 1), max_user_pos=6,
              device="cpu")
    m32 = ACF(16, 20, spat, data, **kw)
    m16 = ACF(16, 20, spat, data, compute_dtype="bfloat16", **kw)
    _same_params((m32, m16))
    users, items = torch.arange(8), torch.arange(8) % 20
    with torch.no_grad():
        s32, s16 = (m.score(users, items).numpy() for m in (m32, m16))
    np.testing.assert_allclose(s16, s32, rtol=0.02, atol=0.02)
    assert s16.dtype == np.float32
    loss = m16.loss(users, items, (items + 3) % 20, 0.01)
    assert np.isfinite(float(loss.detach()))
    grads = torch.autograd.grad(loss, list(m16.parameters()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


# --- parity with the JAX package --------------------------------------------


@pytest.mark.parametrize("width", [1, 3, 5, 9])
def test_pad_user_pos_is_bit_equal(width):
    lists = [list(np.random.default_rng(u).permutation(40)[:u % 11]) for u in range(30)]
    got = tacf._pad_user_pos(lists, width, np.random.default_rng(5))
    want = jacf._pad_user_pos(lists, width, np.random.default_rng(5))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exact_eval,exact_train", [(False, False), (True, False),
                                                    (True, True)])
def test_positive_tables_are_bit_equal(exact_eval, exact_train):
    """Subsampled users included (9 positives over a cap of 4)."""
    jm, _, frozen, model, _ = pair(per_user=9, max_user_pos=4, exact_eval=exact_eval,
                                   exact_train=exact_train)
    for name in ("pos_train", "cnt_train", "pos_eval", "cnt_eval"):
        got = getattr(model, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(frozen[name]), name)
    assert (model.pos_train.shape[1] > 4) == exact_train
    assert (model.pos_eval.shape[1] > 4) == exact_eval
    assert int(model.cnt_train.max()) == (7 if exact_train else 4)  # 7 train positives


def test_array_path_and_its_errors():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 20, (15, 6)).astype(np.int32)
    cnt = rng.integers(0, 7, 15).astype(np.int32)
    spat = spatial(20, 4, 6, 1)
    jm = jacf.ACF(15, 20, spat, padded_positives=pos, positive_counts=cnt, embed_k=8)
    params, frozen = jm.init(jax.random.PRNGKey(3))
    model = acf_from_jax(np_tree(params), spat, padded_positives=pos, positive_counts=cnt,
                         device="cpu")
    assert model.max_user_pos == 6
    for name in ("pos_train", "pos_eval", "cnt_train", "cnt_eval"):
        np.testing.assert_array_equal(getattr(model, name).numpy(), np.asarray(frozen[name]))
    users = jnp.arange(15)
    np.testing.assert_allclose(model.user_profile(torch.arange(15)).detach().numpy(),
                               np.asarray(jm.user_profile(params, frozen, users)), **FN_TOL)
    for kw, match in ((dict(padded_positives=pos), "positive_counts required"),
                      (dict(padded_positives=pos, positive_counts=cnt, max_user_pos=5),
                       "max_user_pos=5"),
                      ({}, "either data"),
                      (dict(padded_positives=pos, positive_counts=cnt,
                            layers_item=(4, 2)), "width must be 1")):
        with pytest.raises(ValueError, match=match):
            ACF(15, 20, spat, device="cpu", **kw)
    with pytest.raises(ValueError, match="rows != num_items"):
        ACF(15, 21, spat, padded_positives=pos, positive_counts=cnt, device="cpu")


def test_params_and_init():
    """The port's parameter names and shapes are JAX's flattened; its own
    init draws RandomNormal(0.01) tables and GlorotUniform attention."""
    jm, params, _, model, _ = pair(K=16, layers=(6, 3, 1))
    flat = flatten_params(np_tree(params))
    own = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert own == {k: v.shape for k, v in flat.items()}
    assert "comp.W2" in own and own["comp.W2"] == (1, 3)
    assert set(model.state_dict()) == set(own)  # the buffers stay out of checkpoints
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert 0.007 < float(model.Gi.detach().std()) < 0.013
    x = normal_init((4000, 50), torch.Generator().manual_seed(1), torch.device("cpu"))
    assert abs(float(x.mean())) < 1e-3 and abs(float(x.std()) - 0.01) < 2e-4
    lim = np.sqrt(6.0 / (6 + 6))  # comp.W0_i [C=6, 6]
    w = model.comp["W0_i"].detach()
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.5 * lim


FNS = ["profile_train", "profile_eval", "score", "predict_all", "predict_user_block",
       "factored_eval"]


@pytest.mark.parametrize("fn", FNS)
def test_model_functions_match_jax(fn):
    jm, params, frozen, model, _ = pair(per_user=9, max_user_pos=6, key=2)
    blank_user(jm, frozen, model, 4, eval_too=True)  # a zero-positive user
    users, items = np.array([0, 4, 7, 14]), np.array([2, 9, 19, 4])
    with torch.no_grad():
        if fn.startswith("profile"):
            train = fn == "profile_train"
            got = model.user_profile(t(users), train)
            want = jm.user_profile(params, frozen, jnp.asarray(users), train)
            np.testing.assert_allclose(got[1].numpy(), model.Gu[4].numpy(), rtol=0, atol=0)
        elif fn == "score":
            got = model.score(t(users), t(items))
            want = jm.score(params, frozen, jnp.asarray(users), jnp.asarray(items))
        elif fn == "predict_all":
            got, want = model.predict_all(), jm.predict_all(params, frozen)
        elif fn == "predict_user_block":
            got = model.predict_user_block(t(users), model.precompute_eval())
            want = jm.predict_user_block(params, frozen, jnp.asarray(users))
            np.testing.assert_allclose(model.predict_user_block(t(users)).numpy(),
                                       got.numpy(), rtol=0, atol=0)
        else:
            got, gi, bias = model.factored_eval()
            want, jgi, jbias = jm.factored_eval(params, frozen)
            assert bias is None and jbias is None and got.shape == (15, 8)
            np.testing.assert_array_equal(gi.detach().numpy(), np.asarray(jgi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


def test_params_mapping_replaces_the_models_own():
    jm, params, frozen, model, _ = pair(key=4)
    other = {k: v.detach() * 1.5 for k, v in model.named_parameters()}
    jother = jax.tree.map(lambda v: v * 1.5, params)
    got = model.predict_all(params=other)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.predict_all(jother, frozen)),
                               **FN_TOL)
    assert not np.allclose(got.numpy(), model.predict_all().numpy())


def _loss_and_grads_match(jm, params, frozen, model, users, pos, neg, reg):
    loss = model.loss(t(users), t(pos), t(neg), reg)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, frozen, jnp.asarray(users),
                                                  jnp.asarray(pos), jnp.asarray(neg),
                                                  reg))(params)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=1e-7)
    jflat = flatten_params(np_tree(jg))
    # each attention's last bias shifts every logit of one softmax alike, so
    # only its L2 term has a gradient: without reg both packages give
    # rounding noise, held under the floor of the largest gradient
    blind = {f"comp.b{len(model.layers_component) - 1}",
             f"item.b{len(model.layers_item) - 1}"}
    floor = GRAD_FLOOR * max(float(np.abs(v).max()) for v in jflat.values())
    for name, g in zip(names, grads):
        if reg == 0 and name in blind:
            assert max(float(g.abs().max()), float(np.abs(jflat[name]).max())) <= floor
        else:
            assert_grad_close(g, jflat[name], name)


@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_loss_and_grads_match_jax(reg):
    jm, params, frozen, model, _ = pair(U=30, I=40, per_user=9, max_user_pos=6, key=5)
    blank_user(jm, frozen, model, 3)
    rng = np.random.default_rng(6)
    users = np.concatenate([[3, 3], rng.integers(0, 30, 22)]).astype(np.int32)
    pos, neg = (rng.integers(0, 40, 24).astype(np.int32) for _ in range(2))
    _loss_and_grads_match(jm, params, frozen, model, users, pos, neg, reg)


@pytest.mark.parametrize("pos_chunk", [3, 4, 16], ids=["3", "4", "wider"])
def test_chunked_profile_and_grads_match_jax(pos_chunk):
    """exact_train / exact_eval over P_max = 10 (train) and 11 (eval), off
    any chunk: windows of 3 (the fourth holding no valid slot for users of
    9 positives or fewer), 4, and 16 (one window wider than P_max); user 2
    has no positive."""
    jm, params, frozen, model, _ = pair(U=12, I=30, per_user=12, max_user_pos=4,
                                        exact_train=True, exact_eval=True,
                                        pos_chunk=pos_chunk, key=7)
    assert (model.pos_train.shape[1], model.pos_eval.shape[1]) == (10, 11)
    for name in ("pos_train", "pos_eval"):  # users of 9 positives or fewer
        frozen[name] = frozen[name].at[:6, 9:].set(0)
        getattr(model, name)[:6, 9:] = 0
    for name in ("cnt_train", "cnt_eval"):
        frozen[name] = frozen[name].at[:6].set(jnp.minimum(frozen[name][:6], 9))
        getattr(model, name)[:6] = torch.clamp(getattr(model, name)[:6], max=9)
    blank_user(jm, frozen, model, 2, eval_too=True)
    users = np.arange(12, dtype=np.int32)
    for train in (True, False):
        with torch.no_grad():
            got = model.user_profile(t(users), train)
        want = jm.user_profile(params, frozen, jnp.asarray(users), train)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
        np.testing.assert_array_equal(got[2].numpy(), model.Gu[2].detach().numpy())
    rng = np.random.default_rng(8)
    pos, neg = (rng.integers(0, 30, 12).astype(np.int32) for _ in range(2))
    _loss_and_grads_match(jm, params, frozen, model, users, pos, neg, 0.01)


def test_chunked_windows_are_recomputed_in_the_backward_pass():
    """Under autograd each window runs inside ``torch.utils.checkpoint``:
    the forward keeps no [B, W, S, C] window (the Fspat gathers run once
    more in the backward pass, one a window)."""
    _, _, _, model, _ = pair(U=12, I=30, per_user=12, max_user_pos=4, exact_train=True,
                             pos_chunk=5)
    calls = []
    orig = ACF._item_logits

    def counting(self, *a):
        calls.append(torch.is_grad_enabled())
        return orig(self, *a)

    ACF._item_logits = counting
    try:
        loss = model.loss(torch.arange(12), torch.arange(12), torch.arange(12) + 12, 0.0)
        n_fwd = len(calls)
        torch.autograd.grad(loss, [model.Gi])
    finally:
        ACF._item_logits = orig
    assert n_fwd == 2 and len(calls) == 4  # 10 positives in windows of 5


def test_load_spatial_feature_stack_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for name, shape in (("hwc", (1, 3, 3, 5)), ("sc", (9, 5))):
        d = tmp_path / name
        d.mkdir()
        for i in range(6):
            np.save(d / f"{i}.npy", rng.normal(size=shape).astype(np.float32))
        got = tpipeline.load_spatial_feature_stack(str(d), 6)
        want = jpipeline.load_spatial_feature_stack(str(d), 6)
        assert got.shape == (6, 9, 5) and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    bad = tmp_path / "bad"
    bad.mkdir()
    np.save(bad / "0.npy", np.zeros((2, 3, 4, 5), np.float32))
    with pytest.raises(ValueError) as jerr:
        jpipeline.load_spatial_feature_stack(str(bad), 1)
    with pytest.raises(ValueError) as perr:
        tpipeline.load_spatial_feature_stack(str(bad), 1)
    assert str(perr.value) == str(jerr.value) and "(2, 3, 4, 5)" in str(perr.value)


# --- Trainer, evaluation, serving -------------------------------------------


def test_generic_trainer_matches_jax_from_carried_init_and_draws():
    Un, In = 40, 50
    kw = dict(batch_size=32, lr=0.01, reg=0.01, epochs=2)
    jdata = jsynth(Un, In, interactions_per_user=6, seed=0)
    spat = spatial(In, 4, 6, 3)
    jm = jacf.ACF(Un, In, spat, jdata, embed_k=8, layers_component=(5, 1),
                  layers_item=(5, 1), max_user_pos=5)
    jtrainer = JTrainer(jm, jdata, JTrainConfig(**kw))
    init_rng, epoch_rng = jax.random.split(jax.random.PRNGKey(3))
    jstate, jfrozen = jtrainer.init_state(init_rng)
    data = synthetic_interactions(Un, In, interactions_per_user=6, seed=0)
    model = acf_from_jax(np_tree(jstate.params), spat, data, max_user_pos=5, device="cpu")
    trainer = Trainer(model, data, TrainConfig(**kw))
    state, frozen = trainer.init_state()
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
    jparams = flatten_params(np_tree(jstate.params))
    assert sorted(state.params) == sorted(jparams)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jparams[name], err_msg=name,
                                   **STATE_TOL)


@pytest.mark.parametrize("engine", ["dense", "bucketed", "mask"])
def test_metrics_match_jax(engine):
    jm, params, frozen, model, data = pair(U=40, I=60, per_user=9, max_user_pos=6, key=9)
    jdata = jsynth(40, 60, interactions_per_user=9, seed=0)
    if engine == "dense":
        ev, jev = Evaluator(model, data, k=10, user_block=16), JEvaluator(jm, jdata, k=10,
                                                                           user_block=16)
    else:
        ev = FactoredEvaluator(model, data, k=10, user_block=16, item_block=16,
                               counts_impl=engine)
        jev = JFactored(jm, jdata, k=10, user_block=16, item_block=16, counts_impl=engine)
    got, want = ev.evaluate(None, None), jev.evaluate(params, frozen)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **GOLDEN)


def test_streaming_matches_dense():
    """tests/test_factored_eval.py:57 on the port."""
    data = synthetic_interactions(15, 20, interactions_per_user=6, seed=2)
    model = ACF(15, 20, spatial(20, 3, 5, 0), data, embed_k=8, layers_component=(4, 1),
                layers_item=(4, 1), max_user_pos=6, device="cpu")
    dense = Evaluator(model, data, k=5, user_block=8).evaluate(None, None)
    streaming = FactoredEvaluator(model, data, k=5, user_block=8, item_block=9).evaluate(
        None, None)
    assert set(dense) == set(streaming)
    for key in dense:
        np.testing.assert_allclose(streaming[key], dense[key], rtol=1e-6, err_msg=key)


def test_recserver_ids_equal_jax():
    jm, params, frozen, model, data = pair(U=50, I=120, per_user=6, max_user_pos=6, key=10)
    jdata = jsynth(50, 120, interactions_per_user=6, seed=0)
    srv = RecServer(model, data, k=10, device="cpu")
    srv.refresh()
    jsrv = JRecServer(jm, jdata, k=10, segmax_kernel="interpret")
    jsrv.refresh(params, frozen)
    users = np.arange(50, dtype=np.int32)
    ids, vals = srv.query(users)
    jids, jvals = jsrv.query(users)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(vals, np.asarray(jvals), rtol=1e-5, atol=1e-6)
    scores = model.predict_all().numpy()
    for u, row in enumerate(data.training_list):
        scores[u, list(row)] = -np.inf
    np.testing.assert_array_equal(ids, np.argsort(-scores, axis=1, kind="stable")[:, :10])
