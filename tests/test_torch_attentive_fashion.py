"""Port AttentiveFashion (``models/attentive_fashion.py`` and the modules of
its path) vs the JAX package, on the CPU.

- ``attentive_fashion_from_jax`` carries JAX's init across; ``encode_items``,
  ``score``, ``precompute_eval`` (with and without ``batch_eval``, I not a
  multiple), ``predict_user_block`` (item_block 7) and ``attention_weights``
  agree at rtol 1e-5, atol 1e-7 (f32 sums in another order);
- ``loss`` and its gradients with JAX's own dropout masks fed in (the
  ``jax.random.bernoulli`` draws on the split keys of ``loss`` and
  ``encode_items``): loss rtol 1e-5, atol 1e-7, gradients rtol 1e-4;
- features and ``load_edge_image_stack``: bit-equal on the JAX package's
  synthetic on-disk dataset;
- ``Trainer`` over 2 epochs from JAX's init, fed JAX's sampler draws, dropout
  0: losses rtol 1e-5, params rtol 2e-4, atol 1e-6; with dropout on, the same
  seed gives the same run, and a resumed run (nested parameter names in the
  checkpoints) ends bit for bit where the uninterrupted one ends;
- the dense ``Evaluator`` and both attention dumps: metrics rtol 1e-6; dump
  ids equal (tie-free data), scores and weights rtol 1e-5;
- ``RecServer``'s direct path vs JAX's: ids equal, values rtol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.core.config import Paths as JPaths
from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import features as jfeatures
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.data.pipeline import load_edge_image_stack as jload_edges
from fashionvisualexpl_tpu.data.synthetic_dataset import make_synthetic_dataset_on_disk
from fashionvisualexpl_tpu.eval.evaluator import Evaluator as JEvaluator
from fashionvisualexpl_tpu.models.attentive_fashion import AttentiveFashion as JAF
from fashionvisualexpl_tpu.serve import RecServer as JRecServer
from fashionvisualexpl_tpu.train.trainer import Trainer as JTrainer
from fashionvisualexpl_tpu_torch.core.checkpoint import CheckpointManager
from fashionvisualexpl_tpu_torch.core.config import Paths, TrainConfig
from fashionvisualexpl_tpu_torch.data import features
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.data.pipeline import load_edge_image_stack
from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator
from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
from fashionvisualexpl_tpu_torch.models.convert import (
    attentive_fashion_from_jax,
    flatten_params,
)
from fashionvisualexpl_tpu_torch.serve import RecServer
from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fit

TOL = dict(rtol=1e-5, atol=1e-7)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
U, I, K, HID, FILTERS, IMG = 12, 16, 8, 16, 4, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _arrays(I=I, img=IMG, seed=0):
    rng = np.random.default_rng(seed)
    color = jfeatures.synthetic_features(I, 10, seed=seed)
    edges = rng.random((I, img, img, 1)).astype(np.float32)
    cls = np.eye(5, dtype=np.float32)[rng.integers(0, 5, I)]
    return color, edges, cls


def _pair(U=U, I=I, seed=0, key=0, **kw):
    """(jax model, params, frozen, port model) on the same weights."""
    kw = dict(embed_k=K, attention_layers=(6, 1), encoder_hidden=HID,
              conv_filters=FILTERS, item_block=7, **kw)
    jm = JAF(U, I, *_arrays(I, seed=seed), **kw)
    params, frozen = jm.init(jax.random.PRNGKey(key))
    return jm, params, frozen, attentive_fashion_from_jax(jm, _np(params), _np(frozen), "cpu")


def _jax_masks(jm, key, B):
    """JAX's dropout keep-masks of ``loss(rng=key)``, in the port's order:
    positives then negatives, each color, edges, class."""
    keep = 1.0 - jm.dropout_rate
    masks = []
    for r in jax.random.split(key):
        for k, w in zip(jax.random.split(r, 3), (HID, FILTERS, HID)):
            masks.append(torch.from_numpy(np.array(jax.random.bernoulli(k, keep, (B, w)))))
    return masks


@pytest.mark.parametrize("batch_eval", [None, 5, 16], ids=["all", "blocks-of-5", "one-block"])
def test_encodings_and_scores_match_jax(batch_eval):
    jm, params, frozen, pm = _pair(batch_eval=batch_eval, key=1)
    assert pm.tower_route == "plain"  # edge_tower="auto" on the CPU
    np.testing.assert_allclose(pm.encode_items().detach().numpy(),
                               np.asarray(jm.encode_items(params, frozen)), **TOL)
    ctx = pm.precompute_eval()
    jctx = jm.precompute_eval(params, frozen)
    assert ctx.shape == (I, 3, K)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
    users = np.asarray([0, 5, 11, 3])
    np.testing.assert_allclose(
        pm.predict_user_block(torch.from_numpy(users), ctx).numpy(),
        np.asarray(jm.predict_user_block(params, frozen, jnp.asarray(users), jctx)), **TOL)
    att = pm.attention_weights(torch.from_numpy(users), ctx).numpy()
    assert att.shape == (4, I, 3)
    np.testing.assert_allclose(
        att, np.asarray(jm.attention_weights(params, frozen, jnp.asarray(users), jctx)),
        **TOL)
    np.testing.assert_allclose(att.sum(-1), 1.0, rtol=1e-5)
    uu, ii = np.asarray([0, 1, 7, 11]), np.asarray([3, 3, 15, 0])
    np.testing.assert_allclose(
        pm.score(torch.from_numpy(uu), torch.from_numpy(ii)).detach().numpy(),
        np.asarray(jm.score(params, frozen, jnp.asarray(uu), jnp.asarray(ii))), **TOL)
    np.testing.assert_allclose(pm.predict_all().numpy(),
                               np.asarray(jm.predict_all(params, frozen)), **TOL)


def test_scoring_methods_take_a_params_mapping():
    """Scores of a given mapping (e.g. fit's best_params) never touch the
    model's own parameters."""
    jm, params, frozen, pm = _pair(key=2)
    _, params2, _, pm2 = _pair(key=3)
    own = {k: v.detach().clone() for k, v in pm.named_parameters()}
    other = dict(pm2.named_parameters())
    users = torch.arange(U)
    np.testing.assert_allclose(
        pm.predict_user_block(users, params=other).numpy(),
        np.asarray(jm.predict_user_block(params2, frozen, jnp.arange(U))), **TOL)
    np.testing.assert_allclose(
        pm.attention_weights(users, params=other).numpy(),
        np.asarray(jm.attention_weights(params2, frozen, jnp.arange(U))), **TOL)
    for k, v in pm.named_parameters():
        assert torch.equal(v, own[k])


@pytest.mark.parametrize("dropout", [True, False], ids=["jax-masks", "no-dropout"])
def test_loss_and_grads_match_jax(dropout):
    jm, params, frozen, pm = _pair(key=4, dropout_rate=0.5)
    u, p, n = ([0, 1, 5, 11], [2, 3, 9, 0], [4, 5, 1, 15])
    key = jax.random.PRNGKey(7)
    jargs = (params, frozen, *map(jnp.asarray, (u, p, n)), 0.01)

    def jloss(pp):
        return jm.loss(pp, *jargs[1:], rng=key if dropout else None)

    jl, jg = jax.value_and_grad(jloss)(params)
    rng = _jax_masks(jm, key, len(u)) if dropout else None
    pl = pm.loss(*map(torch.tensor, (u, p, n)), 0.01, rng=rng)
    np.testing.assert_allclose(float(pl.detach()), float(jl), **TOL)
    names = [k for k, _ in pm.named_parameters()]
    grads = torch.autograd.grad(pl, list(pm.parameters()))
    jg = flatten_params(_np(jg))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], rtol=1e-4, atol=1e-7, err_msg=name)


def test_dropout_needs_an_rng_and_masks_are_checked():
    _, _, _, pm = _pair(key=5)
    u, p, n = (torch.tensor(v) for v in ([0, 1], [2, 3], [4, 5]))
    assert float(pm.loss(u, p, n, 0.0)) == float(pm.loss(u, p, n, 0.0))
    g1, g2 = (torch.Generator().manual_seed(s) for s in (0, 1))
    assert float(pm.loss(u, p, n, 0.0, rng=g1)) != float(pm.loss(u, p, n, 0.0, rng=g2))
    bad = [torch.ones(3, HID, dtype=torch.bool)] * 6
    with pytest.raises(ValueError, match="dropout mask"):
        pm.loss(u, p, n, 0.0, rng=bad)


def test_construction_rules():
    color, edges, cls = _arrays()
    odd = np.zeros((I, 7, 8, 1), np.float32)
    kw = dict(embed_k=4, attention_layers=(4, 1), device="cpu")
    assert AttentiveFashion(U, I, color, edges, cls, edge_tower="fused", **kw).tower_route == "kernel"
    assert AttentiveFashion(U, I, color, edges, cls, edge_tower="fused", conv_filters=300,
                            **kw).tower_route == "kernel"  # any filter count
    for tower in ("auto", "xla"):
        assert AttentiveFashion(U, I, color, edges, cls, edge_tower=tower,
                                **kw).tower_route == "plain"
    assert AttentiveFashion(U, I, color, edges, cls, edge_tower="s2d",
                            **kw).tower_route == "s2d"
    assert AttentiveFashion(U, I, color, odd, cls, **kw).tower_route == "plain"
    for tower in ("fused", "s2d"):
        with pytest.raises(ValueError, match="even"):
            AttentiveFashion(U, I, color, odd, cls, edge_tower=tower, **kw)
    with pytest.raises(ValueError, match="auto/fused/xla/s2d"):
        AttentiveFashion(U, I, color, edges, cls, edge_tower="banded", **kw)
    with pytest.raises(ValueError, match="width 1"):
        AttentiveFashion(U, I, color, edges, cls, embed_k=4, attention_layers=(4, 2),
                         device="cpu")
    with pytest.raises(ValueError, match="rows != num_items"):
        AttentiveFashion(U, I + 1, color, edges, cls, **kw)
    for tower in ("fused", "xla", "s2d"):  # bf16 runs on every route
        bf16 = AttentiveFashion(U, I, color, edges, cls, compute_dtype="bfloat16",
                                edge_tower=tower, **kw)
        assert bf16.compute_dtype == torch.bfloat16
        assert bf16.encode_items().dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in bf16.parameters())
    with pytest.raises(ValueError, match="compute_dtype must be one of"):
        AttentiveFashion(U, I, color, edges, cls, compute_dtype="float16", **kw)
    # host_features: no buffers (JAX's empty frozen); the host arrays kept
    host = AttentiveFashion(U, I, color, edges, cls, host_features=True, **kw)
    assert host.host_features and dict(host.named_buffers()) == {}
    for got, want in ((host._color, color), (host._edges, edges), (host._class, cls)):
        assert isinstance(got, np.ndarray) and np.shares_memory(got, want)
    assert sorted(dict(host.named_parameters())) == sorted(dict(
        AttentiveFashion(U, I, color, edges, cls, **kw).named_parameters()))


def test_init_draws_the_jax_shapes_and_scales():
    color, edges, cls = _arrays()
    pm = AttentiveFashion(U, I, color, edges, cls, embed_k=K, attention_layers=(6, 1),
                          encoder_hidden=HID, conv_filters=FILTERS, device="cpu")
    jparams, _ = JAF(U, I, color, edges, cls, embed_k=K, attention_layers=(6, 1),
                     encoder_hidden=HID, conv_filters=FILTERS).init(jax.random.PRNGKey(0))
    jflat = flatten_params(_np(jparams))
    own = dict(pm.named_parameters())
    assert sorted(own) == sorted(jflat)
    for name, p in own.items():
        assert tuple(p.shape) == jflat[name].shape, name
        # GlorotUniform limits (receptive field included for conv_W)
        assert float(p.abs().max()) <= float(np.abs(jflat[name]).max()) * 1.5 + 1e-6, name
    assert not torch.equal(pm.Gu, AttentiveFashion(
        U, I, color, edges, cls, embed_k=K, attention_layers=(6, 1), encoder_hidden=HID,
        conv_filters=FILTERS, device="cpu",
        generator=torch.Generator().manual_seed(1)).Gu)


@pytest.fixture(scope="module")
def disk_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("af_data"))
    make_synthetic_dataset_on_disk(root, num_users=10, num_items=14, interactions_per_user=4,
                                   edge_hw=(20, 16), with_images=True)
    return root


def test_features_and_edge_stack_bit_equal_to_jax(disk_dataset):
    jp, pp = JPaths(root=disk_dataset), Paths(root=disk_dataset)
    for name in ("load_color_histograms", "load_class_onehot"):
        got, want = getattr(features, name)(pp, "synthetic"), getattr(jfeatures, name)(jp, "synthetic")
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for hw in ((20, 16), (8, 12)):
        got = load_edge_image_stack(pp.edges_dir("synthetic"), 14, hw=hw)
        assert got.shape == (14, *hw, 1)
        np.testing.assert_array_equal(got, jload_edges(jp.edges_dir("synthetic"), 14, hw=hw))
    np.testing.assert_array_equal(features.synthetic_features(9, 5, seed=3),
                                  jfeatures.synthetic_features(9, 5, seed=3))
    raw = np.load(pp.cnn_features("synthetic", "vgg19", "fc2"))
    np.testing.assert_array_equal(features.load_cnn_features(pp, "synthetic", "vgg19", "fc2"),
                                  jfeatures.maxabs_normalize(raw))
    np.testing.assert_array_equal(features.maxabs_normalize(np.zeros((2, 2))), np.zeros((2, 2)))


TRAIN_KW = dict(batch_size=16, lr=0.01, reg=0.001, epochs=2)


def test_trainer_matches_jax_from_carried_init_and_draws():
    """Two epochs without dropout, fed JAX's sampler draws."""
    Ut, It = 20, 16
    jdata = jsynth(Ut, It, interactions_per_user=6, seed=0)
    jm = JAF(Ut, It, *_arrays(It, seed=1), embed_k=K, attention_layers=(6, 1),
             encoder_hidden=HID, conv_filters=FILTERS, dropout_rate=0.0)
    jtrainer = JTrainer(jm, jdata, JTrainConfig(**TRAIN_KW))
    init_rng, epoch_rng = jax.random.split(jax.random.PRNGKey(3))
    jstate, jfrozen = jtrainer.init_state(init_rng)
    model = attentive_fashion_from_jax(jm, _np(jstate.params), _np(jfrozen), "cpu")
    trainer = Trainer(model, synthetic_interactions(Ut, It, interactions_per_user=6, seed=0),
                      TrainConfig(**TRAIN_KW))
    state, frozen = trainer.init_state()
    assert sorted(frozen) == ["Fc", "Fcls", "Fe_img"]
    for epoch in (1, 2):
        key = jax.random.fold_in(epoch_rng, epoch)
        sample_key, _ = jax.random.split(key)
        triples = jsampler.sample_triplets(
            sample_key, jtrainer._train_pairs, jtrainer._padded_pos, jtrainer._pos_counts,
            It, jtrainer.steps_per_epoch, TRAIN_KW["batch_size"],
            with_replacement=jtrainer.cfg.sampling_scheme)
        state, loss = trainer.run_steps(
            state, frozen, tuple(torch.from_numpy(np.array(t)) for t in triples), step_key=1)
        jstate, jloss = jtrainer.run_epoch(jstate, jfrozen, key)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = flatten_params(_np(jstate.params))
    for name, p in state.params.items():
        assert p is dict(model.named_parameters())[name]
        np.testing.assert_allclose(p.detach().numpy(), jflat[name], err_msg=name, **PARAM_TOL)


def _fit_setup(epochs):
    data = synthetic_interactions(20, 16, interactions_per_user=6, seed=2)
    model = AttentiveFashion(20, 16, *_arrays(16, seed=3), embed_k=K, attention_layers=(6, 1),
                             encoder_hidden=HID, conv_filters=FILTERS, device="cpu")
    return model, data, TrainConfig(batch_size=16, epochs=epochs, lr=0.01, reg=0.001,
                                    seed=5, verbose=1, top_k=4)


def test_fit_with_dropout_is_reproducible_and_resumes_bit_for_bit(tmp_path):
    model, data, cfg = _fit_setup(3)
    logs = []
    state, _, _, _ = fit(model, data, cfg, log=logs.append)
    model2, _, _ = _fit_setup(3)
    logs2 = []
    fit(model2, data, cfg, log=logs2.append)
    assert [r["loss"] for r in logs] == [r["loss"] for r in logs2]
    assert np.isfinite([r["loss"] for r in logs]).all()
    # another seed draws other dropout masks (and init)
    model3, _, _ = _fit_setup(3)
    logs3 = []
    fit(model3, data, cfg, log=logs3.append, seed=6)
    assert [r["loss"] for r in logs3] != [r["loss"] for r in logs]

    ck = str(tmp_path / "ck")
    cut, _, cfg2 = _fit_setup(2)
    fit(cut, data, cfg2, ckpt_dir=ck)
    resumed, _, _ = _fit_setup(3)
    rstate, _, _, _ = fit(resumed, data, cfg, ckpt_dir=ck, resume=True)
    for name, p in state.params.items():
        assert "." in name or name in ("Gu", "Gi")
        assert torch.equal(rstate.params[name], p), name
    # the checkpoint holds the nested names and restores them in place
    fresh, _, _ = _fit_setup(3)
    best = CheckpointManager(ck).restore_best(dict(fresh.named_parameters()))
    assert "edges_enc.conv_W" in best and best["edges_enc.conv_W"] is fresh.edges_enc["conv_W"]


@pytest.fixture(scope="module")
def eval_case():
    """A JAX model and its port with Gaussian (tie-free) scores."""
    Ue, Ie = 14, 18
    jdata = jsynth(Ue, Ie, interactions_per_user=5, seed=3)
    jm, params, frozen, pm = _pair(U=Ue, I=Ie, seed=4, key=8, batch_eval=5)
    data = synthetic_interactions(Ue, Ie, interactions_per_user=5, seed=3)
    return jdata, data, jm, params, frozen, pm


def _rows(path):
    return [line.split("\t") for line in open(path).read().strip().split("\n")]


def test_dense_evaluator_and_attention_dumps_match_jax(eval_case, tmp_path):
    jdata, data, jm, params, frozen, pm = eval_case
    ev = Evaluator(pm, data, k=4, user_block=5)
    jev = JEvaluator(jm, jdata, k=4, user_block=5)
    calls = []
    inner = pm.precompute_eval
    pm.precompute_eval = lambda p=None: calls.append(1) or inner(p)
    try:
        got = ev.evaluate(None, None)
        assert len(calls) == 1  # one encoding of the items for both splits
    finally:
        del pm.precompute_eval
    want = jev.evaluate(params, frozen)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)

    jfn = lambda p, f, ids, ctx: jm.attention_weights(p, f, ids, ctx)  # noqa: E731
    pfn = lambda p, f, ids, ctx: pm.attention_weights(ids, ctx, params=p)  # noqa: E731
    jpath, ppath = str(tmp_path / "j.tsv"), str(tmp_path / "p.tsv")
    jev.store_recommendation_attention(params, frozen, jpath, attention_fn=jfn)
    ev.store_recommendation_attention(None, None, ppath, attention_fn=pfn)
    want_rows, rows = _rows(jpath), _rows(ppath)
    assert len(want_rows) == data.num_users * 4
    assert [r[:2] for r in rows] == [r[:2] for r in want_rows]
    vals = np.asarray([[float(x) for x in r[2:]] for r in rows])
    jvals = np.asarray([[float(x) for x in r[2:]] for r in want_rows])
    np.testing.assert_allclose(vals, jvals, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(vals[:, 1:].sum(1), 1.0, rtol=1e-5)


def test_recserver_direct_path_matches_jax(eval_case):
    jdata, data, jm, params, frozen, pm = eval_case
    srv = RecServer(pm, data, k=3, device="cpu")
    with pytest.raises(RuntimeError, match="refresh"):
        srv.query([0])
    srv.refresh()
    jsrv = JRecServer(jm, jdata, k=3)
    jsrv.refresh(params, frozen)
    users = np.arange(data.num_users, dtype=np.int32)
    ids, vals = srv.query(users)
    jids, jvals = jsrv.query(users)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(vals, jvals, rtol=1e-5, atol=1e-7)
    for u, row in enumerate(data.training_list):
        assert not set(ids[u]) & set(row)  # the history is never served
    # the index is a copy: a later change of the weights is not served
    with torch.no_grad():
        pm.Gu.mul_(-1.0)
    try:
        again, _ = srv.query(users)
        np.testing.assert_array_equal(again, ids)
        srv.refresh()
        assert not np.array_equal(srv.query(users)[0], ids)
    finally:
        with torch.no_grad():
            pm.Gu.mul_(-1.0)
    sub = np.asarray([3, 0, 9], np.int32)
    srv.refresh()
    np.testing.assert_array_equal(srv.query(sub)[0], ids[sub])
