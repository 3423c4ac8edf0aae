"""AttentiveFashion with ``compute_dtype="bfloat16"`` vs the JAX package's
bf16 model on the same tower route, on the CPU, for each of the routes
"fused" (the port's ``kernel`` route: K7's bf16 plain version here, JAX's
bf16 Pallas kernel in interpret mode), "xla" (``plain``) and "s2d", from
JAX's params carried across (``models/convert.py``, which carries the
compute dtype):

- ``encode_items`` and ``predict_all`` within 4e-3 of their largest value
  (one bf16 rounding: the attention's bf16 matmuls sum in another order);
- ``loss`` with JAX's dropout masks fed in (rtol 1e-3) and its gradients
  within 2e-2 of each gradient's largest entry, f32 like the params.  On
  the xla and s2d routes ``edges_enc.conv_b`` is held against JAX's f32
  model instead: XLA sums that gradient of the bf16 conv output in bf16,
  5.4% of its largest entry from the f32 model's, where the port's stays
  within 0.7% (measured on this test's data);
- one ``Trainer`` epoch of one step from JAX's init and draws (dropout
  off), generic and packed: the loss rtol 1e-3, every param f32 and within
  2 lr of JAX's (Adam moves each entry by about lr in its gradient's sign,
  which bf16 sums may set apart for a gradient near 0); in each param 90%
  of the entries within 1e-4 + 1e-3 |w| of JAX's, and 90% of those JAX's
  step moved by more than lr / 2 moved the same way;
- ``loss_streamed`` of a ``host_features`` model (f32 rows shipped, cast
  on the device) against JAX's, and equal to the resident loss;
- the dense ``Evaluator`` against the port's own results (one user block
  and many; the f32 model on the same weights within 0.05) and JAX's bf16
  model within the same 0.05; ``RecServer``'s direct path against JAX's
  bf16 model on the route "fused": the same ids, values within one bf16
  rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.eval.evaluator import Evaluator as JEvaluator
from fashionvisualexpl_tpu.models.attentive_fashion import AttentiveFashion as JAF
from fashionvisualexpl_tpu.serve import RecServer as JRecServer
from fashionvisualexpl_tpu.train.trainer import Trainer as JTrainer
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator
from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
from fashionvisualexpl_tpu_torch.models.convert import attentive_fashion_from_jax, flatten_params
from fashionvisualexpl_tpu_torch.serve import RecServer
from fashionvisualexpl_tpu_torch.train.trainer import Trainer
from tests.test_torch_attentive_fashion import FILTERS, HID, K, _arrays, _jax_masks

ROUTES = {"fused": "kernel", "xla": "plain", "s2d": "s2d"}
ONE_BF16, GRAD_SHARE, LOSS_RTOL = 4e-3, 2e-2, 1e-3
U, I = 12, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(route, Un=U, In=I, key=0, **kw):
    """(JAX bf16 model, params, frozen, the port's model on its weights)."""
    kw = dict(embed_k=K, attention_layers=(6, 1), encoder_hidden=HID, conv_filters=FILTERS,
              item_block=7, compute_dtype="bfloat16", edge_tower=route, **kw)
    jm = JAF(Un, In, *_arrays(In, seed=1), **kw)
    params, frozen = jm.init(jax.random.PRNGKey(key))
    pm = attentive_fashion_from_jax(jm, _np(params), _np(frozen), "cpu")
    assert pm.compute_dtype == torch.bfloat16 and pm.tower_route == ROUTES[route]
    return jm, params, frozen, pm


def _close_to_max(got, want, share, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=share * np.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize("route", list(ROUTES))
def test_encodings_and_scores_match_jax_bf16(route):
    jm, params, frozen, pm = _pair(route, key=1)
    e = pm.encode_items().detach()
    assert e.dtype == torch.float32
    _close_to_max(e, jm.encode_items(params, frozen), ONE_BF16)
    s = pm.predict_all()
    assert s.dtype == torch.float32
    _close_to_max(s, jm.predict_all(params, frozen), ONE_BF16)


@pytest.mark.parametrize("route", list(ROUTES))
def test_loss_and_grads_match_jax_bf16(route):
    jm, params, frozen, pm = _pair(route, key=4, dropout_rate=0.5)
    u, p, n = ([0, 1, 5, 11], [2, 3, 9, 0], [4, 5, 1, 15])
    key = jax.random.PRNGKey(7)
    args = (frozen, *map(jnp.asarray, (u, p, n)), 0.01)
    jl, jg = jax.value_and_grad(lambda pp: jm.loss(pp, *args, rng=key))(params)
    loss = pm.loss(*map(torch.tensor, (u, p, n)), 0.01, rng=_jax_masks(jm, key, len(u)))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    jg = flatten_params(_np(jg))
    if route != "fused":  # see the module docstring
        j32 = JAF(U, I, *_arrays(I, seed=1), embed_k=K, attention_layers=(6, 1),
                  encoder_hidden=HID, conv_filters=FILTERS, item_block=7, edge_tower=route,
                  dropout_rate=0.5)
        g32 = jax.grad(lambda pp: j32.loss(pp, *args, rng=key))(params)
        jg["edges_enc.conv_b"] = np.asarray(g32["edges_enc"]["conv_b"])
    names = [k for k, _ in pm.named_parameters()]
    for name, g in zip(names, torch.autograd.grad(loss, list(pm.parameters()))):
        assert g.dtype == torch.float32, name
        _close_to_max(g, jg[name], GRAD_SHARE, name)


@pytest.mark.parametrize("train_path", ["generic", "packed"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_trainer_step_matches_jax_bf16(route, train_path):
    """One epoch of one step (batch 24 over the 24 training pairs), dropout off."""
    Ut, It, lr = 12, 16, 0.01
    kw = dict(batch_size=24, lr=lr, reg=0.001, epochs=1, train_path=train_path)
    jdata = jsynth(Ut, It, interactions_per_user=4, seed=0)
    jm, _, _, _ = _pair(route, Un=Ut, In=It, dropout_rate=0.0)
    jtrainer = JTrainer(jm, jdata, JTrainConfig(**kw))
    assert jtrainer.steps_per_epoch == 1
    init_rng, epoch_rng = jax.random.split(jax.random.PRNGKey(3))
    jstate, jfrozen = jtrainer.init_state(init_rng)
    model = attentive_fashion_from_jax(jm, _np(jstate.params), _np(jfrozen), "cpu")
    trainer = Trainer(model, synthetic_interactions(Ut, It, interactions_per_user=4, seed=0),
                      TrainConfig(**kw))
    state, frozen = trainer.init_state()
    init = flatten_params(_np(jstate.params))
    key = jax.random.fold_in(epoch_rng, 1)
    sample_key, _ = jax.random.split(key)
    triples = jsampler.sample_triplets(
        sample_key, jtrainer._train_pairs, jtrainer._padded_pos, jtrainer._pos_counts, It, 1,
        kw["batch_size"], with_replacement=jtrainer.cfg.sampling_scheme)
    state, loss = trainer.run_steps(state, frozen, tuple(torch.from_numpy(np.array(t))
                                                         for t in triples), step_key=1)
    jstate, jloss = jtrainer.run_epoch(jstate, jfrozen, key)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = flatten_params(_np(jstate.params))
    for name, p in state.params.items():
        assert p.dtype == torch.float32, name
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want[name], rtol=0, atol=2 * lr, err_msg=name)
        close = np.mean(np.abs(got - want[name]) <= 1e-4 + 1e-3 * np.abs(want[name]))
        assert close >= 0.9, (name, close)
        # where JAX's step moved an entry by more than lr / 2, the port's
        # moved it the same way: a stale or reversed group fails here
        moved = np.abs(want[name] - init[name]) > lr / 2
        assert moved.any(), name
        same = np.sign(got - init[name])[moved] == np.sign(want[name] - init[name])[moved]
        assert np.mean(same) >= 0.9, (name, np.mean(same))


@pytest.mark.parametrize("route", list(ROUTES))
def test_loss_streamed_matches_jax_bf16(route):
    """A host_features model: the batch's f32 rows in, cast on the device."""
    data = synthetic_interactions(15, 12, interactions_per_user=5, seed=0)
    inputs = _arrays(12, seed=2)
    kw = dict(embed_k=K, attention_layers=(6, 1), encoder_hidden=HID, conv_filters=FILTERS,
              compute_dtype="bfloat16", edge_tower=route)
    jm = JAF(data.num_users, data.num_items, *inputs, host_features=True, **kw)
    params, frozen = jm.init(jax.random.PRNGKey(0))
    pm = attentive_fashion_from_jax(jm, _np(params), frozen, "cpu")
    resident = attentive_fashion_from_jax(
        JAF(data.num_users, data.num_items, *inputs, **kw), _np(params),
        {"Fc": inputs[0], "Fe_img": inputs[1], "Fcls": inputs[2]}, "cpu")
    u, p, n = (np.asarray(v, np.int32) for v in ([0, 3, 14], [1, 5, 11], [2, 7, 0]))
    feats = {f"{k}_{side}": src[ids] for side, ids in (("pos", p), ("neg", n))
             for k, src in (("col", inputs[0]), ("img", inputs[1]), ("cls", inputs[2]))}
    key = jax.random.PRNGKey(9)
    jl = jm.loss_streamed(params, *map(jnp.asarray, (u, p, n)),
                          {k: jnp.asarray(v) for k, v in feats.items()}, 0.01, rng=key)
    masks = _jax_masks(jm, key, len(u))
    ids = [torch.from_numpy(v).long() for v in (u, p, n)]
    loss = pm.loss_streamed(*ids, {k: torch.from_numpy(v) for k, v in feats.items()}, 0.01,
                            rng=masks)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    assert float(loss.detach()) == float(resident.loss(*ids, 0.01, rng=masks).detach())
    _close_to_max(pm.precompute_eval(), resident.precompute_eval(), 0)


@pytest.fixture(scope="module")
def eval_case():
    Ue, Ie = 14, 18
    jm, params, frozen, pm = _pair("fused", Un=Ue, In=Ie, key=8, batch_eval=5)
    return (jsynth(Ue, Ie, interactions_per_user=5, seed=3),
            synthetic_interactions(Ue, Ie, interactions_per_user=5, seed=3),
            jm, params, frozen, pm)


def test_dense_evaluator_runs_bf16_like_its_f32_model(eval_case):
    """The port's own results: the bf16 model's metrics in blocks of 5
    users equal those in one block, and lie within 0.05 of the f32 model's
    on the same weights (bf16 scores reorder near ties: JAX's bf16 model
    parts from the port's bf16 model by 0.005 in AUC here, as the scores'
    last bf16 bits differ)."""
    jdata, data, jm, params, frozen, pm = eval_case
    got = Evaluator(pm, data, k=4, user_block=5).evaluate(None, None)
    assert got == Evaluator(pm, data, k=4, user_block=data.num_users).evaluate(None, None)
    f32 = AttentiveFashion(data.num_users, data.num_items, *_arrays(data.num_items, seed=1),
                           embed_k=K, attention_layers=(6, 1), encoder_hidden=HID,
                           conv_filters=FILTERS, item_block=7, batch_eval=5, device="cpu")
    f32.load_state_dict(pm.state_dict())
    want = Evaluator(f32, data, k=4, user_block=5).evaluate(None, None)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=0.05, err_msg=key)
    jwant = JEvaluator(jm, jdata, k=4, user_block=5).evaluate(params, frozen)
    for key in jwant:
        np.testing.assert_allclose(got[key], jwant[key], rtol=0, atol=0.05, err_msg=key)


def test_recserver_direct_path_matches_jax_bf16(eval_case):
    jdata, data, jm, params, frozen, pm = eval_case
    srv = RecServer(pm, data, k=3, device="cpu")
    srv.refresh()
    jsrv = JRecServer(jm, jdata, k=3)
    jsrv.refresh(params, frozen)
    users = np.arange(data.num_users, dtype=np.int32)
    ids, vals = srv.query(users)
    jids, jvals = jsrv.query(users)
    np.testing.assert_array_equal(ids, jids)
    _close_to_max(vals, jvals, ONE_BF16)
