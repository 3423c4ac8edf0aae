"""CompVBPR with ``compute_dtype="bfloat16"`` (its CNN in bf16) vs the JAX
package's bf16 CompVBPR, on the CPU, from JAX's params carried across
(``comp_vbpr_from_jax(..., compute_dtype="bfloat16")``) over
``tests/test_torch_comp_vbpr.py``'s features and 19x19 edge images:

- ``predict_all`` and ``factored_eval`` within 4e-3 of their largest value
  (one bf16 rounding of the CNN's codes);
- ``loss`` with JAX's dropout masks (rtol 1e-3) and its gradients, f32:
  the non-CNN ones within 2e-2 of each gradient's largest entry, the
  CNN's every entry within 1e-1 of its largest and at most 0.1% of them
  (or one) beyond 2e-2 (bf16 sums of the CNN's backward in another order;
  measured here: fc6_b, fc7_W and fc7_b part by up to 5.4%, one of
  conv2_b's 256 entries and 0.07% of fc7_b's beyond 2e-2);
  ``packed_loss`` equal to ``loss``;
- the generic and packed ``Trainer`` (one epoch from JAX's init and
  draws, CNN dropout off): losses rtol 1e-3, every param f32, the row
  tables within the f32 tests' tolerance (rtol 2e-4, atol 1e-6), the
  CNN's params within 2 lr a step of JAX's (``test_torch_comp_vbpr.py``'s
  drift);
- both evaluators (dense, and the factored one's kernel engine at D = K +
  4 d) against JAX's bf16 model within 1e-3 of each metric, and
  ``RecServer``'s ids equal to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.models.comp_vbpr import CompVBPR as JCompVBPR
from fashionvisualexpl_tpu.train.trainer import Trainer as JTrainer
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.convert import (
    comp_vbpr_from_jax,
    flatten_params,
)
from fashionvisualexpl_tpu_torch.serve import RecServer
from fashionvisualexpl_tpu_torch.train.trainer import Trainer
from tests.test_torch_comp_vbpr import D, K, families, ids, jax_masks, t
from tests.test_torch_vbpr import ENGINES, STATE_TOL, evaluators

ONE_BF16, GRAD_SHARE, LOSS_RTOL = 4e-3, 2e-2, 1e-3
U, I = 40, 50


def jax_comp_bf16(seed=0, Un=U, In=I):
    """(JAX bf16 model, params, frozen, the port's bf16 model from them)."""
    feats = families(In, seed)
    jm = JCompVBPR(Un, In, *feats, embed_k=K, embed_d=D, compute_dtype="bfloat16")
    params, frozen = jm.init(jax.random.PRNGKey(seed))
    model = comp_vbpr_from_jax(flatten_params(jax.tree.map(np.asarray, params)), *feats,
                               device="cpu", compute_dtype="bfloat16")
    assert model.cnn.compute_dtype == torch.bfloat16
    return jm, params, frozen, model


def _close_to_max(got, want, share, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=share * np.abs(want).max(), err_msg=msg)


def test_predict_all_and_factored_eval_match_jax_bf16():
    jm, params, frozen, model = jax_comp_bf16(seed=1)
    s = model.predict_all()
    assert s.dtype == torch.float32
    _close_to_max(s, jm.predict_all(params, frozen), ONE_BF16)
    for got, want in zip(model.factored_eval(), jm.factored_eval(params, frozen)):
        assert got.dtype == torch.float32
        _close_to_max(got, want, ONE_BF16)


def test_loss_and_grads_match_jax_bf16():
    jm, params, frozen, model = jax_comp_bf16(seed=2)
    u, p, n = ids(3)
    key = jax.random.PRNGKey(5)
    jl, jg = jax.value_and_grad(lambda pp: jm.loss(
        pp, frozen, *map(jnp.asarray, (u, p, n)), 0.01, rng=key))(params)
    masks = jax_masks(key, len(u))
    loss = model.loss(t(u).long(), t(p).long(), t(n).long(), 0.01, rng=masks)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    jg = flatten_params(jax.tree.map(np.asarray, jg))
    names = [k for k, _ in model.named_parameters()]
    for name, g in zip(names, torch.autograd.grad(loss, list(model.parameters()))):
        assert g.dtype == torch.float32, name
        if name.startswith("cnn."):  # see the module docstring
            d, m = np.abs(g.numpy() - jg[name]), np.abs(jg[name]).max()
            assert (d <= 0.1 * m).all(), name
            assert np.sum(d > GRAD_SHARE * m) <= max(1, 1e-3 * d.size), name
        else:
            _close_to_max(g, jg[name], GRAD_SHARE, name)
    own = dict(model.named_parameters())
    spec = model.packed_spec()
    uv = {k: own[k][t(u).long()] for k, _ in spec.user_tables}
    pv = {"Gi": own["Gi"][t(p).long()], "Bi": own["Bi"][t(p).long()]}
    nv = {"Gi": own["Gi"][t(n).long()], "Bi": own["Bi"][t(n).long()]}
    dense = {k: v for k, v in own.items() if k not in ("Gu", "Gi", "Bi") and not k.startswith("Tu")}
    packed = model.packed_loss(uv, pv, nv, dense, None, (t(u).long(), t(p).long(), t(n).long()),
                               0.01, rng=masks)
    assert float(packed.detach()) == float(loss.detach())


@pytest.mark.parametrize("train_path", ["generic", "packed"])
def test_trainer_matches_jax_bf16(train_path):
    Un, In, lr = 24, 30, 0.001
    kw = dict(batch_size=24, lr=lr, reg=0.01, epochs=1, train_path=train_path)
    jdata = jsynth(Un, In, interactions_per_user=6, seed=0)
    jm, _, _, port = jax_comp_bf16(seed=3, Un=Un, In=In)
    jm.cnn.dropout_rate = port.cnn.dropout_rate = 0.0
    jtrainer = JTrainer(jm, jdata, JTrainConfig(**kw))
    init_rng, epoch_rng = jax.random.split(jax.random.PRNGKey(3))
    jstate, jfrozen = jtrainer.init_state(init_rng)
    jinit = flatten_params(jax.tree.map(np.asarray, jstate.params))
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(t(jinit[name]))
    trainer = Trainer(port, synthetic_interactions(Un, In, interactions_per_user=6, seed=0),
                      TrainConfig(**kw))
    state, frozen = trainer.init_state()
    key = jax.random.fold_in(epoch_rng, 1)
    sample_key, _ = jax.random.split(key)
    triples = jsampler.sample_triplets(
        sample_key, jtrainer._train_pairs, jtrainer._padded_pos, jtrainer._pos_counts, In,
        jtrainer.steps_per_epoch, kw["batch_size"], with_replacement=jtrainer.cfg.sampling_scheme)
    state, loss = trainer.run_steps(state, frozen, tuple(t(x) for x in triples), step_key=1)
    jstate, jloss = jtrainer.run_epoch(jstate, jfrozen, key)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    jparams = flatten_params(jax.tree.map(np.asarray, jstate.params))
    drift = 2 * lr * trainer.steps_per_epoch
    for name, p in state.params.items():
        assert p.dtype == torch.float32, name
        if name.startswith("cnn."):
            np.testing.assert_allclose(p.detach().numpy(), jparams[name], rtol=0, atol=drift,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(p.detach().numpy(), jparams[name], err_msg=name,
                                       **STATE_TOL)


@pytest.mark.parametrize("engine", [ENGINES[0], ENGINES[3]], ids=["dense", "kernel"])
def test_evaluators_match_jax_bf16(engine):
    jdata = jsynth(40, 60, interactions_per_user=9, seed=7)
    data = synthetic_interactions(40, 60, interactions_per_user=9, seed=7)
    jm, params, frozen, model = jax_comp_bf16(seed=4, Un=40, In=60)
    ev, jev = evaluators(engine, jm, model, jdata, data)
    got, want = ev.evaluate(None, None), jev.evaluate(params, frozen)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3, err_msg=key)


def test_recserver_ids_equal_jax_bf16():
    from fashionvisualexpl_tpu.serve import RecServer as JRecServer

    jdata = jsynth(30, 80, interactions_per_user=6, seed=1)
    data = synthetic_interactions(30, 80, interactions_per_user=6, seed=1)
    jm, params, frozen, model = jax_comp_bf16(seed=5, Un=30, In=80)
    srv = RecServer(model, data, k=10, device="cpu")
    srv.refresh()
    jsrv = JRecServer(jm, jdata, k=10, segmax_kernel="interpret")
    jsrv.refresh(params, frozen)
    users = np.arange(30, dtype=np.int32)
    got, vals = srv.query(users)
    want, jvals = jsrv.query(users)
    np.testing.assert_array_equal(got, np.asarray(want))
    _close_to_max(vals, jvals, ONE_BF16)
