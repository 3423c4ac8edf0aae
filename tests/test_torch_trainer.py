"""Port generic trainer (``core/train_state.py``, ``train/trainer.py``) vs
the JAX package.

- ``tf_parity_adam`` against optax's Adam over 50 steps: rtol 1e-5;
- ``Trainer`` over 2 epochs from JAX's carried-over init, fed JAX's own
  sampler draws (``split(key)``, as ``Trainer._build_epoch_fn`` makes
  them): per-epoch loss rtol 1e-5, params rtol 2e-4, atol 1e-6 (f32 sums
  in another order, compounded over the steps);
- ``fit``'s run structure: best-params tracking with ties to the later
  epoch, the copy of ``best_params``, the JSONL records, and the options
  that wait for later slices (checkpoints: ``test_torch_checkpoint.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.interactions import (
    synthetic_interactions as jsynthetic,
)
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu.train.trainer import Trainer as JTrainer
from fashionvisualexpl_tpu_torch.core.config import MeshConfig, TrainConfig
from fashionvisualexpl_tpu_torch.core.train_state import (
    apply_gradients,
    create_train_state,
    tf_parity_adam,
)
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.models.convert import (
    bprmf_from_jax,
    train_state_from_jax,
)
from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fit

PARAM_TOL = dict(rtol=2e-4, atol=1e-6)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_tf_parity_adam_matches_optax_over_50_steps():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=7).astype(np.float32)}
    jtx = optax.adam(learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-7)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = jtx.init(jp)
    tx = tf_parity_adam(0.01)
    state = create_train_state({k: torch.from_numpy(v.copy()) for k, v in params.items()}, tx)
    for _ in range(50):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        updates, jopt = jtx.update({k: jnp.asarray(g) for k, g in grads.items()}, jopt, jp)
        jp = optax.apply_updates(jp, updates)
        state = apply_gradients(state, {k: torch.from_numpy(g) for k, g in grads.items()}, tx)
    assert int(state.step) == 50 and int(state.opt_state.count) == int(jopt[0].count)
    for k in params:
        np.testing.assert_allclose(state.params[k].numpy(), np.asarray(jp[k]), rtol=1e-5)
        np.testing.assert_allclose(state.opt_state.mu[k].numpy(),
                                   np.asarray(jopt[0].mu[k]), rtol=1e-5)
        np.testing.assert_allclose(state.opt_state.nu[k].numpy(),
                                   np.asarray(jopt[0].nu[k]), rtol=1e-5)


@pytest.mark.parametrize("carry_mid_run", [False, True])
def test_trainer_epochs_match_jax_from_carried_init_and_draws(carry_mid_run):
    """Two epochs; with ``carry_mid_run`` the port restarts epoch 2 from
    JAX's state after epoch 1 (``train_state_from_jax``)."""
    U, I, K = 40, 60, 8
    kw = dict(batch_size=32, lr=0.01, reg=0.01, epochs=2)
    jdata = jsynthetic(U, I, interactions_per_user=6, seed=0)
    jmodel = JBPRMF(U, I, embed_k=K)
    jtrainer = JTrainer(jmodel, jdata, JTrainConfig(**kw))
    init_rng, epoch_rng = jax.random.split(jax.random.PRNGKey(3))
    jstate, jfrozen = jtrainer.init_state(init_rng)

    model = bprmf_from_jax(_np(jstate.params), device="cpu")
    trainer = Trainer(model, synthetic_interactions(U, I, interactions_per_user=6,
                                                    seed=0), TrainConfig(**kw))
    assert trainer.steps_per_epoch == jtrainer.steps_per_epoch
    assert (trainer._train_pairs is None) == (jtrainer._train_pairs is None)
    state, frozen = trainer.init_state()
    for epoch in (1, 2):
        key = jax.random.fold_in(epoch_rng, epoch)
        sample_key, _ = jax.random.split(key)
        triples = jsampler.sample_triplets(
            sample_key, jtrainer._train_pairs, jtrainer._padded_pos,
            jtrainer._pos_counts, I, jtrainer.steps_per_epoch, kw["batch_size"],
            with_replacement=jtrainer.cfg.sampling_scheme)
        if carry_mid_run and epoch == 2:
            adam = jstate.opt_state[0]
            state = train_state_from_jax(model, jstate.step, _np(jstate.params),
                                         adam.count, _np(adam.mu), _np(adam.nu))
        state, loss = trainer.run_steps(
            state, frozen, tuple(torch.from_numpy(np.array(t)) for t in triples),
            step_key=epoch)
        jstate, jloss = jtrainer.run_epoch(jstate, jfrozen, key)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(state.step) == int(jstate.step)
    for k, p in state.params.items():
        assert p is getattr(model, k)  # the model's own parameters, in place
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[k]),
                                   err_msg=k, **PARAM_TOL)


class _ConstEvaluator:
    """Duck-typed evaluator whose metric never changes: every epoch ties."""

    def __init__(self):
        self.printed = []

    def evaluate(self, params, frozen):
        return {"ndcg_v": 0.5, "auc_v": 0.7}

    def print_epoch(self, epoch, epochs, mean_loss, rec):
        self.printed.append((epoch, epochs, mean_loss))


def _small_run(**cfg_kw):
    data = synthetic_interactions(30, 40, interactions_per_user=8, seed=1)
    model = BPRMF(30, 40, embed_k=8, device="cpu")
    cfg = TrainConfig(batch_size=16, epochs=4, lr=0.05, reg=0.001, seed=5, **cfg_kw)
    return model, data, cfg


def test_fit_keeps_the_run_structure():
    model, data, cfg = _small_run(eval_every=2)
    logs, ev = [], _ConstEvaluator()
    state, frozen, results, extra = fit(model, data, cfg, evaluator=ev, log=logs.append)
    assert [r["epoch"] for r in logs] == [1, 2, 3, 4]
    assert set(logs[1]) >= {"epoch", "loss", "train_time_s", "eval_time_s", "ndcg_v"}
    assert "ndcg_v" not in logs[0]
    assert sorted(results) == [2, 4] and [p[0] for p in ev.printed] == [2, 4]
    losses = [r["loss"] for r in logs]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # ties go to the later epoch; best_params is a copy, not the live params
    assert extra["best_epoch"] == 4
    for k, p in state.params.items():
        assert extra["best_params"][k] is not p
        torch.testing.assert_close(extra["best_params"][k], p.detach(), rtol=0, atol=0)
    assert [h.epoch for h in extra["history"]] == [1, 2, 3, 4]

    # the same seed gives the same run; without an evaluator the best
    # params stay the initial draw
    model2, _, _ = _small_run()
    state2, _, _, extra2 = fit(model2, data, cfg)
    for k in state.params:
        torch.testing.assert_close(state2.params[k], state.params[k], rtol=0, atol=0)
        assert not torch.equal(extra2["best_params"][k], state2.params[k].detach())
    assert extra2["best_epoch"] == 0


@pytest.mark.parametrize("what", ["packed", "mesh"])
def test_options_of_later_slices_raise(what):
    model, data, cfg = _small_run()
    # the packed engine runs on one device; over a mesh it is a later slice
    cfg = dataclasses.replace(cfg, mesh=MeshConfig(data=2, model=1))
    if what == "packed":
        cfg = dataclasses.replace(cfg, train_path="packed")
    with pytest.raises(NotImplementedError, match="ROADMAP: Multi-device"):
        fit(model, data, cfg)
