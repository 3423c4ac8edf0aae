"""Port evaluators (``eval/evaluator.py``, ``eval/factored.py``) against the
JAX package's, from the same carried weights.

- Metrics: on quantized weights (multiples of 1/4, K=8: every score exact in
  f32) the per-user metrics of a user block are equal (ndcg within rtol
  1e-6: the f32 log of two libraries) and the means within rtol 1e-6 (f32
  sums over the users in another order), for the dense Evaluator and every
  counts engine (JAX's Pallas kernel runs in interpret mode, the port's
  kernel engine takes its plain version on CPU tensors); on Gaussian
  weights within the golden tolerances (rtol 2e-3, atol 2e-4).
- ``print_epoch``: the same text.
- Dumps: ids equal on tie-free data, scores at rtol 1e-6; the factored
  attention dump (``store_recommendation_attention``) with one numpy
  attention function in both packages: ids equal, scores and weights
  within the golden tolerances.
- ``fit`` with the streaming evaluator from JAX's init and JAX's sampler
  draws: per-epoch metrics within the golden tolerances and the same
  ``best_epoch``; ``tests/test_golden.py``'s pinned run, the same way
  through the dense evaluator.
- ``best_params``: a run trained past its best epoch dumps the best
  epoch's recommendations and leaves the model's parameters alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.eval.evaluator import Evaluator as JEvaluator
from fashionvisualexpl_tpu.eval.evaluator import print_epoch_block as j_print_epoch_block
from fashionvisualexpl_tpu.eval.factored import FactoredEvaluator as JFactored
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu.train.trainer import EpochResult as JEpochResult
from fashionvisualexpl_tpu.train.trainer import Trainer as JTrainer
from fashionvisualexpl_tpu.train.trainer import fit as jfit
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator, print_epoch_block
from fashionvisualexpl_tpu_torch.core.mesh import make_mesh
from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.models.convert import bprmf_from_jax
from fashionvisualexpl_tpu_torch.train import trainer as trainer_mod
from fashionvisualexpl_tpu_torch.train.trainer import EpochResult, Trainer, fit

GOLDEN = dict(rtol=2e-3, atol=2e-4)
U, I, K = 40, 50, 8


def _weights(seed, quantized):
    jmodel = JBPRMF(U, I, embed_k=K)
    params, frozen = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    np_params = {k: np.asarray(v) for k, v in params.items()}
    np_params["Bi"] = rng.normal(size=I).astype(np.float32) * 0.3
    if quantized:  # scale the glorot draw up so that the quarters differ
        np_params = {k: (np.round(v * 16) / 4).astype(np.float32)
                     for k, v in np_params.items()}
    return jmodel, {k: jnp.asarray(v) for k, v in np_params.items()}, frozen, \
        bprmf_from_jax(np_params, device="cpu")


def _data(seed=7):
    return (jsynth(U, I, interactions_per_user=9, seed=seed),
            synthetic_interactions(U, I, interactions_per_user=9, seed=seed))


ENGINES = [("dense", None), ("mask", "mask"), ("bucketed", "bucketed"), ("kernel", "pallas")]


def _evaluators(engine, jmodel, model, jdata, data, k=10):
    kind, jkind = engine
    if kind == "dense":
        return (Evaluator(model, data, k=k, user_block=16),
                JEvaluator(jmodel, jdata, k=k, user_block=16))
    return (FactoredEvaluator(model, data, k=k, user_block=16, item_block=16,
                              counts_impl=kind),
            JFactored(jmodel, jdata, k=k, user_block=16, item_block=16,
                      counts_impl=jkind))


@pytest.mark.parametrize("engine", ENGINES, ids=[e[0] for e in ENGINES])
@pytest.mark.parametrize("quantized", [True, False], ids=["quantized", "gaussian"])
def test_metrics_match_jax(engine, quantized):
    jdata, data = _data()
    jmodel, params, frozen, model = _weights(4, quantized)
    ev, jev = _evaluators(engine, jmodel, model, jdata, data)
    got = ev.evaluate(None, None)
    want = jev.evaluate(params, frozen)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **(dict(rtol=1e-6, atol=0) if quantized else GOLDEN))
    if not quantized:
        return
    idx = np.arange(16) + 32  # the wrap-around tail block
    idx, jidx = torch.as_tensor(idx % U), jnp.asarray(idx % U)
    for split in ("val", "test"):
        if engine[0] == "dense":
            pm = ev._eval_block(split, None, None, idx, None)
            jm = jev._eval_block(split, params, frozen, jidx, None)
        else:
            uf, iv, ib = model.factored_eval()
            pm = ev._eval_block(split, uf.detach()[idx], iv.detach(), ib.detach(), idx)
            jm = jev._block_fn(split, params["Gu"][jidx], params["Gi"], params["Bi"], jidx)
        for f in ("hr", "prec", "rec", "auc", "valid"):
            np.testing.assert_array_equal(getattr(pm, f).numpy(), np.asarray(getattr(jm, f)))
        np.testing.assert_allclose(pm.ndcg.numpy(), np.asarray(jm.ndcg), rtol=1e-6, atol=0)


def test_counts_impl_choice_and_errors():
    _, data = _data()
    model = BPRMF(U, I, embed_k=K, device="cpu")
    assert FactoredEvaluator(model, data).counts_impl == "bucketed"  # CPU: auto
    with pytest.raises(ValueError, match="counts_impl"):
        FactoredEvaluator(model, data, counts_impl="pallas")
    with pytest.raises(ValueError, match="mesh 1x2 != 1 devices"):  # not the world size
        FactoredEvaluator(model, data, mesh=make_mesh(1, 2, device="cpu"))


def test_print_epoch_text_equals_jax(capsys):
    metrics = {"hr_v": 0.5, "p_v": 0.05, "r_v": 0.5, "auc_v": 0.75, "ndcg_v": 0.3,
               "hr_t": 0.25, "p_t": 0.025, "r_t": 0.25, "auc_t": 0.7, "ndcg_t": 0.2}
    for m in (metrics, None):
        print_epoch_block(10, 3, 7, 12.3456, EpochResult(3, 1.0, 1.5, 0.25, m))
        got = capsys.readouterr().out
        j_print_epoch_block(10, 3, 7, 12.3456, JEpochResult(3, 1.0, 1.5, 0.25, m))
        assert got == capsys.readouterr().out


def _read(path):
    rows = [line.split("\t") for line in open(path).read().strip().split("\n")]
    return (np.array([[int(r[0]), int(r[1])] for r in rows]),
            np.array([float(r[2]) for r in rows]))


@pytest.mark.parametrize("kind", ["dense", "factored", "factored-exact"])
def test_dumps_match_jax(kind, tmp_path):
    jdata, data = _data(3)
    jmodel, params, frozen, model = _weights(5, quantized=False)  # tie-free
    if kind == "dense":
        ev, jev = Evaluator(model, data, k=5, user_block=16), JEvaluator(jmodel, jdata, k=5,
                                                                          user_block=16)
        kw = {}
    else:
        ev = FactoredEvaluator(model, data, k=5, user_block=16, item_block=16)
        jev = JFactored(jmodel, jdata, k=5, user_block=16, item_block=16)
        kw = {"exact": kind == "factored-exact"}
    ev.store_recommendation(None, None, str(tmp_path / "port.tsv"), **kw)
    jev.store_recommendation(params, frozen, str(tmp_path / "jax.tsv"), **kw)
    ids, vals = _read(tmp_path / "port.tsv")
    jids, jvals = _read(tmp_path / "jax.tsv")
    assert ids.shape == (U * 5, 2)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(vals, jvals, rtol=1e-6)
    for (u, i) in ids:
        assert i not in data.training_list[u]


def _attention(users):
    """[B, I, 3] deterministic attention weights (softmax over the three
    columns) of the users ``users``, in numpy."""
    u = np.asarray(users, np.float32)[:, None, None]
    i = np.arange(I, dtype=np.float32)[None, :, None]
    c = np.arange(3, dtype=np.float32)[None, None, :]
    a = np.exp(np.sin(0.37 * u + 0.11 * i + 1.3 * c))
    return (a / a.sum(axis=2, keepdims=True)).astype(np.float32)


def test_factored_attention_dump_matches_jax(tmp_path):
    jdata, data = _data(3)
    jmodel, params, frozen, model = _weights(5, quantized=False)  # tie-free
    ev = FactoredEvaluator(model, data, k=5, user_block=16, item_block=16)
    jev = JFactored(jmodel, jdata, k=5, user_block=16, item_block=16)
    seen = []

    def port_fn(p, f, users, ctx):
        seen.append((users.dtype, tuple(users.shape), ctx))
        return torch.from_numpy(_attention(users.numpy()))

    ev.store_recommendation_attention(None, None, str(tmp_path / "port.tsv"), port_fn)
    jev.store_recommendation_attention(params, frozen, str(tmp_path / "jax.tsv"),
                                       lambda p, f, users, ctx: jnp.asarray(_attention(users)))
    rows, jrows = ([line.split("\t") for line in open(tmp_path / f).read().splitlines()]
                   for f in ("port.tsv", "jax.tsv"))
    assert len(rows) == U * 5 and {len(r) for r in rows} == {6}
    np.testing.assert_array_equal(np.array([r[:2] for r in rows], int),
                                  np.array([r[:2] for r in jrows], int))
    np.testing.assert_allclose(np.array([r[2:] for r in rows], float),
                               np.array([r[2:] for r in jrows], float), **GOLDEN)
    # one call a user block, the model's precompute_eval as ctx (BPRMF: None)
    assert seen == [(torch.int64, (16,), None)] * 2 + [(torch.int64, (U - 32,), None)]
    for u, i, _, *att in rows:
        np.testing.assert_allclose(np.array(att, float), _attention([int(u)])[0, int(i)],
                                   rtol=1e-6)
        assert int(i) not in data.training_list[int(u)]


def _fit_on_jax_draws(monkeypatch, data, kw, make_evaluator):
    """The port's ``fit`` from JAX's init and JAX's per-epoch sampler draws
    (``split(fold_in(epoch_key, epoch))``, as the JAX trainer makes them)."""
    jdata = jsynth(data.num_users, data.num_items,
                   interactions_per_user=len(data.training_list[0]) + 2,
                   seed=kw.pop("data_seed"))
    jmodel = JBPRMF(data.num_users, data.num_items, embed_k=K)
    jcfg = JTrainConfig(**kw)
    jtrainer = JTrainer(jmodel, jdata, jcfg)
    init_rng, epoch_rng = jax.random.split(jax.random.PRNGKey(kw["seed"]))
    jstate, _ = jtrainer.init_state(init_rng)
    draws = []
    for epoch in range(kw["epochs"], 0, -1):
        sample_key, _ = jax.random.split(jax.random.fold_in(epoch_rng, epoch))
        draws.append(jsampler.sample_triplets(
            sample_key, jtrainer._train_pairs, jtrainer._padded_pos, jtrainer._pos_counts,
            data.num_items, jtrainer.steps_per_epoch, kw["batch_size"],
            with_replacement=jcfg.sampling_scheme))
    monkeypatch.setattr(trainer_mod, "sample_triplets", lambda *a, **k: tuple(
        torch.from_numpy(np.array(t)) for t in draws.pop()))
    keep = Trainer.init_state
    monkeypatch.setattr(Trainer, "init_state", lambda self, seed=None: keep(self))
    model = bprmf_from_jax({k: np.asarray(v) for k, v in jstate.params.items()},
                           device="cpu")
    out = fit(model, data, TrainConfig(**kw), evaluator=make_evaluator(model))
    assert not draws
    return jmodel, jdata, jcfg, out


def test_fit_with_streaming_evaluator_matches_jax(monkeypatch):
    kw = dict(batch_size=32, lr=0.05, reg=0.001, epochs=3, seed=11, data_seed=9)
    _, data = _data(9)
    jmodel, jdata, jcfg, (_, _, results, extra) = _fit_on_jax_draws(
        monkeypatch, data, kw, lambda m: FactoredEvaluator(
            m, data, k=10, user_block=16, item_block=16, counts_impl="kernel"))
    jev = JFactored(jmodel, jdata, k=10, user_block=16, item_block=16, counts_impl="pallas")
    _, _, jresults, jextra = jfit(jmodel, jdata, jcfg, evaluator=jev)
    assert sorted(results) == sorted(jresults) == [1, 2, 3]
    for epoch in results:
        for key, value in jresults[epoch].items():
            np.testing.assert_allclose(results[epoch][key], value, err_msg=f"{epoch} {key}",
                                       **GOLDEN)
    assert extra["best_epoch"] == jextra["best_epoch"]


def test_golden_run_through_the_port(monkeypatch, capsys):
    """``tests/test_golden.py``'s seeded run (its data, config, init and
    draws) through the port's ``fit`` and dense ``Evaluator``: its pinned
    metrics, at its tolerances."""
    from tests.test_golden import GOLDEN as PINNED

    kw = dict(batch_size=32, epochs=2, lr=0.01, reg=0.001, top_k=10, eval_every=1,
              seed=42, data_seed=42)
    data = synthetic_interactions(50, 60, interactions_per_user=10, seed=42)
    *_, (_, _, results, _) = _fit_on_jax_draws(
        monkeypatch, data, kw, lambda m: Evaluator(m, data, k=10, user_block=32))
    capsys.readouterr()
    for epoch, want in PINNED.items():
        for key, value in want.items():
            np.testing.assert_allclose(results[epoch][key], value, err_msg=f"{epoch} {key}",
                                       **GOLDEN)


class _BestFirst:
    """Duck-typed evaluator whose validation metric falls every epoch (the
    best epoch is 1); it snapshots the params it is asked to evaluate."""

    def __init__(self):
        self.seen = []

    def evaluate(self, params, frozen):
        self.seen.append({k: v.detach().clone() for k, v in params.items()})
        return {"ndcg_v": 1.0 / len(self.seen)}

    def print_epoch(self, *a):
        pass


@pytest.mark.parametrize("dump", ["dense", "factored"])
def test_best_params_dump_leaves_the_model_alone(dump, tmp_path):
    _, data = _data(2)
    model = BPRMF(U, I, embed_k=K, device="cpu")
    spy = _BestFirst()
    state, frozen, _, extra = fit(model, data, TrainConfig(batch_size=32, epochs=3,
                                                           lr=0.05, seed=1),
                                  evaluator=spy)
    assert extra["best_epoch"] == 1
    final = {k: v.detach().clone() for k, v in model.named_parameters()}
    make = (lambda m: Evaluator(m, data, k=5, user_block=16)) if dump == "dense" else (
        lambda m: FactoredEvaluator(m, data, k=5, user_block=16, item_block=16))
    make(model).store_recommendation(extra["best_params"], frozen, str(tmp_path / "best.tsv"))
    for k, v in model.named_parameters():  # untouched, and not the best
        assert torch.equal(v, final[k]) and torch.equal(v, state.params[k])
        assert not torch.equal(v, extra["best_params"][k])
    # the dump is the best epoch's: the same as a model holding epoch 1's params
    at_best = bprmf_from_jax({k: v.numpy() for k, v in spy.seen[0].items()}, device="cpu")
    make(at_best).store_recommendation(None, None, str(tmp_path / "epoch1.tsv"))
    assert open(tmp_path / "best.tsv").read() == open(tmp_path / "epoch1.tsv").read()
