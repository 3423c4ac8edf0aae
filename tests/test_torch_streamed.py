"""Port's streamed trainer (``train/streamed.py``), AttentiveFashion with
``host_features=True`` and the host pipeline (``data/pipeline.py``)
against the JAX package, on the CPU.

The 4 tests of ``tests/test_streamed.py`` are mirrored, each also against
the JAX function:
- ``loss_streamed`` against JAX's ``loss_streamed`` fed JAX's dropout masks,
  with grads (loss rtol 1e-5, grads rtol 1e-4, as
  ``test_torch_attentive_fashion.py``), and against the port's resident
  ``loss`` fed one generator: bit-equal;
- ``run_streamed_steps`` from JAX's init, fed the triples and dropout masks
  of JAX's ``fit_streamed`` (its first epoch, 3 steps; a numpy-only store,
  so JAX's native library is never built), against JAX's resulting params
  (rtol 2e-4, atol 1e-6) and loss (rtol 1e-5);
- host-features ``predict_all`` against JAX's (rtol 2e-5, atol 2e-5), the
  model without buffers (JAX's empty ``frozen``);
- ``fit_streamed`` end to end from arrays and from memmaps (finite metrics,
  the best epoch, the history; ``resume`` ends bit for bit where the
  uninterrupted run ends).
Also ``HostPrefetcher`` (order, depth, a worker error re-raised, exhausted
for good, as JAX's), ``StagingRing`` (a slot is handed out again only
once released) and ``build_edge_stack_npy`` bit-equal to JAX's on tiffs."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import features as jfeatures
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.data.pipeline import HostPrefetcher as JHostPrefetcher
from fashionvisualexpl_tpu.data.pipeline import build_edge_stack_npy as jbuild_stack
from fashionvisualexpl_tpu.data.sampler import derived_pairs_ok as jderived_ok
from fashionvisualexpl_tpu.data.sampler import sample_triplets as jsample
from fashionvisualexpl_tpu.models.attentive_fashion import AttentiveFashion as JAF
from fashionvisualexpl_tpu.train.streamed import fit_streamed as jfit_streamed
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.data.pipeline import (
    HostPrefetcher,
    StagingRing,
    build_edge_stack_npy,
    load_edge_image_stack,
)
from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator
from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
from fashionvisualexpl_tpu_torch.models.convert import (
    attentive_fashion_from_jax,
    flatten_params,
)
from fashionvisualexpl_tpu_torch.train.streamed import (
    ArrayFeatureStore,
    StreamedTrainer,
    fit_streamed,
)

K, HID, FILTERS, ATT = 6, 8, 4, (4, 1)
MODEL_KW = dict(embed_k=K, attention_layers=ATT, encoder_hidden=HID, conv_filters=FILTERS,
                item_block=5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(I, seed):
    rng = np.random.default_rng(seed)
    color = jfeatures.synthetic_features(I, 8, seed=seed)
    edges = rng.random((I, 8, 8, 1)).astype(np.float32)
    cls = np.eye(4, dtype=np.float32)[rng.integers(0, 4, I)]
    return color, edges, cls


def _setup(seed=0, **kw):
    """(port data, inputs, JAX host model, its params, port host model on
    the same weights) — ``tests/test_streamed.py``'s sizes."""
    data = synthetic_interactions(15, 12, interactions_per_user=5, seed=seed)
    inputs = _inputs(data.num_items, seed)
    jm = JAF(data.num_users, data.num_items, *inputs, host_features=True, **MODEL_KW, **kw)
    params, frozen = jm.init(jax.random.PRNGKey(seed))
    assert frozen == {}
    pm = attentive_fashion_from_jax(jm, _np(params), frozen, "cpu")
    return data, inputs, jm, params, pm


def _jax_masks(jm, key, B):
    """JAX's keep-masks of ``loss_streamed(rng=key)`` in the port's order:
    positives then negatives, each color, edges, class."""
    keep = 1.0 - jm.dropout_rate
    return [torch.from_numpy(np.array(jax.random.bernoulli(k, keep, (B, w))))
            for r in jax.random.split(key)
            for k, w in zip(jax.random.split(r, 3), (HID, FILTERS, HID))]


def _feats(store, pos, neg):
    return {k: torch.from_numpy(v) for k, v in store.gather(pos, neg).items()}


class NumpyStore:
    """A store with ``.gather`` by ``src[ids]`` only: JAX's ``fit_streamed``
    needs nothing more, and JAX's own store would build its native
    library."""

    def __init__(self, color, edges, cls):
        self.color, self.edges, self.cls = color, edges, cls

    def gather(self, pos, neg):
        return {f"{k}_{side}": src[ids] for side, ids in (("pos", pos), ("neg", neg))
                for k, src in (("col", self.color), ("img", self.edges), ("cls", self.cls))}


def test_host_features_model_has_no_buffers():
    data, (color, edges, cls), jm, _, pm = _setup()
    assert pm.host_features and dict(pm.named_buffers()) == {}
    assert pm._edges is jm._edges or np.array_equal(pm._edges, edges)
    resident = AttentiveFashion(data.num_users, data.num_items, color, edges, cls,
                                device="cpu", **MODEL_KW)
    assert sorted(dict(resident.named_buffers())) == ["Fc", "Fcls", "Fe_img"]
    assert sorted(dict(pm.named_parameters())) == sorted(dict(resident.named_parameters()))


@pytest.mark.parametrize("dropout", [True, False], ids=["jax-masks", "no-dropout"])
def test_loss_streamed_matches_jax(dropout):
    data, inputs, jm, params, pm = _setup()
    u, p, n = (np.asarray(v, np.int32) for v in ([0, 3, 14], [1, 5, 11], [2, 7, 0]))
    key = jax.random.PRNGKey(9)
    jfeats = {k: jnp.asarray(v) for k, v in NumpyStore(*inputs).gather(p, n).items()}
    jl, jg = jax.value_and_grad(lambda pp: jm.loss_streamed(
        pp, jnp.asarray(u), jnp.asarray(p), jnp.asarray(n), jfeats, 0.01,
        rng=key if dropout else None))(params)
    # the JAX package's own check: the streamed loss is the resident one
    jres = JAF(data.num_users, data.num_items, *inputs, **MODEL_KW)
    _, jfrozen = jres.init(jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(jl), float(jres.loss(
        params, jfrozen, *map(jnp.asarray, (u, p, n)), 0.01, rng=key if dropout else None)),
        rtol=1e-5)
    store = ArrayFeatureStore(*inputs)
    loss = pm.loss_streamed(*(torch.from_numpy(v).long() for v in (u, p, n)),
                            _feats(store, p, n), 0.01,
                            rng=_jax_masks(jm, key, len(u)) if dropout else None)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=1e-7)
    names = [k for k, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, list(pm.parameters()))
    jg = flatten_params(_np(jg))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], rtol=1e-4, atol=1e-7, err_msg=name)


def test_loss_streamed_equals_resident_loss_bit_for_bit():
    """The same rows and one generator seed: ``loss_streamed`` of the host
    model equals the resident model's ``loss``, value and grads."""
    data, inputs, _, _, pm = _setup(seed=1)
    resident = AttentiveFashion(data.num_users, data.num_items, *inputs, device="cpu",
                                **MODEL_KW)
    resident.load_state_dict(pm.state_dict(), strict=False)
    u, p, n = (torch.tensor(v) for v in ([0, 3, 14, 7], [1, 5, 11, 2], [2, 7, 0, 2]))
    feats = _feats(ArrayFeatureStore(*inputs), p.numpy(), n.numpy())
    out = []
    for loss_fn, model in ((lambda m, g: m.loss_streamed(u, p, n, feats, 0.01, rng=g), pm),
                           (lambda m, g: m.loss(u, p, n, 0.01, rng=g), resident)):
        loss = loss_fn(model, torch.Generator().manual_seed(4))
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (ls, gs), (lr, gr) = out
    assert torch.equal(ls, lr)
    for a, b in zip(gs, gr):
        assert torch.equal(a, b)
    # the host model's own loss copies the same rows from the host
    assert torch.equal(pm.loss(u, p, n, 0.01, rng=torch.Generator().manual_seed(4)), ls)


def test_run_streamed_steps_match_jax_fit_streamed():
    """JAX's ``fit_streamed`` over one epoch of 3 steps with dropout, and
    the port's ``run_streamed_steps`` from JAX's init fed that epoch's
    triples and each step's dropout masks."""
    data, inputs, jm, params, pm = _setup(seed=2)
    batch = data.num_train // 3
    jdata = jsynth(15, 12, interactions_per_user=5, seed=2)
    jcfg = JTrainConfig(batch_size=batch, epochs=1, lr=0.01, reg=0.001, seed=2)
    jstate, jfrozen, _, extra = jfit_streamed(jm, jdata, jcfg, NumpyStore(*inputs))
    assert jfrozen == {}
    # the epoch's triples and masks as JAX's fit_streamed draws them
    ekey = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed + 1), 1)
    pairs = None if jderived_ok(jdata.train_pairs, jdata.padded_pos) \
        else jnp.asarray(jdata.train_pairs)
    triples = jsample(ekey, pairs, jnp.asarray(jdata.padded_pos),
                      jnp.asarray(jdata.pos_counts), jdata.num_items, 3, batch)
    masks = [_jax_masks(jm, jax.random.fold_in(ekey, 1000 + s), batch) for s in range(3)]
    trainer = StreamedTrainer(pm, data, TrainConfig(batch_size=batch, lr=0.01, reg=0.001),
                              ArrayFeatureStore(*inputs))
    assert trainer.steps_per_epoch == 3
    state, _ = trainer.init_state()  # the params carried across from JAX
    state, loss = trainer.run_streamed_steps(
        state, tuple(torch.from_numpy(np.array(t)) for t in triples), trainer.store, masks)
    np.testing.assert_allclose(float(loss), extra["history"][0]["loss"], rtol=1e-5)
    jflat = flatten_params(_np(jstate.params))
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[name], rtol=2e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("batch_eval", [None, 7], ids=["item-block", "batch-eval-7"])
def test_host_features_predict_all_matches_jax(batch_eval):
    data, inputs, jm, params, pm = _setup(seed=2, batch_eval=batch_eval)
    want = np.asarray(jm.predict_all(params, {}))
    np.testing.assert_allclose(pm.predict_all().numpy(), want, rtol=2e-5, atol=2e-5)
    resident = AttentiveFashion(data.num_users, data.num_items, *inputs, device="cpu",
                                batch_eval=batch_eval, **MODEL_KW)
    resident.load_state_dict(pm.state_dict(), strict=False)
    np.testing.assert_allclose(pm.precompute_eval().numpy(),
                               resident.precompute_eval().numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pm.predict_all().numpy(), resident.predict_all().numpy(),
                               rtol=2e-5, atol=2e-5)


def _host_model(data, store):
    return AttentiveFashion(data.num_users, data.num_items, store.color, store.edges,
                            store.cls, host_features=True, device="cpu", **MODEL_KW)


def test_fit_streamed_end_to_end():
    data = synthetic_interactions(15, 12, interactions_per_user=5, seed=1)
    store = ArrayFeatureStore(*_inputs(data.num_items, 1))
    cfg = TrainConfig(batch_size=8, epochs=3, lr=0.01, reg=0.0001, top_k=4, eval_every=3)
    logs = []
    model = _host_model(data, store)
    state, frozen, results, extra = fit_streamed(
        model, data, cfg, store, evaluator=Evaluator(model, data, k=4, user_block=8),
        log=logs.append)
    assert frozen == {}
    assert np.isfinite(results[3]["auc_t"])
    assert extra["best_epoch"] == 3 and len(extra["history"]) == 3
    assert [r["epoch"] for r in logs] == [1, 2, 3] and np.isfinite([r["loss"] for r in logs]).all()
    # the same seed gives the same run; another seed another
    again = []
    fit_streamed(_host_model(data, store), data, cfg, store, log=again.append)
    assert [r["loss"] for r in again] == [r["loss"] for r in logs]
    other = []
    fit_streamed(_host_model(data, store), data,
                 TrainConfig(batch_size=8, epochs=3, lr=0.01, reg=0.0001, seed=1), store,
                 log=other.append)
    assert [r["loss"] for r in other] != [r["loss"] for r in logs]


def test_fit_streamed_host_features_memmap_and_resume(tmp_path):
    """Memmap-backed inputs, an empty frozen, dense evaluation; a run cut
    after 2 epochs and resumed ends bit for bit where 3 epochs end."""
    data = synthetic_interactions(15, 12, interactions_per_user=5, seed=3)
    paths = []
    for name, arr in zip(("color", "edges", "cls"), _inputs(data.num_items, 3)):
        np.save(tmp_path / f"{name}.npy", arr)
        paths.append(str(tmp_path / f"{name}.npy"))
    store = ArrayFeatureStore.from_memmap(*paths)
    assert isinstance(store.edges, np.memmap)

    def run(epochs, ckpt=None, resume=False):
        model = _host_model(data, store)
        assert np.shares_memory(model._edges, store.edges)  # a view, never loaded
        cfg = TrainConfig(batch_size=8, epochs=epochs, lr=0.01, reg=0.0001, top_k=4,
                          eval_every=1, verbose=1)
        return fit_streamed(model, data, cfg, store,
                            evaluator=Evaluator(model, data, k=4, user_block=8),
                            ckpt_dir=ckpt, resume=resume)

    state, frozen, results, _ = run(3)
    assert frozen == {} and sorted(results) == [1, 2, 3]
    assert all(np.isfinite(v) for m in results.values() for v in m.values())
    ck = str(tmp_path / "ck")
    run(2, ck)
    rstate, _, rresults, _ = run(3, ck, resume=True)
    assert sorted(rresults) == [3]
    for name, p in state.params.items():
        assert torch.equal(rstate.params[name], p), name
    assert rresults[3] == results[3]


def test_streamed_trainer_takes_the_generic_path_only():
    data = synthetic_interactions(15, 12, interactions_per_user=5, seed=0)
    store = ArrayFeatureStore(*_inputs(data.num_items, 0))
    with pytest.raises(ValueError, match="generic"):
        StreamedTrainer(_host_model(data, store), data,
                        TrainConfig(batch_size=8, train_path="packed"), store)


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_host_prefetcher_order_depth_errors_exhaustion(impl):
    cls = HostPrefetcher if impl == "port" else JHostPrefetcher
    assert [b for b in cls(iter(range(7)), lambda i: i * i, depth=2)] == [
        (i, i * i) for i in range(7)]
    # depth: beside the batch the consumer holds, the worker has gathered
    # the depth queued ones and the one it waits to queue, never more
    gathered, ahead = [], []
    pf = cls(iter(range(8)), lambda i: gathered.append(i) or i, depth=2)
    for i, _ in pf:
        time.sleep(0.05)
        ahead.append(len(gathered) - 1 - i)
    assert max(ahead) == 3
    # a worker error reaches the consumer; afterwards the iterator stays done

    def boom(i):
        if i == 2:
            raise KeyError("bad batch")
        return i

    pf = cls(iter(range(5)), boom, depth=2)
    assert [next(pf), next(pf)] == [(0, 0), (1, 1)]
    with pytest.raises(RuntimeError, match="worker failed") as err:
        next(pf)
    assert isinstance(err.value.__cause__, KeyError)
    for _ in range(3):
        with pytest.raises((RuntimeError, StopIteration)):
            next(pf)
    done = cls(iter(range(1)), lambda i: i)
    assert list(done) == [(0, 0)]
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(done)


def test_staging_ring_hands_a_slot_out_again_only_once_released():
    ring = StagingRing(2, {"x": (3, 2)}, "cpu")
    a, b = ring.acquire(), ring.acquire()
    assert (a, b) == (0, 1)
    ring.views[a]["x"][:] = 1.0
    got = []
    waiter = threading.Thread(target=lambda: got.append(ring.acquire()))
    waiter.start()
    waiter.join(timeout=0.2)
    assert waiter.is_alive() and got == []  # slot 0 is still held
    out = ring.to_device(a)
    waiter.join(timeout=10)
    assert not waiter.is_alive() and got == [0]
    ring.views[0]["x"][:] = 2.0  # the copy out is the slot's state when copied
    assert torch.equal(out["x"], torch.ones(3, 2))


def test_build_edge_stack_npy_bit_equal_to_jax(tmp_path):
    from fashionvisualexpl_tpu.data.synthetic_dataset import make_synthetic_dataset_on_disk
    from fashionvisualexpl_tpu_torch.core.config import Paths

    root = str(tmp_path / "data")
    make_synthetic_dataset_on_disk(root, num_users=6, num_items=9, interactions_per_user=3,
                                   edge_hw=(20, 16), with_images=True)
    edges_dir = Paths(root=root).edges_dir("synthetic")
    for hw in ((20, 16), (8, 12)):
        ours, theirs = str(tmp_path / f"p{hw}.npy"), str(tmp_path / f"j{hw}.npy")
        build_edge_stack_npy(edges_dir, ours, 9, hw=hw)
        jbuild_stack(edges_dir, theirs, 9, hw=hw)
        got = np.load(ours, mmap_mode="r")
        assert got.dtype == np.float32 and got.shape == (9, *hw, 1)
        np.testing.assert_array_equal(got, np.load(theirs))
        np.testing.assert_array_equal(got, load_edge_image_stack(edges_dir, 9, hw=hw))
