"""Port ``core/mesh.py`` and ``parallel/spmd.py`` (and the ``Trainer`` /
``fit`` mesh paths) vs the JAX package, on the CPU.

The JAX functions run in this process on a mesh of the same shape over 4
of conftest's 8 virtual CPU devices; the port's ranks run as fresh
interpreters over gloo (``tests/torch_mesh_ranks.py``, one spawn per mesh
shape for every scenario of this file), on the meshes (2, 1), (1, 2),
(2, 2) and (1, 4):

- ``collective_take`` on a 2-D and a 4-D table (batch == the image's W,
  the JAX regression): forward equal to JAX's and to the plain gather;
  backward (the masked local scatter of the replicated cotangent) equal to
  the single-device gradient — not multiplied by the model-axis size;
- BPRMF and VBPR train steps from JAX's init over the same batches (30
  items: padded rows on the 2- and 4-way model axes): losses rtol 1e-5
  against the JAX sharded run, params rtol 2e-4, atol 1e-6 against it and
  against JAX's single-device steps;
- the ``Trainer`` with ``cfg.mesh`` fed JAX's sampler draws for one epoch:
  the loss against JAX's ``make_spmd_epoch_fn`` on the same mesh and on
  one device (the JAX ``Trainer`` builds its mesh over all 8 devices), the
  params against the one-device run.  (JAX's own sharded run leaves its
  one-device run by 3.1e-5 on the (1, 2) mesh and 4.6e-5 on (1, 4) at one
  item bias whose gradients cancel, beyond rtol 2e-4; the port's stays
  within it);
- ``fit`` over the mesh with an evaluator and checkpoints against the
  port's single-device ``fit`` (the same seed draws the same global
  triples): losses rtol 1e-5, params rtol 2e-4, atol 1e-6, metrics those
  of ``tests/test_golden.py``, the same best epoch; the checkpoint is in
  the single-device layout and a resumed mesh run continues as a resumed
  single-device one;
- ``make_mesh``'s errors, ``pad_rows_to_multiple``, ``param_spec_tree``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_mesh_ranks as ranks
from fashionvisualexpl_tpu.core.mesh import make_mesh as jmake_mesh
from fashionvisualexpl_tpu.core.train_state import (
    apply_gradients as japply,
    create_train_state as jcreate,
    tf_parity_adam as jadam,
)
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.features import synthetic_features
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu.models.vbpr import VBPR as JVBPR
from fashionvisualexpl_tpu.parallel import spmd as jspmd
from fashionvisualexpl_tpu_torch.core.checkpoint import CheckpointManager
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.core.mesh import make_mesh
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.models.convert import bprmf_from_jax
from fashionvisualexpl_tpu_torch.parallel.spmd import pad_rows_to_multiple, param_spec_tree
from fashionvisualexpl_tpu_torch.train.trainer import fit

MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
STATE_TOL = dict(rtol=2e-4, atol=1e-6)
METRIC_TOL = dict(rtol=2e-3, atol=2e-4)
U, I, K = 24, 30, 8
DATA = {"U": U, "I": I, "ipu": 8, "seed": 0}
LR, REG = 0.01, 0.01
TRAIN = dict(batch_size=16, lr=0.05, reg=0.001, top_k=5, eval_every=1, verbose=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jmesh(shape):
    return jmake_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])


def _batches(n_steps, batch, seed):
    data = jsynth(U, I, interactions_per_user=8, seed=0)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        idx = rng.integers(0, data.num_train, batch)
        users, pos = data.train_pairs[idx, 0], data.train_pairs[idx, 1]
        neg = rng.integers(0, I, batch).astype(np.int32)
        for b in range(batch):
            while neg[b] in data.training_list[users[b]]:
                neg[b] = rng.integers(0, I)
        out.append((users, pos, neg))
    return out


def _jax_models():
    feats = synthetic_features(I, 12, seed=2)
    return {"bprmf": (JBPRMF(U, I, embed_k=K), {}),
            "vbpr": (JVBPR(U, I, feats, embed_k=K, embed_d=4), {"F": feats})}


def _jax_steps(jm, params, frozen, batches, mesh=None):
    """JAX's steps, single-device or sharded: (losses, params)."""
    tx = jadam(LR)
    if mesh is None:
        state = jcreate(params, tx)
        losses = []
        for u, p, n in batches:
            loss, grads = jax.value_and_grad(
                lambda prm: jm.loss(prm, frozen, jnp.asarray(u), jnp.asarray(p),
                                    jnp.asarray(n), REG))(state.params)
            state = japply(state, grads, tx)
            losses.append(float(loss))
        return np.array(losses), _np(state.params)
    sp, sf = jspmd.shard_params(jm, params, frozen, mesh)
    state = jcreate(sp, tx)
    step = jspmd.make_spmd_train_step(jm, mesh, tx, REG)
    losses = []
    for u, p, n in batches:
        state, loss = step(state, sf, jnp.asarray(u), jnp.asarray(p), jnp.asarray(n))
        losses.append(float(loss))
    return np.array(losses), _np(state.params)


@functools.lru_cache(maxsize=None)
def _jax_run(name, shape):
    """JAX's 4 steps of model ``name`` on the mesh ``shape`` (None: one
    device): (losses, params)."""
    jm, _ = _jax_models()[name]
    params, frozen = jm.init(jax.random.PRNGKey(1))
    return _jax_steps(jm, params, frozen, _batches(4, 16, seed=0),
                      None if shape is None else _jmesh(shape))


def _take_inputs():
    rng = np.random.default_rng(0)
    return dict(table2d=np.arange(64, dtype=np.float32).reshape(16, 4),
                ids2d=np.array([0, 3, 15, 7, 7, 12], np.int32),
                w2d=rng.normal(size=(6, 4)).astype(np.float32),
                table4d=rng.normal(size=(32, 8, 8, 1)).astype(np.float32),
                ids4d=rng.integers(0, 32, size=8).astype(np.int32),
                w4d=rng.normal(size=(8, 8, 8, 1)).astype(np.float32))


def _epoch_triples(shape, epochs):
    """JAX's sampler draws of the Trainer's epochs (key fold_in(3, e))."""
    jdata = jsynth(U, I, interactions_per_user=8, seed=0)
    steps = jdata.steps_per_epoch(16)
    out = {}
    for e in range(epochs):
        sample_key, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), e))
        t = jsampler.sample_triplets(sample_key, jnp.asarray(jdata.train_pairs),
                                     jnp.asarray(jdata.padded_pos),
                                     jnp.asarray(jdata.pos_counts), I, steps, 16,
                                     with_replacement="user_perm")
        for k, v in zip(("users", "pos", "neg"), t):
            out[f"t{e}.{k}"] = np.asarray(v)
    return out


_RUNS = {}


def _inputs(shape, wd):
    """Write every scenario of this file under ``wd``; returns their names."""
    ranks.write_inputs(wd, "take", **_take_inputs())
    batches = _batches(4, 16, seed=0)
    for name, (jm, frozen) in _jax_models().items():
        params = _np(jm.init(jax.random.PRNGKey(1))[0])
        arrays = {f"p.{k}": v for k, v in params.items()}
        arrays.update({f"f.{k}": v for k, v in frozen.items()})
        arrays.update(users=np.stack([b[0] for b in batches]),
                      pos=np.stack([b[1] for b in batches]),
                      neg=np.stack([b[2] for b in batches]))
        ranks.write_inputs(wd, f"{name}_steps", dict(fn="model_steps", model=name, lr=LR,
                                                     reg=REG, data=DATA), **arrays)
    params = _np(JBPRMF(U, I, embed_k=K).init(jax.random.PRNGKey(1))[0])
    ranks.write_inputs(
        wd, "trainer", dict(fn="trainer_steps", model="bprmf", epochs=1, data=DATA,
                            train=dict(batch_size=16, lr=LR, reg=REG)),
        **{f"p.{k}": v for k, v in params.items()}, **_epoch_triples(shape, 1))
    ranks.write_inputs(wd, "fit", dict(fn="fit_run", model="bprmf", epochs=2, seed=5,
                                       ckpt="ckpt", data=DATA, train=TRAIN),
                       **{f"p.{k}": v for k, v in params.items()})
    return ["take", "bprmf_steps", "vbpr_steps", "trainer", "fit"]


def _run(shape, tmp_path_factory):
    """Every mesh's ranks, spawned together once for this file."""
    if not _RUNS:
        jobs = {}
        for sh in MESHES:
            wd = str(tmp_path_factory.mktemp(f"spmd{sh[0]}x{sh[1]}"))
            jobs[sh] = (wd, _inputs(sh, wd))
        for sh, out in ranks.spawn_many(jobs).items():
            _RUNS[sh] = (jobs[sh][0], out)
    return _RUNS[shape]


@pytest.fixture(params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def run(request, tmp_path_factory):
    return request.param, *_run(request.param, tmp_path_factory)


def _same_on_every_rank(outs):
    for r in outs[1:]:
        for k in outs[0]:
            np.testing.assert_array_equal(r[k], outs[0][k], err_msg=k)


def test_collective_take_matches_jax(run):
    shape, _, out = run
    _same_on_every_rank(out["take"])
    got = out["take"][0]
    inp = _take_inputs()
    mesh = _jmesh(shape)
    take = jspmd.collective_take(("T",))
    for tag in ("2d", "4d"):
        table, ids, w = inp[f"table{tag}"], inp[f"ids{tag}"], inp[f"w{tag}"]
        pad = (-table.shape[0]) % shape[1]
        tspec = P("model", *([None] * (table.ndim - 1)))
        fn = shard_map(lambda t, i: take("T", t, i), mesh=mesh, in_specs=(tspec, P()),
                       out_specs=P(), check_vma=False)
        want = np.asarray(fn(jnp.asarray(np.pad(table, [(0, pad)] + [(0, 0)] * (table.ndim - 1))),
                             jnp.asarray(ids)))
        np.testing.assert_array_equal(got[f"fwd{tag}"], want)
        np.testing.assert_array_equal(got[f"fwd{tag}"], table[ids])
        grad = np.zeros_like(table)
        np.add.at(grad, ids, w)  # each row's gradient once, from its one owner
        np.testing.assert_allclose(got[f"grad{tag}"], grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["bprmf", "vbpr"])
def test_model_steps_match_jax_sharded_and_single_device(run, name):
    shape, _, out = run
    _same_on_every_rank(out[f"{name}_steps"])
    got = out[f"{name}_steps"][0]
    ref_l, ref_p = _jax_run(name, None)
    sh_l, sh_p = _jax_run(name, shape)
    np.testing.assert_allclose(got["losses"], sh_l, rtol=1e-5)
    np.testing.assert_allclose(got["losses"], ref_l, rtol=1e-5)
    for k, want in ref_p.items():
        np.testing.assert_allclose(got[f"p.{k}"], sh_p[k][: want.shape[0]], err_msg=k,
                                   **STATE_TOL)
        np.testing.assert_allclose(got[f"p.{k}"], want, err_msg=k, **STATE_TOL)


def test_trainer_with_mesh_matches_jax_epochs(run):
    shape, _, out = run
    got = out["trainer"][0]
    jm = JBPRMF(U, I, embed_k=K)
    params, frozen = jm.init(jax.random.PRNGKey(1))
    jdata = jsynth(U, I, interactions_per_user=8, seed=0)
    args = (jnp.asarray(jdata.train_pairs), jnp.asarray(jdata.padded_pos),
            jnp.asarray(jdata.pos_counts))
    key = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    want = {}
    for sh in (shape, (1, 1)):
        mesh, tx = _jmesh(sh), jadam(LR)
        epoch = jspmd.make_spmd_epoch_fn(jm, mesh, tx, REG, I, jdata.steps_per_epoch(16), 16)
        sp, sf = jspmd.shard_params(jm, params, frozen, mesh)
        state, loss = epoch(jcreate(sp, tx), sf, key, *args)
        want[sh] = float(loss), _np(state.params)
        np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-5)
    for k, v in want[(1, 1)][1].items():
        np.testing.assert_allclose(got[f"p.{k}"], v, err_msg=k, **STATE_TOL)


_FITS = {}


def _single_device_fits(params, tmp_path_factory):
    """The port's single-device fit, 2 epochs then resumed to 3."""
    if not _FITS:
        ckpt = str(tmp_path_factory.mktemp("fit_single"))
        for tag, epochs, resume in (("a", 2, False), ("b", 3, True)):
            _FITS[tag] = _single_device_fit(epochs, params, ckpt, resume)
    return _FITS


def _single_device_fit(epochs, params, ckpt, resume):
    model = bprmf_from_jax({k[2:]: v for k, v in params.items()}, device="cpu")
    data = synthetic_interactions(U, I, interactions_per_user=8, seed=0)
    cfg = TrainConfig(epochs=epochs, **TRAIN)
    ev = FactoredEvaluator(model, data, k=cfg.top_k, user_block=16)
    return fit(model, data, cfg, evaluator=ev, seed=5, ckpt_dir=ckpt, resume=resume)


def test_fit_over_mesh_matches_single_device_and_checkpoints(run, tmp_path_factory):
    shape, wd, out = run
    _same_on_every_rank(out["fit"])
    got = out["fit"][0]
    params = {f"p.{k}": v for k, v in
              _np(JBPRMF(U, I, embed_k=K).init(jax.random.PRNGKey(1))[0]).items()}
    for tag, (state, _, results, extra) in _single_device_fits(params,
                                                                tmp_path_factory).items():
        np.testing.assert_allclose(got[f"{tag}.losses"], [h.loss for h in extra["history"]],
                                   rtol=1e-5)
        assert int(got[f"{tag}.best_epoch"]) == extra["best_epoch"]
        want = np.array([[results[e][k] for k in sorted(results[e])] for e in sorted(results)])
        np.testing.assert_allclose(got[f"{tag}.metrics"], want, **METRIC_TOL)
        for k, v in state.params.items():
            np.testing.assert_allclose(got[f"{tag}.p.{k}"], v.detach().numpy(), err_msg=k,
                                       **STATE_TOL)
            np.testing.assert_allclose(got[f"{tag}.best.{k}"],
                                       extra["best_params"][k].numpy(), err_msg=k, **STATE_TOL)
        np.testing.assert_array_equal(got[f"{tag}.model_rows"], [I, U, I])
    # the primary's checkpoints are in the single-device layout
    model = BPRMF(U, I, embed_k=K, device="cpu")
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    trainer = Trainer(model, synthetic_interactions(U, I, interactions_per_user=8, seed=0),
                      TrainConfig(epochs=3, **TRAIN))
    template, _ = trainer.init_state()
    mgr = CheckpointManager(f"{wd}/ckpt")
    assert mgr.latest_step() == 3
    restored = mgr.restore(template)
    for k, v in restored.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), got[f"b.p.{k}"])
    best = mgr.restore_best({k: torch.zeros_like(v) for k, v in template.params.items()})
    for k, v in best.items():
        np.testing.assert_array_equal(v.numpy(), got[f"b.best.{k}"])


def test_make_mesh_errors_and_single_process_mesh():
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by model=3"):
        make_mesh(-1, 3, device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.is_primary
    assert mesh.axis_index("data") == mesh.axis_index("model") == 0
    with pytest.raises(ValueError, match="mesh 2x2 != 1 devices"):
        _trainer_with_mesh()


def _trainer_with_mesh():
    from fashionvisualexpl_tpu_torch.core.config import MeshConfig
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    data = synthetic_interactions(4, 4, interactions_per_user=2, seed=0)
    return Trainer(BPRMF(4, 4, embed_k=2, device="cpu"), data,
                   TrainConfig(batch_size=2, mesh=MeshConfig(data=2, model=2)))


def test_pad_rows_and_param_spec_tree():
    a = np.ones((10, 3))
    p = pad_rows_to_multiple(a, 4)
    assert p.shape == (12, 3) and p[10:].sum() == 0
    assert pad_rows_to_multiple(a, 5) is a
    t = pad_rows_to_multiple(torch.ones(10, 2, 2), 4)
    assert t.shape == (12, 2, 2) and float(t[10:].abs().sum()) == 0
    np.testing.assert_array_equal(p, jspmd.pad_rows_to_multiple(a, 4))
    model = BPRMF(4, 4, embed_k=2, device="cpu")
    spec = param_spec_tree(model, dict(model.named_parameters()))
    jspec = jspmd.param_spec_tree(JBPRMF(4, 4, embed_k=2), _np(JBPRMF(4, 4, embed_k=2).init(
        jax.random.PRNGKey(0))[0]))
    assert spec == {k: v != P(None) and v != P(None, None) for k, v in jspec.items()}
