"""Port ``parallel/fast_spmd.py`` (the generic packed engine over a mesh:
K4 row reads, K5 row writes, their plain versions on the CPU) and the
packed ``Trainer`` / ``fit`` mesh paths vs the JAX package and the port's
single-device engine, on the CPU.

The JAX functions run in this process on a mesh of the same shape over 4
of conftest's 8 virtual CPU devices; the port's ranks run as fresh
interpreters over gloo (``tests/torch_mesh_ranks.py``, one spawn per mesh
shape for every scenario of this file), on the meshes (2, 1), (1, 2),
(2, 2) and (1, 4) for BPRMF and the sampler and refusal cases, (2, 2) and
(1, 4) for the other models (every mesh's ranks started together), 30
items (padded rows on the 4-way model axis):

- the packed ``Trainer`` over the mesh from JAX's packed init, fed JAX's
  sampler draws for one epoch, against JAX's
  ``make_generic_packed_spmd_epoch_fn`` on the same mesh and the JAX
  single-device packed epoch: BPRMF with fp32 moments (plain LazyAdam,
  row_align 1) and bf16 moments (catch-up, row_align 128), ACF (its extra
  item rows), AttentiveFashion without dropout (as the JAX test runs it):
  losses rtol 1e-5; params rtol 2e-4, atol 1e-6; the tau columns
  bit-equal; the row_align pad columns and the pad rows zero;
- CompVBPR (its CNN as a dense group, four frozen families read by id
  through ``collective_take``, CNN dropout off) against the port's
  single-device packed steps on the same triples: losses rtol 1e-5, the
  row tables rtol 2e-4, atol 1e-6 (the JAX sharded CompVBPR test is a
  slow one);
- AttentiveFashion with ``compute_dtype="bfloat16"`` (K7's bf16 plain
  version) over the (1, 2) mesh against the port's single-device packed
  epoch on the same triples: losses rtol 1e-5, every param f32, the row
  tables rtol 2e-4, atol 1e-6, the encoders' and the attention's within
  0.01 lr a step (their bf16 gradients sum in another order over the
  mesh: one of conv_W's 1600 entries parts by 2.8e-5 after an epoch);
- CompVBPR with ``compute_dtype="bfloat16"`` (the bf16 CNN as a dense
  group, dropout off) over the (1, 2) mesh against the port's
  single-device packed epoch: losses rtol 1e-5, every param f32 and
  within rtol 2e-4, atol 1e-6, the CNN's included;
- ``make_generic_packed_spmd_epoch_fn`` with the pair list and derived
  from ``padded_pos``: bit-equal;
- ``fit(train_path="packed")`` of VBPR over the mesh against the port's
  single-device packed ``fit`` (frozen F read by id): losses, metrics,
  params;
- float8 moments and a batch that does not split over ``data`` refused;
- BPRMF's specialized engines (``make_fast_spmd_step``: sparse Adam, one
  K6 sweep a table, plain on the CPU; ``make_packed_spmd_step``: 1-D tau)
  over every mesh, on 32 items (their rows must divide the model axis):
  fed JAX's triples against JAX's ``make_fast_spmd_epoch_fn`` /
  ``make_packed_spmd_epoch_fn`` on the same mesh, and their own epochs
  against the port's single-device epochs (``make_fast_epoch_fn`` with
  ``fused_adam=True``, ``make_packed_epoch_fn``) on the same draws:
  losses rtol 1e-5, tables (and moments) rtol 2e-4, atol 1e-6, tau
  bit-equal; a batch off the data axis and rows off the model axis
  refused."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
import torch_mesh_scenarios as scenarios
from fashionvisualexpl_tpu.core.mesh import make_mesh as jmake_mesh
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.features import synthetic_features
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.models.acf import ACF as JACF
from fashionvisualexpl_tpu.models.attentive_fashion import AttentiveFashion as JAF
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu.models.comp_vbpr import CompVBPR as JCompVBPR
from fashionvisualexpl_tpu.models.vbpr import VBPR as JVBPR
from fashionvisualexpl_tpu.parallel import fast_spmd as jfs
from fashionvisualexpl_tpu.train import packed_generic as jpg
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
from fashionvisualexpl_tpu_torch.models.convert import comp_vbpr_from_jax, vbpr_from_jax
from fashionvisualexpl_tpu_torch.train.packed_generic import infer_moment_dtype
from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fit

MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
STATE_TOL = dict(rtol=2e-4, atol=1e-6)
METRIC_TOL = dict(rtol=2e-3, atol=2e-4)
U, I, K, B = 24, 30, 8, 16
DATA = {"U": U, "I": I, "ipu": 8, "seed": 0}
LR, REG = 0.01, 0.01
# (label, model, moment dtype, catch-up, row_align)
CASES = [("bprmf_fp32", "bprmf", "float32", False, 1),
         ("bprmf_bf16", "bprmf", "bfloat16", True, 128),
         ("acf", "acf", "float32", True, 1),
         ("attentive_fashion", "attentive_fashion", "float32", False, 1)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jmesh(shape):
    return jmake_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])


def _jax_model(kind):
    """(JAX model, its frozen inputs for the port as f.* arrays, the port's
    model kwargs)."""
    if kind == "bprmf":
        return JBPRMF(U, I, embed_k=K), {}, {}
    if kind == "acf":
        spat = np.random.default_rng(7).normal(size=(I, 3, 5)).astype(np.float32)
        kw = dict(max_user_pos=5)
        return (JACF(U, I, spat, jsynth(U, I, interactions_per_user=8, seed=0), embed_k=K,
                     layers_component=(4, 1), layers_item=(4, 1), **kw), {"Fspat": spat}, kw)
    if kind == "attentive_fashion":
        rng = np.random.default_rng(5)
        color, edges = synthetic_features(I, 7, seed=1), rng.random((I, 8, 8, 1)).astype(np.float32)
        cls = np.eye(5, dtype=np.float32)[rng.integers(0, 5, I)]
        jm = JAF(U, I, color, edges, cls, embed_k=K, attention_layers=(4, 1),
                 encoder_hidden=8, dropout_rate=0.0)
        kw = {a: getattr(jm, a) for a in ("num_users", "num_items", "embed_k", "encoder_hidden",
                                          "dropout_rate", "conv_filters", "item_block",
                                          "batch_eval", "edge_tower")}
        kw["attention_layers"] = list(jm.attention_layers)
        return jm, {"Fc": color, "Fe_img": edges, "Fcls": cls}, kw
    raise ValueError(kind)


def _flat(params, prefix=""):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _triples(epoch_key, steps, n_items=I):
    jdata = jsynth(U, n_items, interactions_per_user=8, seed=0)
    sample_key, _ = jax.random.split(epoch_key)
    t = jsampler.sample_triplets(sample_key, jnp.asarray(jdata.train_pairs),
                                 jnp.asarray(jdata.padded_pos), jnp.asarray(jdata.pos_counts),
                                 n_items, steps, B, with_replacement=False)
    return dict(zip(("users", "pos", "neg"), map(np.asarray, t)))


def _comp_model():
    rng = np.random.default_rng(9)
    feats = dict(Fs=synthetic_features(I, 6, seed=1), Fc=synthetic_features(I, 7, seed=2),
                 Fe_img=rng.random((I, 8, 8, 1)).astype(np.float32),
                 Ft=synthetic_features(I, 5, seed=3))
    jm = JCompVBPR(U, I, feats["Fs"], feats["Fc"], feats["Fe_img"], feats["Ft"], embed_k=K,
                   embed_d=4)
    return jm, feats


STEPS = jsynth(U, I, interactions_per_user=8, seed=0).steps_per_epoch(B)
# BPRMF's specialized engines shard without padding: 32 items divide every
# model axis
SPEC_I, SPEC_KEY = 32, 100
SPEC_DATA = dict(DATA, I=SPEC_I)
SPEC_STEPS = jsynth(U, SPEC_I, interactions_per_user=8, seed=0).steps_per_epoch(B)
KEY = jax.random.PRNGKey(0)
# the model cases on every mesh cost the most: BPRMF runs on all four, the
# others on the two meshes with a 2- and a 4-way model axis
HEAVY_MESHES = [(2, 2), (1, 4)]
COMBOS = [(shape, c) for c in CASES for shape in (MESHES if c[1] == "bprmf" else HEAVY_MESHES)]
_RUNS = {}


def _inputs(shape, wd):
    """Write the scenarios of ``shape`` under ``wd``; returns their names."""
    tri = _triples(KEY, STEPS)
    names = []
    for label, kind, md, catchup, align in CASES:
        if kind != "bprmf" and shape not in HEAVY_MESHES:
            continue
        jm, frozen, kw = _jax_model(kind)
        params = _flat(jm.init(jax.random.PRNGKey(1))[0])
        arrays = {f"p.{k}": v for k, v in params.items()}
        arrays.update({f"f.{k}": v for k, v in frozen.items()})
        arrays.update({f"t0.{k}": v for k, v in tri.items()})
        ranks.write_inputs(wd, label, dict(
            fn="trainer_steps", model=kind, model_kw=kw, epochs=1, data=DATA,
            train=dict(batch_size=B, lr=LR, reg=REG, train_path="packed", moment_dtype=md,
                       lazy_catchup=catchup, row_align=align)), **arrays)
        names.append(label)
    bparams = _flat(JBPRMF(U, I, embed_k=K).init(jax.random.PRNGKey(1))[0])
    for label, derived in (("pairs", False), ("derived", True)):
        ranks.write_inputs(wd, label, dict(fn="packed_epochs", model="bprmf", epochs=2,
                                           data=dict(U=U, I=I, ipu=7, seed=29, uniform=True),
                                           batch=B, moment_dtype="float32", derived=derived),
                           **{f"p.{k}": v for k, v in bparams.items()})
    ranks.write_inputs(wd, "refusals", dict(fn="packed_refusals", model="bprmf", data=DATA),
                       **{f"p.{k}": v for k, v in bparams.items()})
    names += ["pairs", "derived", "refusals"]
    sparams = _flat(JBPRMF(U, SPEC_I, embed_k=K).init(jax.random.PRNGKey(1))[0])
    ranks.write_inputs(wd, "specialized", dict(
        fn="specialized_engines", model="bprmf", data=SPEC_DATA, lr=LR, reg=REG, batch=B,
        key=SPEC_KEY), **{f"p.{k}": v for k, v in sparams.items()},
        **{f"t0.{k}": v for k, v in _triples(KEY, SPEC_STEPS, SPEC_I).items()})
    names.append("specialized")
    if shape == BF16_MESH:
        cfg, arrays = _bf16_case()
        ranks.write_inputs(wd, "attentive_fashion_bf16", cfg, **arrays)
        cfg, arrays = _bf16_comp_case()
        ranks.write_inputs(wd, "comp_vbpr_bf16", cfg, **arrays)
        names += ["attentive_fashion_bf16", "comp_vbpr_bf16"]
    if shape in HEAVY_MESHES:
        jm, feats = _comp_model()
        params = _flat(jm.init(jax.random.PRNGKey(1))[0])
        ranks.write_inputs(wd, "comp_vbpr", dict(
            fn="trainer_steps", model="comp_vbpr", epochs=1, data=DATA, cnn_dropout=0.0,
            train=dict(batch_size=B, lr=LR, reg=REG, train_path="packed")),
            **{f"p.{k}": v for k, v in params.items()},
            **{f"f.{k}": v for k, v in feats.items()}, **{f"t0.{k}": v for k, v in tri.items()})
        vparams, feats_v = _vbpr_params()
        ranks.write_inputs(wd, "fit_vbpr", dict(fn="fit_run", model="vbpr", epochs=2, seed=5,
                                                ckpt="ckpt", data=DATA, train=FIT_TRAIN),
                           **{f"p.{k}": v for k, v in vparams.items()}, **{"f.F": feats_v})
        names += ["comp_vbpr", "fit_vbpr"]
    return names


BF16_MESH = (1, 2)


def _bf16_case():
    """(config, arrays) of the bf16 AttentiveFashion packed epoch: JAX's
    init (its compute dtype carried by ``model_kw``), JAX's triples."""
    tri = {f"t0.{k}": v for k, v in _triples(KEY, STEPS).items()}
    train = dict(batch_size=B, lr=LR, reg=REG, train_path="packed")
    jm, frozen, kw = _jax_model("attentive_fashion")
    arrays = {f"p.{k}": v for k, v in _flat(jm.init(jax.random.PRNGKey(1))[0]).items()}
    arrays.update({f"f.{k}": v for k, v in frozen.items()}, **tri)
    return dict(fn="trainer_steps", model="attentive_fashion", epochs=1, data=DATA,
                train=train, model_kw=dict(kw, compute_dtype="bfloat16")), arrays


def _bf16_comp_case():
    """(config, arrays) of the bf16 CompVBPR packed epoch (the CNN's
    dropout off): JAX's f32 init, JAX's triples."""
    jm, feats = _comp_model()
    arrays = {f"p.{k}": v for k, v in _flat(jm.init(jax.random.PRNGKey(1))[0]).items()}
    arrays.update({f"f.{k}": v for k, v in feats.items()},
                  **{f"t0.{k}": v for k, v in _triples(KEY, STEPS).items()})
    return dict(fn="trainer_steps", model="comp_vbpr", epochs=1, data=DATA, cnn_dropout=0.0,
                train=dict(batch_size=B, lr=LR, reg=REG, train_path="packed"),
                model_kw=dict(compute_dtype="bfloat16")), arrays


def _run(shape, tmp_path_factory):
    """Every mesh's ranks, spawned together once for this file."""
    if not _RUNS:
        jobs = {}
        for sh in MESHES:
            wd = str(tmp_path_factory.mktemp(f"fastspmd{sh[0]}x{sh[1]}"))
            jobs[sh] = (wd, _inputs(sh, wd))
        for sh, out in ranks.spawn_many(jobs).items():
            _RUNS[sh] = (jobs[sh][0], out)
    return (shape, *_RUNS[shape])


FIT_TRAIN = dict(batch_size=B, lr=0.05, reg=0.001, top_k=5, eval_every=1, verbose=1,
                 train_path="packed", fused_frozen=False)


def _vbpr_params():
    feats = synthetic_features(I, 12, seed=1)
    return _flat(JVBPR(U, I, feats, embed_k=K, embed_d=4).init(jax.random.PRNGKey(2))[0]), feats


def _id(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(params=MESHES, ids=_id)
def run(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@pytest.fixture(params=HEAVY_MESHES, ids=_id)
def heavy_run(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@functools.lru_cache(maxsize=None)
def _jax_result(label, shape):
    """(loss, params, user_pmv, item_pmv) of JAX's packed epoch for the case
    ``label`` on the mesh ``shape`` (None: one device)."""
    _, kind, md, catchup, align = next(c for c in CASES if c[0] == label)
    jm, _, _ = _jax_model(kind)
    frozen = jm.init(jax.random.PRNGKey(1))[1]
    loss, state = _jax_epoch(jm, frozen, None if shape is None else _jmesh(shape), md,
                             catchup, align)
    params = _flat(jpg.unpack_generic_params(state, jm.packed_spec(), md))
    return loss, params, np.asarray(state.user_pmv), np.asarray(state.item_pmv)


def _jax_epoch(jm, frozen, mesh, md, catchup, align):
    """JAX's packed state after one epoch from key KEY: (loss, state)."""
    jdata = jsynth(U, I, interactions_per_user=8, seed=0)
    args = (jnp.asarray(jdata.train_pairs), jnp.asarray(jdata.padded_pos),
            jnp.asarray(jdata.pos_counts))
    params = jm.init(jax.random.PRNGKey(1))[0]
    state = jpg.pack_generic_state(jm, params, moment_dtype=md, row_align=align)
    if mesh is None:
        ep = jpg.make_generic_packed_epoch_fn(jm, LR, REG, I, STEPS, B, with_replacement=False,
                                              moment_dtype=md, lazy_catchup=catchup)
        state, loss = ep(state, frozen, KEY, *args)
    else:
        from fashionvisualexpl_tpu.parallel.spmd import shard_params

        _, fsh = shard_params(jm, params, frozen, mesh)
        ep = jfs.make_generic_packed_spmd_epoch_fn(jm, mesh, LR, REG, I, STEPS, B,
                                                   moment_dtype=md, lazy_catchup=catchup)
        state, loss = ep(jfs.shard_generic_packed_state(state, mesh), fsh, KEY, *args)
    return float(loss), _np(state)


@pytest.mark.parametrize("shape,case", COMBOS, ids=[f"{_id(s)}-{c[0]}" for s, c in COMBOS])
def test_packed_trainer_over_mesh_matches_jax(shape, case, tmp_path_factory):
    _, _, out = _run(shape, tmp_path_factory)
    label, kind, md, _, _ = case
    got = out[label][0]
    for r in out[label][1:]:
        np.testing.assert_array_equal(r["user_pmv"], got["user_pmv"])
    spec = _jax_model(kind)[0].packed_spec()
    for sh in (shape, None):
        loss, params, user_pmv, item_pmv = _jax_result(label, sh)
        np.testing.assert_allclose(got["losses"][0], loss, rtol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(got[f"p.{k}"], v[: got[f"p.{k}"].shape[0]], err_msg=k,
                                       **STATE_TOL)
        for name, want, tables, nS in (
                ("user_pmv", user_pmv[:U], spec.user_tables, 0),
                ("item_pmv", item_pmv[:I], spec.item_tables, len(spec.item_scalars))):
            tau = (3 if md == "float32" else 2) * (sum(w for _, w in tables) + nS)
            np.testing.assert_array_equal(got[name][:, tau], want[:, tau], err_msg=f"{name} tau")
            assert not got[name][:, tau + 1:].any(), "row_align pad columns touched"
    # 30 items over the model axis: every shard holds the same padded height
    assert got["shard_rows"][1] == -(-I // shape[1])


@functools.lru_cache(maxsize=None)
def _single_comp():
    """The port's single-device packed CompVBPR epoch: (loss, params)."""
    jm, feats = _comp_model()
    model = comp_vbpr_from_jax(_flat(jm.init(jax.random.PRNGKey(1))[0]), feats["Fs"],
                               feats["Fc"], feats["Fe_img"], feats["Ft"], device="cpu")
    model.cnn.dropout_rate = 0.0
    trainer = Trainer(model, synthetic_interactions(U, I, interactions_per_user=8, seed=0),
                      TrainConfig(batch_size=B, lr=LR, reg=REG, train_path="packed"))
    state, frozen = trainer.init_state()
    tri = _triples(KEY, STEPS)
    state, loss = trainer.run_steps(state, frozen, tuple(torch.tensor(tri[k]) for k in
                                                         ("users", "pos", "neg")), step_key=0)
    return float(loss), {k: v.numpy() for k, v in state.params.items()}


def test_comp_vbpr_packed_over_mesh_matches_single_device(heavy_run):
    _, _, out = heavy_run
    got = out["comp_vbpr"][0]
    loss, params = _single_comp()
    np.testing.assert_allclose(got["losses"][0], loss, rtol=1e-5)
    for k, v in params.items():
        if v.ndim and v.shape[0] in (U, I):
            np.testing.assert_allclose(got[f"p.{k}"], v, err_msg=k, **STATE_TOL)


def test_bf16_attentive_fashion_over_mesh_matches_single_device(tmp_path_factory):
    _, _, out = _run(BF16_MESH, tmp_path_factory)
    got = out["attentive_fashion_bf16"][0]
    for r in out["attentive_fashion_bf16"][1:]:
        np.testing.assert_array_equal(r["losses"], got["losses"])
    cfg, arrays = _bf16_case()
    model = scenarios.build_model(cfg, arrays)
    assert model.compute_dtype == torch.bfloat16
    trainer = Trainer(model, synthetic_interactions(U, I, interactions_per_user=8, seed=0),
                      TrainConfig(**cfg["train"]))
    state, frozen = trainer.init_state()
    state, loss = trainer.run_steps(state, frozen, tuple(torch.tensor(arrays[f"t0.{k}"])
                                                         for k in ("users", "pos", "neg")),
                                    step_key=0)
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-5)
    for k, v in state.params.items():
        assert v.dtype == torch.float32, k
        if "." in k:  # see the module docstring
            np.testing.assert_allclose(got[f"p.{k}"], v.numpy(), rtol=0,
                                       atol=0.01 * LR * STEPS, err_msg=k)
        else:
            np.testing.assert_allclose(got[f"p.{k}"], v.numpy(), err_msg=k, **STATE_TOL)


def test_bf16_comp_vbpr_over_mesh_matches_single_device(tmp_path_factory):
    _, _, out = _run(BF16_MESH, tmp_path_factory)
    got = out["comp_vbpr_bf16"][0]
    for r in out["comp_vbpr_bf16"][1:]:
        np.testing.assert_array_equal(r["losses"], got["losses"])
    cfg, arrays = _bf16_comp_case()
    model = scenarios.build_model(cfg, arrays)
    model.cnn.dropout_rate = 0.0
    assert model.compute_dtype == torch.bfloat16
    trainer = Trainer(model, synthetic_interactions(U, I, interactions_per_user=8, seed=0),
                      TrainConfig(**cfg["train"]))
    state, frozen = trainer.init_state()
    state, loss = trainer.run_steps(state, frozen, tuple(torch.tensor(arrays[f"t0.{k}"])
                                                         for k in ("users", "pos", "neg")),
                                    step_key=0)
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-5)
    for k, v in state.params.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_allclose(got[f"p.{k}"], v.numpy(), err_msg=k, **STATE_TOL)


def test_derived_pairs_equal_materialized_pairs_over_mesh(run):
    _, _, out = run
    a, b = out["pairs"][0], out["derived"][0]
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for k in ("user_pmv", "item_pmv"):
        np.testing.assert_array_equal(a[k].view(np.int32), b[k].view(np.int32))
    assert a["losses"][-1] < a["losses"][0]


def test_float8_and_undivided_batches_refused_over_mesh(run):
    _, _, out = run
    for r in out["refusals"]:
        assert bool(r["float8"]) and bool(r["batch"])


_FITS = {}


def _single_fit(tmp_path_factory):
    """The port's single-device packed VBPR fit, 2 epochs then resumed to
    3: {tag: (losses, best epoch, metrics, params)}."""
    if not _FITS:
        vparams, feats = _vbpr_params()
        ckpt = str(tmp_path_factory.mktemp("fit_single"))
        for tag, epochs, resume in (("a", 2, False), ("b", 3, True)):
            model = vbpr_from_jax(vparams, feats, device="cpu")
            data = synthetic_interactions(U, I, interactions_per_user=8, seed=0)
            cfg = TrainConfig(epochs=epochs, **FIT_TRAIN)
            ev = FactoredEvaluator(model, data, k=cfg.top_k, user_block=16)
            state, _, results, extra = fit(model, data, cfg, evaluator=ev, seed=5,
                                           ckpt_dir=ckpt, resume=resume)
            assert infer_moment_dtype(state.inner, model.packed_spec()) == "float32"
            _FITS[tag] = ([h.loss for h in extra["history"]], extra["best_epoch"],
                          np.array([[results[e][k] for k in sorted(results[e])]
                                    for e in sorted(results)]),
                          {k: v.numpy() for k, v in state.params.items()})
    return _FITS


def test_fit_packed_over_mesh_matches_single_device(heavy_run, tmp_path_factory):
    _, _, out = heavy_run
    got = out["fit_vbpr"][0]
    for tag, (losses, best, metrics, params) in _single_fit(tmp_path_factory).items():
        np.testing.assert_allclose(got[f"{tag}.losses"], losses, rtol=1e-5)
        assert int(got[f"{tag}.best_epoch"]) == best
        np.testing.assert_allclose(got[f"{tag}.metrics"], metrics, **METRIC_TOL)
        for k, v in params.items():
            np.testing.assert_allclose(got[f"{tag}.p.{k}"], v, err_msg=k, **STATE_TOL)


# --- BPRMF's specialized engines (sparse and packed) -----------------------


@functools.lru_cache(maxsize=None)
def _jax_specialized(shape, engine):
    """(loss, whole state as numpy) of JAX's sharded ``engine`` epoch
    ("fast": ``make_fast_spmd_epoch_fn``, "packed":
    ``make_packed_spmd_epoch_fn``) on the mesh ``shape`` from key KEY."""
    from fashionvisualexpl_tpu.train.fast import init_fast_state
    from fashionvisualexpl_tpu.train.packed import pack_bprmf_state

    jdata = jsynth(U, SPEC_I, interactions_per_user=8, seed=0)
    args = (jnp.asarray(jdata.train_pairs), jnp.asarray(jdata.padded_pos),
            jnp.asarray(jdata.pos_counts))
    jm = JBPRMF(U, SPEC_I, embed_k=K)
    params = jm.init(jax.random.PRNGKey(1))[0]
    mesh = _jmesh(shape)
    if engine == "fast":
        ep = jfs.make_fast_spmd_epoch_fn(jm, mesh, LR, REG, SPEC_I, SPEC_STEPS, B)
        state = jfs.shard_fast_state(init_fast_state(params), mesh)
    else:
        ep = jfs.make_packed_spmd_epoch_fn(jm, mesh, LR, REG, SPEC_I, SPEC_STEPS, B)
        state = jfs.shard_packed_state(pack_bprmf_state(params), mesh)
    state, loss = ep(state, KEY, *args)
    return float(loss), _np(state)


@functools.lru_cache(maxsize=None)
def _single_specialized(engine):
    """(loss, state) of the port's single-device epoch of ``engine`` (the
    sparse one through the K6 sweep, as the sharded one) on the triples the
    sharded epoch draws: seed ``split_seed(SPEC_KEY)``'s first, without
    replacement."""
    from fashionvisualexpl_tpu_torch.models.convert import bprmf_from_jax
    from fashionvisualexpl_tpu_torch.train import fast as tfast
    from fashionvisualexpl_tpu_torch.train import packed as tpacked
    from fashionvisualexpl_tpu_torch.train.trainer import split_seed

    params = _flat(JBPRMF(U, SPEC_I, embed_k=K).init(jax.random.PRNGKey(1))[0])
    model = bprmf_from_jax(params, device="cpu")
    data = synthetic_interactions(U, SPEC_I, interactions_per_user=8, seed=0)
    tabs = tuple(torch.as_tensor(x) for x in (data.train_pairs, data.padded_pos,
                                             data.pos_counts))
    if engine == "fast":
        ep = tfast.make_fast_epoch_fn(model, LR, REG, SPEC_I, SPEC_STEPS, B, fused_adam=True,
                                      device="cpu")
        state = tfast.init_fast_state(dict(model.named_parameters()))
    else:
        ep = tpacked.make_packed_epoch_fn(model, LR, REG, SPEC_I, SPEC_STEPS, B,
                                          with_replacement=False, device="cpu")
        state = tpacked.pack_bprmf_state(dict(model.named_parameters()))
    state, loss = ep(state, split_seed(SPEC_KEY)[0], *tabs)
    return float(loss), state


def _spec_tables(engine):
    if engine == "fast":
        return [(f"{tree}.{k}", lambda st, tree=tree, k=k: getattr(st, tree)[k])
                for tree in ("params", "mu", "nu") for k in ("Gu", "Gi", "Bi")]
    return [(f, lambda st, f=f: getattr(st, f)) for f in ("user_pmv", "item_pmv")]


@pytest.mark.parametrize("engine", ["fast", "packed"])
def test_specialized_engines_over_mesh_match_jax(run, engine):
    _, _, out = run
    got = out["specialized"][0]
    for r in out["specialized"][1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(r[k], v, err_msg=k)
    loss, want = _jax_specialized(run[0], engine)
    np.testing.assert_allclose(got[f"{engine}.fed.loss"], loss, rtol=1e-5)
    assert int(got[f"{engine}.fed.step"]) == SPEC_STEPS
    for name, field in _spec_tables(engine):
        np.testing.assert_allclose(got[f"{engine}.fed.{name}"], np.asarray(field(want)),
                                   err_msg=name, **STATE_TOL)
    if engine == "packed":
        for tau in ("tau_u", "tau_i"):
            np.testing.assert_array_equal(got[f"packed.fed.{tau}"], getattr(want, tau))


@pytest.mark.parametrize("engine", ["fast", "packed"])
def test_specialized_epochs_over_mesh_match_single_device(run, engine):
    _, _, out = run
    got = out["specialized"][0]
    loss, want = _single_specialized(engine)
    np.testing.assert_allclose(got[f"{engine}.epoch.loss"], loss, rtol=1e-5)
    for name, field in _spec_tables(engine):
        np.testing.assert_allclose(got[f"{engine}.epoch.{name}"], field(want).numpy(),
                                   err_msg=name, **STATE_TOL)
    if engine == "packed":
        for tau in ("tau_u", "tau_i"):
            np.testing.assert_array_equal(got[f"packed.epoch.{tau}"],
                                          getattr(want, tau).numpy())


def test_specialized_engines_refuse_undivided_batches_and_rows(run):
    _, _, out = run
    for r in out["specialized"]:
        for engine in ("fast", "packed"):
            assert bool(r[f"{engine}.batch_refused"]) and bool(r[f"{engine}.rows_refused"])
