"""Port sharded evaluation (``eval/factored.py``: ``sharded_streaming_counts``,
``sharded_streaming_topk_and_counts``, ``FactoredEvaluator(mesh=...)``,
K2's plain version per shard on the CPU) vs the JAX package, on the CPU.

The JAX functions run in this process over conftest's virtual CPU
devices on a (1, m) mesh of the same model axis (they replicate over
``data``, so a (d, m) mesh's result is the (1, m) mesh's; its kernel
engine, Pallas, in interpret mode); the port's ranks run as fresh interpreters over gloo
(``tests/torch_mesh_ranks.py``, all meshes' ranks started together), on the
meshes (2, 1), (1, 2), (2, 2) and (1, 4); 30 items (padded rows with -inf
bias on the 4-way model axis), item blocks of 4 so that every shard scans
several:

- the counts of each engine ("mask", "bucketed", "kernel"; JAX's "pallas")
  bit-equal to JAX's on data on the 1/64 grid (every score exact in f32),
  with the shard-local banned buckets of one probed width; the merged
  top-k on Gaussian data: ids equal, values rtol 1e-6;
- ``FactoredEvaluator(mesh=...)``: every engine's metrics equal to JAX's
  sharded evaluator's and the port's single-device one's on the 1/64 grid
  (rtol 1e-6: float means of equal per-user values); the dumps' top-k
  rows (train items filtered) equal to JAX's sharded ``_topk_rows`` and to
  the port's single-device dump, on Gaussian params."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from fashionvisualexpl_tpu.core.mesh import make_mesh as jmake_mesh
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.eval import factored as jfactored
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu.ops.topk import banned_bucket_width
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
from fashionvisualexpl_tpu_torch.models.convert import bprmf_from_jax

MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
U, I, K, D, BU, BLOCK, TOPK = 40, 30, 5, 8, 16, 4, 5
DATA = {"U": U, "I": I, "ipu": 6, "seed": 3}
IMPLS = [("mask", "mask"), ("bucketed", "bucketed"), ("kernel", "pallas")]


def _jmesh(m):
    """JAX's (1, m) mesh: its evaluation replicates over ``data``, so a
    (d, m) mesh gives the (1, m) mesh's result."""
    return jmake_mesh(1, m, devices=jax.devices()[:m])


def _q64(x):
    return (np.round(x * 64).clip(-64, 64) / 64).astype(np.float32)


def _counts_inputs():
    rng = np.random.default_rng(0)
    uf, iv, ib = (_q64(rng.normal(size=s) * 0.5) for s in ((BU, D), (I, D), (I,)))
    ref = _q64(rng.normal(size=(BU, 3)))
    banned = rng.integers(0, I, size=(BU, 6)).astype(np.int32)
    banned[:, -2:] = -1
    g = np.random.default_rng(1)
    return dict(uf=uf, iv=iv, ib=ib, ref=ref, banned=banned,
                g_uf=g.normal(size=(BU, D)).astype(np.float32),
                g_iv=g.normal(size=(I, D)).astype(np.float32),
                g_ib=g.normal(size=I).astype(np.float32))


def _width(banned, m):
    rows = -(-I // m)
    return max(banned_bucket_width(banned - s * rows, rows, BLOCK) for s in range(m))


def _params(quantized):
    p = {k: np.asarray(v) for k, v in
         JBPRMF(U, I, embed_k=K).init(jax.random.PRNGKey(4))[0].items()}
    p["Bi"] = np.random.default_rng(4).normal(size=I).astype(np.float32) * 0.1
    return {k: _q64(v * 4) for k, v in p.items()} if quantized else p


_RUNS = {}


def _run(shape, tmp_path_factory):
    if not _RUNS:
        jobs = {}
        for sh in MESHES:
            wd = str(tmp_path_factory.mktemp(f"seval{sh[0]}x{sh[1]}"))
            inp = _counts_inputs()
            ranks.write_inputs(wd, "counts", dict(fn="sharded_counts", block=BLOCK, k=TOPK,
                                                  width=_width(inp["banned"], sh[1])), **inp)
            for tag, quantized in (("evaluate", True), ("dump", False)):
                ranks.write_inputs(wd, tag, dict(fn="sharded_evaluate", model="bprmf",
                                                 data=DATA, k=TOPK, user_block=BU),
                                   **{f"p.{k}": v for k, v in _params(quantized).items()})
            jobs[sh] = (wd, ["counts", "evaluate", "dump"])
        for sh, out in ranks.spawn_many(jobs).items():
            _RUNS[sh] = out
    return _RUNS[shape]


@pytest.fixture(params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def run(request, tmp_path_factory):
    return request.param, _run(request.param, tmp_path_factory)


@functools.lru_cache(maxsize=None)
def _jax_counts(m, jimpl):
    inp = _counts_inputs()
    pad = -(-I // m) * m - I
    ivp = jnp.asarray(np.pad(inp["iv"], ((0, pad), (0, 0))))
    ibp = jnp.asarray(np.pad(inp["ib"], (0, pad), constant_values=-np.inf))
    return np.asarray(jfactored.sharded_streaming_counts(
        _jmesh(m), jnp.asarray(inp["uf"]), ivp, ibp, jnp.asarray(inp["ref"]),
        jnp.asarray(inp["banned"]), BLOCK, impl=jimpl,
        bucket_width=_width(inp["banned"], m), interpret=True))


@pytest.mark.parametrize("impl,jimpl", IMPLS, ids=[i for i, _ in IMPLS])
def test_sharded_counts_equal_jax(run, impl, jimpl):
    shape, out = run
    for r in out["counts"]:
        np.testing.assert_array_equal(r[impl], _jax_counts(shape[1], jimpl))


@functools.lru_cache(maxsize=None)
def _jax_topk(m):
    inp = _counts_inputs()
    pad = -(-I // m) * m - I
    return tuple(map(np.asarray, jfactored.sharded_streaming_topk_and_counts(
        _jmesh(m), jnp.asarray(inp["g_uf"]),
        jnp.asarray(np.pad(inp["g_iv"], ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(inp["g_ib"], (0, pad), constant_values=-np.inf)), TOPK,
        jnp.asarray(inp["ref"]), jnp.asarray(inp["banned"]), BLOCK)))


def test_sharded_topk_merge_equals_jax(run):
    shape, out = run
    v, i, c = _jax_topk(shape[1])
    for r in out["counts"]:
        np.testing.assert_array_equal(r["topk_ids"], np.asarray(i))
        np.testing.assert_allclose(r["topk_vals"], np.asarray(v), rtol=1e-6)
        np.testing.assert_array_equal(r["topk_counts"], np.asarray(c))


@functools.lru_cache(maxsize=None)
def _jax_metrics(m, jimpl):
    params = {k: jnp.asarray(v) for k, v in _params(True).items()}
    jm = JBPRMF(U, I, embed_k=K)
    data = jsynth(U, I, interactions_per_user=DATA["ipu"], seed=DATA["seed"])
    ev = jfactored.FactoredEvaluator(jm, data, k=TOPK, user_block=BU, mesh=_jmesh(m),
                                     counts_impl=jimpl)
    return ev.evaluate(params, {})


@functools.lru_cache(maxsize=None)
def _jax_dump(m):
    params = _params(False)
    jm = JBPRMF(U, I, embed_k=K)
    data = jsynth(U, I, interactions_per_user=DATA["ipu"], seed=DATA["seed"])
    jev = jfactored.FactoredEvaluator(jm, data, k=TOPK, user_block=BU, mesh=_jmesh(m),
                                      counts_impl="mask")
    _, ids, vals = jev._topk_rows({k: jnp.asarray(v) for k, v in params.items()}, {})
    return np.asarray(ids), np.asarray(vals)


@functools.lru_cache(maxsize=None)
def _single(impl):
    """The port's single-device metrics through ``impl`` on the 1/64 grid,
    or (``"dump"``) its exact dump rows on Gaussian params."""
    data = synthetic_interactions(U, I, interactions_per_user=DATA["ipu"], seed=DATA["seed"])
    if impl == "dump":
        model = bprmf_from_jax(_params(False), device="cpu")
        _, ids, vals = FactoredEvaluator(model, data, k=TOPK, user_block=BU)._topk_rows(
            None, None, exact=True)
        return ids, vals
    model = bprmf_from_jax(_params(True), device="cpu")
    return FactoredEvaluator(model, data, k=TOPK, user_block=BU,
                             counts_impl=impl).evaluate(None, None)


@pytest.mark.parametrize("impl,jimpl", IMPLS, ids=[i for i, _ in IMPLS])
def test_sharded_evaluator_metrics_equal_jax_and_single_device(run, impl, jimpl):
    shape, out = run
    single = _single(impl)
    for r in out["evaluate"]:
        got = dict(zip(r[f"{impl}.keys"], r[f"{impl}.vals"]))
        for want in (_jax_metrics(shape[1], jimpl), single):
            assert sorted(got) == sorted(want)
            for k in got:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_sharded_dump_rows_equal_jax_and_single_device(run):
    shape, out = run
    jids, jvals = _jax_dump(shape[1])
    sids, svals = _single("dump")
    for r in out["dump"]:
        np.testing.assert_array_equal(r["dump_ids"], np.asarray(jids))
        np.testing.assert_array_equal(r["dump_ids"], sids)
        np.testing.assert_allclose(r["dump_vals"], np.asarray(jvals), rtol=1e-6)
        np.testing.assert_allclose(r["dump_vals"], svals, rtol=1e-6)
