"""Port ``RecServer(mesh=...)`` (``serve/engine.py``: the catalog
row-sharded over ``model``, the three stages per shard at its global
offset, the lists merged by all-gather and one top-k; K3's plain version
per shard on the CPU) vs the JAX package, on the CPU.

The JAX server runs in this process on a mesh of the same shape over 4 of
conftest's 8 virtual CPU devices; the port's ranks run as fresh
interpreters over gloo (``tests/torch_mesh_ranks.py``, all meshes' ranks
started together), on the meshes (2, 1), (1, 2), (2, 2) and (1, 4).  BPRMF
over 40 users x 37 items (a catalog that splits unevenly, the last shard
holding pad items) with Gaussian params, so the data are tie-free; seg 4;
bf16 stage 1 (the kernel's route), fp32 stage 1 and int8 stage 1; batches
of 1, 8 and 19 users (padded to the 8, 8 and 32 buckets): the served ids
equal JAX's sharded server's and the port's single-device server's, the
values rtol 1e-6 (fp32 rescores in another summation order).  A model
without ``factored_eval`` is refused over a mesh."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from fashionvisualexpl_tpu.core.mesh import make_mesh as jmake_mesh
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu.serve import RecServer as JRecServer
from fashionvisualexpl_tpu_torch.core.mesh import make_mesh
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.convert import bprmf_from_jax
from fashionvisualexpl_tpu_torch.serve import RecServer

MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
U, I, K, TOPK, SEG = 40, 37, 8, 5, 4
DATA = {"U": U, "I": I, "ipu": 6, "seed": 2}
BATCHES = [[3], list(range(0, 40, 5)), [int(u) for u in np.arange(19) * 2 + 1]]
OPTIONS = {"bf16": {}, "fp32": {"stage1_dtype": "fp32"}, "int8": {"quantized": True}}


def _params():
    p = {k: np.asarray(v) for k, v in
         JBPRMF(U, I, embed_k=K).init(jax.random.PRNGKey(6))[0].items()}
    p["Bi"] = np.random.default_rng(6).normal(size=I).astype(np.float32) * 0.1
    return p


_RUNS = {}


def _run(shape, tmp_path_factory):
    if not _RUNS:
        jobs = {}
        for sh in MESHES:
            wd = str(tmp_path_factory.mktemp(f"sserve{sh[0]}x{sh[1]}"))
            for tag, kw in OPTIONS.items():
                ranks.write_inputs(wd, tag, dict(fn="sharded_serve", model="bprmf", data=DATA,
                                                 batches=BATCHES,
                                                 server=dict(k=TOPK, seg=SEG, **kw)),
                                   **{f"p.{k}": v for k, v in _params().items()})
            jobs[sh] = (wd, list(OPTIONS))
        for sh, out in ranks.spawn_many(jobs).items():
            _RUNS[sh] = out
    return _RUNS[shape]


@pytest.fixture(params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def run(request, tmp_path_factory):
    return request.param, _run(request.param, tmp_path_factory)


@functools.lru_cache(maxsize=None)
def _served(option, shape):
    """(ids, vals) per batch: JAX's server on the mesh ``shape``, or (shape
    None) the port's single-device server."""
    params = _params()
    if shape is None:
        srv = RecServer(bprmf_from_jax(params, device="cpu"),
                        synthetic_interactions(U, I, interactions_per_user=DATA["ipu"],
                                               seed=DATA["seed"]),
                        k=TOPK, seg=SEG, device="cpu", **OPTIONS[option])
        srv.refresh()
    else:
        srv = JRecServer(JBPRMF(U, I, embed_k=K),
                         jsynth(U, I, interactions_per_user=DATA["ipu"], seed=DATA["seed"]),
                         k=TOPK, seg=SEG, mesh=jmake_mesh(*shape, devices=jax.devices()[:4][
                             : shape[0] * shape[1]]), **OPTIONS[option])
        srv.refresh({k: jnp.asarray(v) for k, v in params.items()}, {})
    return [srv.query(np.array(b)) for b in BATCHES]


@pytest.mark.parametrize("option", list(OPTIONS))
def test_sharded_server_equals_jax_and_single_device(run, option):
    shape, out = run
    for want in (_served(option, shape), _served(option, None)):
        for r in out[option]:
            for j, (ids, vals) in enumerate(want):
                np.testing.assert_array_equal(r[f"ids{j}"], ids, err_msg=f"batch {j}")
                np.testing.assert_allclose(r[f"vals{j}"], vals, rtol=1e-6)


def test_sharded_server_geometry_and_refusal():
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion

    rng = np.random.default_rng(0)
    data = synthetic_interactions(U, I, interactions_per_user=6, seed=2)
    mesh = make_mesh(device="cpu")  # a one-process mesh: one shard
    srv = RecServer(bprmf_from_jax(_params(), device="cpu"), data, k=TOPK, seg=SEG,
                    device="cpu", mesh=mesh)
    assert (srv._offset, srv._local_padded, srv._padded_items) == (0, 40, 40)
    af = AttentiveFashion(U, I, rng.random((I, 4)).astype(np.float32),
                          rng.random((I, 8, 8, 1)).astype(np.float32),
                          np.eye(3, dtype=np.float32)[rng.integers(0, 3, I)], embed_k=4,
                          device="cpu")
    with pytest.raises(ValueError, match="mesh serving requires a factored model"):
        RecServer(af, data, k=TOPK, device="cpu", mesh=mesh)
