"""Port the specialized packed steps (``train/packed.py``: one
``make_packed_step`` over a ``PackedLazyState`` for BPRMF, VBPR and
GradFashion, called by the JAX package's per-model names, its epoch and
``PackedTrainState``) vs the JAX package and the port's own engines, on
the CPU (K4 and K5 take their plain versions on CPU tensors).

- Each step against JAX's, started from a JAX state in mid-run (3 JAX
  steps, carried across by ``models/convert.py::packed_state_from_jax``),
  8 steps on batches with duplicate ids (so the dedupe pads): losses rtol
  1e-5; touched rows and dense (p, m, v) rtol 1e-5, atol 1e-7; tau and the
  untouched rows bit-equal.
- Twins of JAX ``tests/test_packed_generic.py:41/78/120``: each step
  against the port's generic engine from the same params, bit for bit
  (the generic rows less their tau column; the tau column equal to the
  tau arrays).
- Twins of ``tests/test_packed_trainer.py:17/51``: BPRMF and VBPR packed
  against the unpacked lazy fast path (``train/fast.py``, ``lazy=True``),
  rtol 1e-6, atol 1e-7.
- Each epoch function against its own step loop over the triples it
  samples: bit-equal.
- A ``PackedTrainState`` checkpoint round trip (twin of
  ``tests/test_packed_trainer.py:209``): bit for bit; another kind is
  refused."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.data.features import synthetic_features
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu.models.grad_fashion import GradFashion as JGradFashion
from fashionvisualexpl_tpu.models.vbpr import VBPR as JVBPR
from fashionvisualexpl_tpu.train import packed as jpacked
from fashionvisualexpl_tpu_torch.core.checkpoint import CheckpointManager
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
from fashionvisualexpl_tpu_torch.models import convert
from fashionvisualexpl_tpu_torch.train import fast as tfast
from fashionvisualexpl_tpu_torch.train import packed as tpacked
from fashionvisualexpl_tpu_torch.train import packed_generic as tpg

KINDS = ("bprmf", "vbpr", "grad_fashion")
U, I, K, D, B = 60, 80, 8, 4, 16
LR, REG = 0.02, 0.01
TOL = dict(rtol=1e-5, atol=1e-7)


def _bits(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).view(np.uint32)


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(JAX model, JAX params, port model, JAX frozen batch part, the
    port's ``frozen`` keyword, JAX pack / step / epoch makers, the port's
    of the same names)."""
    if kind == "bprmf":
        jm = JBPRMF(U, I, embed_k=K)
        params, frozen = jm.init(jax.random.PRNGKey(0))
        tm = convert.bprmf_from_jax({k: np.asarray(v) for k, v in params.items()},
                                    device="cpu")
        jf = tf = None
    elif kind == "vbpr":
        F = synthetic_features(I, 9, seed=1)
        jm = JVBPR(U, I, F, embed_k=K, embed_d=D)
        params, frozen = jm.init(jax.random.PRNGKey(0))
        tm = convert.vbpr_from_jax({k: np.asarray(v) for k, v in params.items()}, F,
                                   device="cpu")
        jf, tf = frozen["F"], dict(tm.named_buffers())
    else:
        color, edges = synthetic_features(I, 7, seed=2), synthetic_features(I, 9, seed=3)
        jm = JGradFashion(U, I, color, edges, embed_k=K, embed_d=D, embed_color=4,
                          embed_edges=4)
        params, frozen = jm.init(jax.random.PRNGKey(0))
        tm = convert.grad_fashion_from_jax({k: np.asarray(v) for k, v in params.items()},
                                           color, edges, device="cpu")
        jf, tf = (frozen["Fc"], frozen["Fe"]), dict(tm.named_buffers())
    names = {"bprmf": ("pack_bprmf_state", "make_packed_bprmf_step", "make_packed_epoch_fn"),
             "vbpr": ("pack_vbpr_state", "make_packed_vbpr_step", "make_packed_vbpr_epoch_fn"),
             "grad_fashion": ("pack_grad_fashion_state", "make_packed_grad_fashion_step",
                              "make_packed_grad_fashion_epoch_fn")}[kind]
    return (jm, params, tm, jf, tf, *(getattr(jpacked, n) for n in names),
            *(getattr(tpacked, n) for n in names))


def _batches(seed, n):
    """n (users, pos, neg) int32 batches; every batch repeats an id in each
    array, so the dedupe always pads."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        u, p, q = (rng.integers(0, m, B).astype(np.int32) for m in (U, I, I))
        u[1], p[1], q[2] = u[0], p[0], p[3]
        yield u, p, q


def _with(frozen, ids):
    return ids if frozen is None else (frozen, ids)


def _dense_leaves(state):
    return {f"{n}.{i}": x for n, pmv in getattr(state, "dense", {}).items()
            for i, x in enumerate(pmv)}


@pytest.mark.parametrize("kind", KINDS)
def test_specialized_step_matches_jax_from_a_carried_state(kind):
    jm, params, tm, jf, tf, jpack, jstep_fn, _, _, tstep_fn, _ = _case(kind)
    jstep = jax.jit(jstep_fn(jm, LR, REG))
    tstep = tstep_fn(tm, LR, REG)
    jstate = jpack(params)
    batches = list(_batches(3, 11))
    for ids in batches[:3]:  # the JAX run before the hand-over
        jstate, _ = jstep(jstate, _with(jf, tuple(map(jnp.asarray, ids))))
    start = jax.tree.map(np.asarray, jstate)
    state = convert.packed_state_from_jax(start, device="cpu")
    assert set(state.dense) == set(getattr(jstate, "dense", {})) and int(state.step) == 3
    for ids in batches[3:]:
        jstate, jl = jstep(jstate, _with(jf, tuple(map(jnp.asarray, ids))))
        state, tl = tstep(state, tuple(map(torch.from_numpy, ids)), frozen=tf)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = jax.tree.map(np.asarray, jstate)
    for tau in ("tau_u", "tau_i"):
        np.testing.assert_array_equal(getattr(state, tau).numpy(), getattr(want, tau))
    for name, tau in (("user_pmv", want.tau_u), ("item_pmv", want.tau_i)):
        got, old = getattr(state, name).numpy(), getattr(start, name)
        touched = tau > 3
        assert touched.any() and not touched.all()
        np.testing.assert_array_equal(_bits(got[~touched]), _bits(old[~touched]))
        np.testing.assert_allclose(got, getattr(want, name), err_msg=name, **TOL)
    jd = {f"{n}.{i}": x for n, pmv in getattr(want, "dense", {}).items()
          for i, x in enumerate(pmv)}
    for k, v in _dense_leaves(state).items():
        np.testing.assert_allclose(v.numpy(), jd[k], err_msg=k, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_specialized_step_equals_generic_engine_bit_for_bit(kind):
    _, _, tm, _, tf, _, _, _, tpack, tstep_fn, _ = _case(kind)
    params = dict(tm.named_parameters())
    spec, gen = tpack(params), tpg.pack_generic_state(tm, params)
    step = tstep_fn(tm, LR, REG)
    gstep = tpg.make_generic_packed_step(tm, LR, REG)
    frozen = dict(tm.named_buffers())
    for ids in _batches(7, 8):
        ids = tuple(map(torch.from_numpy, ids))
        spec, sl = step(spec, ids, frozen=tf)
        gen, gl = gstep(gen, (frozen, ids, None))
        assert _bits(sl) == _bits(gl)
    # the generic layout carries tau as a last float32 column
    for name, tau in (("user_pmv", spec.tau_u), ("item_pmv", spec.tau_i)):
        np.testing.assert_array_equal(_bits(getattr(gen, name)[:, :-1]),
                                      _bits(getattr(spec, name)), err_msg=name)
        np.testing.assert_array_equal(getattr(gen, name)[:, -1].to(torch.int32).numpy(),
                                      tau.numpy())
    for name, pmv in getattr(spec, "dense", {}).items():
        for x, y in zip(pmv, gen.dense[name]):
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=name)


@pytest.mark.parametrize("kind", ["bprmf", "vbpr"])
def test_packed_matches_unpacked_lazy(kind):
    _, _, tm, _, tf, _, _, _, tpack, tstep_fn, _ = _case(kind)
    params = {k: v.detach().clone() for k, v in tm.named_parameters()}
    rows = ("Gu", "Gi", "Bi") + (("Tu",) if kind == "vbpr" else ())
    lazy = tfast.init_lazy_state(params, rows)
    lazy_step = (tfast.make_fast_bprmf_step(tm, LR, REG, lazy=True) if kind == "bprmf"
                 else tfast.make_fast_vbpr_step(tm, LR, REG, lazy=True))
    packed, step = tpack(params), tstep_fn(tm, LR, REG)
    for ids in _batches(11, 8):
        ids = tuple(map(torch.from_numpy, ids))
        lazy, ll = lazy_step(lazy, _with(None if tf is None else tf["F"], ids))
        packed, pl_ = step(packed, ids, frozen=tf)
        np.testing.assert_allclose(float(pl_), float(ll), rtol=1e-6)
    got = tpacked.PackedTrainState(packed, kind, K, D).params
    for k, v in lazy.params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(packed.tau_u.numpy(), lazy.tau["Gu"].numpy())
    np.testing.assert_array_equal(packed.tau_i.numpy(), lazy.tau["Gi"].numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_epoch_fn_is_its_step_loop(kind):
    _, _, tm, _, tf, _, _, _, tpack, tstep_fn, tepoch_fn = _case(kind)
    data = synthetic_interactions(U, I, interactions_per_user=8, seed=0)
    tabs = tuple(torch.as_tensor(x) for x in (data.train_pairs, data.padded_pos,
                                             data.pos_counts))
    steps = data.steps_per_epoch(B)
    epoch = tepoch_fn(tm, LR, REG, I, steps, B, device="cpu")
    state, loss = epoch(tpack(dict(tm.named_parameters())), 5, *tabs, frozen=tf)
    ref = tpack(dict(tm.named_parameters()))
    triples = sample_triplets(5, *tabs, I, steps, B, with_replacement=True, device="cpu")
    step, total = tstep_fn(tm, LR, REG), []
    for s in range(steps):
        ref, l_ = step(ref, tuple(t[s] for t in triples), frozen=tf)
        total.append(l_)
    assert int(state.step) == steps and _bits(loss) == _bits(torch.sum(torch.stack(total)))
    for a, b in zip(state, ref):
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict) else [(a, b)]):
            for xx, yy in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
                np.testing.assert_array_equal(_bits(xx), _bits(yy))


@pytest.mark.parametrize("kind", KINDS)
def test_packed_train_state_checkpoint_round_trip(kind, tmp_path):
    _, _, tm, _, tf, _, _, _, tpack, tstep_fn, _ = _case(kind)
    inner = tpack(dict(tm.named_parameters()))
    for ids in _batches(13, 2):  # moments and tau worth saving
        inner, _ = tstep_fn(tm, LR, REG)(inner, tuple(map(torch.from_numpy, ids)), frozen=tf)
    state = tpacked.PackedTrainState(inner, kind, K, 0 if kind == "bprmf" else D)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state)
    zeros = tpack({k: torch.zeros_like(v) for k, v in tm.named_parameters()})
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore(state.with_inner(zeros))
    assert mgr.latest_step() == 3 and int(restored.step) == 2
    for k, v in state.params.items():
        np.testing.assert_array_equal(_bits(restored.params[k]), _bits(v), err_msg=k)
    for tau in ("tau_u", "tau_i"):
        np.testing.assert_array_equal(getattr(restored.inner, tau).numpy(),
                                      getattr(inner, tau).numpy())
    other = tpacked.PackedTrainState(zeros, "other", K, D)
    with pytest.raises(ValueError, match="kind"):
        mgr.restore(other)
