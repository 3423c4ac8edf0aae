"""Port fast path (``train/fast.py``) vs the JAX package on the same
numpy-seeded inputs and JAX's carried-over init.

- ``compact_row_grads``: unique ids bit-equal, sums rtol 1e-6 (the CPU adds
  a segment's duplicates in sorted order, as XLA does);
- ``sparse_adam_table``, ``lazy_adam_table``, ``dense_adam``: rtol 1e-5,
  atol 1e-7, with the out-of-range pads of ``compact_row_grads`` present;
- the fast step over 6 steps for each flag combination, against the JAX
  step with its Pallas kernels in interpret mode (as
  ``tests/test_fast_trainer.py`` runs them on the CPU): loss rtol 1e-5 per
  step, params and moments rtol 2e-4, atol 1e-6 (f32 sums in another
  order, compounded over the steps)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fashionvisualexpl_tpu.ops.adam as jadam
import fashionvisualexpl_tpu.ops.bpr as jbpr
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu.train import fast as jfast
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
from fashionvisualexpl_tpu_torch.models.convert import (
    bprmf_from_jax,
    fast_state_from_jax,
)
from fashionvisualexpl_tpu_torch.train import fast as tfast

TABLES = ("Gu", "Gi", "Bi")
STATE_TOL = dict(rtol=2e-4, atol=1e-6)
ROW_TOL = dict(rtol=1e-5, atol=1e-7)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(x):
    return torch.from_numpy(np.array(x))


def test_compact_row_grads_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, 24).astype(np.int32)
    g = rng.normal(size=(24, 3)).astype(np.float32)
    ju, js = jfast.compact_row_grads(jnp.asarray(ids), jnp.asarray(g), 24)
    tu, ts = tfast.compact_row_grads(_t(ids), _t(g), 24)
    assert tu.dtype == torch.int32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    n_unique = len(set(ids.tolist()))
    assert (tu.numpy()[n_unique:] == 2**30).all()
    assert (ts.numpy()[n_unique:] == 0).all()


def _table_case(shape, seed):
    """A state, compact ids with trailing pads, and their gradients."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=shape).astype(np.float32)
    m = (rng.normal(size=shape) * 0.1).astype(np.float32)
    v = np.abs(rng.normal(size=shape) * 0.01).astype(np.float32)
    S = 7
    uids = np.concatenate([np.sort(rng.choice(shape[0], S, replace=False)),
                           np.full(4, 2**30)]).astype(np.int32)
    g = np.concatenate([rng.normal(size=(S, *shape[1:])),
                        np.zeros((4, *shape[1:]))]).astype(np.float32)
    tau = rng.integers(0, 5, shape[0]).astype(np.int32)
    return p, m, v, tau, uids, g


@pytest.mark.parametrize("shape", [(20, 3), (20,)])
def test_sparse_and_lazy_tables_match_jax(shape):
    p, m, v, tau, uids, g = _table_case(shape, seed=len(shape))
    lr, t = 0.05, 6.0
    want = jfast.sparse_adam_table(*(jnp.asarray(a) for a in (p, m, v, uids, g)),
                                   lr, jnp.float32(t))
    got = [_t(a) for a in (p, m, v)]
    tfast.sparse_adam_table(*got, _t(uids), _t(g), lr, torch.tensor(t))
    for name, a, w in zip("pmv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **ROW_TOL)

    want = jfast.lazy_adam_table(
        *(jnp.asarray(a) for a in (p, m, v, tau, uids, g)), lr, jnp.float32(t))
    got = [_t(a) for a in (p, m, v, tau)]
    tfast.lazy_adam_table(*got, _t(uids), _t(g), lr, torch.tensor(t))
    for name, a, w in zip("pmv", got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **ROW_TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    untouched = np.setdiff1d(np.arange(shape[0]), uids)
    np.testing.assert_array_equal(got[0].numpy()[untouched], p[untouched])


def test_dense_adam_matches_jax():
    p, m, v, _, _, _ = _table_case((12, 5), seed=3)
    g = np.random.default_rng(4).normal(size=(12, 5)).astype(np.float32)
    want = jfast.dense_adam(*(jnp.asarray(a) for a in (p, m, v, g)), 0.01,
                            jnp.float32(2.0))
    got = tfast.dense_adam(*(_t(a) for a in (p, m, v, g)), 0.01, torch.tensor(2.0))
    for name, a, w in zip("pmv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **ROW_TOL)


@pytest.fixture
def jax_interpret_kernels(monkeypatch):
    """The JAX fast step with its Pallas kernels in interpret mode (the
    flags call the compiled TPU kernels, which the CPU cannot run)."""
    bpr = jbpr.bpr_triplet_loss
    monkeypatch.setattr(jbpr, "bpr_triplet_loss",
                        lambda *a: bpr(*a[:5], 16, True))
    monkeypatch.setattr(jadam, "sparse_adam_table_fused",
                        functools.partial(jadam.sparse_adam_table_fused,
                                          interpret=True))


def _jax_init(U, I, K, seed):
    params, _ = JBPRMF(U, I, embed_k=K).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params["Bi"] = jnp.asarray(rng.normal(size=I).astype(np.float32) * 0.1)
    return params


def _batches(U, I, B, n, seed):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, hi, B).astype(np.int32) for hi in (U, I, I))
            for _ in range(n)]


def _assert_states_close(got, want, tau=False):
    for k in TABLES:
        for field in ("params", "mu", "nu"):
            np.testing.assert_allclose(
                getattr(got, field)[k].numpy(), np.asarray(getattr(want, field)[k]),
                err_msg=f"{field}[{k}]", **STATE_TOL)
        if tau:
            np.testing.assert_array_equal(got.tau[k].numpy(), np.asarray(want.tau[k]))
    assert int(got.step) == int(want.step)


@pytest.mark.parametrize("pallas_bpr,fused_adam,lazy", [
    (False, False, False), (True, False, False), (False, True, False),
    (True, True, False), (False, False, True), (True, False, True),
])
def test_fast_step_matches_jax(jax_interpret_kernels, pallas_bpr, fused_adam, lazy):
    U, I, K, B, lr, reg = 30, 40, 8, 16, 0.01, 0.02
    params = _jax_init(U, I, K, seed=2)
    if lazy:
        jstate = jfast.init_lazy_state(params, TABLES)
    else:
        jstate = jfast.init_fast_state(params)
    jstep = jax.jit(jfast.make_fast_bprmf_step(
        None, lr, reg, fused_adam=fused_adam, pallas_bpr=pallas_bpr, lazy=lazy))
    tstate = fast_state_from_jax(
        jstate.step, _np(jstate.params), _np(jstate.mu), _np(jstate.nu),
        tau=_np(jstate.tau) if lazy else None, device="cpu")
    tstep = tfast.make_fast_bprmf_step(None, lr, reg, fused_adam=fused_adam,
                                       pallas_bpr=pallas_bpr, lazy=lazy)
    for batch in _batches(U, I, B, 6, seed=3):
        jstate, jloss = jstep(jstate, tuple(jnp.asarray(x) for x in batch))
        tstate, tloss = tstep(tstate, tuple(_t(x) for x in batch))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_states_close(tstate, jstate, tau=lazy)


def test_mid_run_lazy_state_carries_across(jax_interpret_kernels):
    """A JAX state after 3 steps (moments and last-touch steps set), carried
    over, continues as JAX's does for 3 more steps."""
    U, I, K, B, lr, reg = 25, 30, 4, 8, 0.05, 0.01
    jstate = jfast.init_lazy_state(_jax_init(U, I, K, seed=5), TABLES)
    jstep = jax.jit(jfast.make_fast_bprmf_step(None, lr, reg, pallas_bpr=True,
                                               lazy=True))
    batches = _batches(U, I, B, 6, seed=6)
    for batch in batches[:3]:
        jstate, _ = jstep(jstate, tuple(jnp.asarray(x) for x in batch))
    tstate = fast_state_from_jax(jstate.step, _np(jstate.params), _np(jstate.mu),
                                 _np(jstate.nu), tau=_np(jstate.tau), device="cpu")
    assert isinstance(tstate, tfast.LazyFastState) and int(tstate.step) == 3
    tstep = tfast.make_fast_bprmf_step(None, lr, reg, pallas_bpr=True, lazy=True)
    for batch in batches[3:]:
        jstate, jloss = jstep(jstate, tuple(jnp.asarray(x) for x in batch))
        tstate, tloss = tstep(tstate, tuple(_t(x) for x in batch))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_states_close(tstate, jstate, tau=True)


def test_epoch_fn_is_the_sampler_then_the_steps():
    data = synthetic_interactions(30, 50, interactions_per_user=6, seed=0)
    tabs = [torch.as_tensor(np.asarray(a, np.int32))
            for a in (data.train_pairs, data.padded_pos, data.pos_counts)]
    model = bprmf_from_jax(_np(_jax_init(30, 50, 4, seed=1)), device="cpu")
    kw = dict(fused_adam=True, pallas_bpr=True)
    params = {k: v.detach() for k, v in model.named_parameters()}
    by_epoch = tfast.init_fast_state({k: v.clone() for k, v in params.items()})
    by_steps = tfast.init_fast_state({k: v.clone() for k, v in params.items()})
    epoch = tfast.make_fast_epoch_fn(model, 0.01, 0.01, 50, 4, 16, device="cpu", **kw)
    step = tfast.make_fast_bprmf_step(model, 0.01, 0.01, **kw)
    by_epoch, total = epoch(by_epoch, 11, *tabs)
    triples = sample_triplets(11, *tabs, 50, 4, 16, device="cpu")
    losses = []
    for s in range(4):
        by_steps, loss = step(by_steps, tuple(t[s] for t in triples))
        losses.append(loss)
    assert total.shape == () and int(by_epoch.step) == 4
    torch.testing.assert_close(total, torch.stack(losses).sum(), rtol=0, atol=0)
    for k in TABLES:
        torch.testing.assert_close(by_epoch.params[k], by_steps.params[k],
                                   rtol=0, atol=0)
