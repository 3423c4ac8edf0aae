"""Port K6 (fused Adam sweep) vs the JAX package, on the same numpy-seeded
state.  The plain sweep against ``fused_adam_sweep(interpret=True)``: m and
v rtol 1e-6, p rtol 1e-5, 1-D and 2-D.  ``sparse_adam_table_fused`` against
JAX's ``sparse_adam_table`` (the XLA route it replaces) and against JAX's
own fused version: rtol 2e-5, atol 1e-7 (the two routes round the bias
correction at different places)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.ops import adam as jadam
from fashionvisualexpl_tpu.train import fast as jfast
from fashionvisualexpl_tpu_torch.ops import adam as tadam

SHAPES = [(101, 7), (53,), (64, 4)]


def _state(shape, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=shape).astype(np.float32)
    m = rng.normal(size=shape).astype(np.float32)
    v = np.abs(rng.normal(size=shape)).astype(np.float32)
    return p, m, v


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def test_adam_scalars_are_float32_from_a_float32_step():
    t = torch.tensor(7.0)
    scal = tadam.adam_scalars(0.01, t)
    assert scal.dtype == torch.float32 and scal.shape == (2,)
    jt = jnp.float32(7.0)
    want = [0.01 / (1.0 - jfast.B1 ** jt), 1.0 / (1.0 - jfast.B2 ** jt)]
    np.testing.assert_allclose(scal.numpy(), np.asarray(want, np.float32), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("t", [1.0, 5.0, 300.0])
def test_sweep_matches_jax_interpret(shape, t):
    p, m, v = _state(shape, seed=len(shape) * 10 + int(t))
    lr = 0.01
    jp, jm, jv = jadam.fused_adam_sweep(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(v), lr, jnp.float32(t),
        block_rows=16, interpret=True,
    )
    tp, tm, tv = _torch(p, m, v)
    before = tadam.fused_adam_sweep.launches
    out = tadam.fused_adam_sweep(tp, tm, tv, tadam.adam_scalars(lr, torch.tensor(t)))
    assert tadam.fused_adam_sweep.launches == before  # CPU: plain version
    assert all(a is b for a, b in zip(out, (tp, tm, tv)))  # in place
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)


@pytest.mark.parametrize("shape", [(64, 4), (64,)])
def test_sparse_fused_matches_jax_sparse_table(shape):
    p, m, v = _state(shape, seed=1)
    rng = np.random.default_rng(2)
    S = 10
    uids = rng.choice(shape[0], S, replace=False).astype(np.int32)
    g = rng.normal(size=(S, *shape[1:])).astype(np.float32)
    # compact_row_grads pads unused segments with an out-of-range id and a
    # zero gradient; the scatter must leave the real rows as JAX does
    uids = np.concatenate([uids, np.full(3, 2**30, np.int32)])
    g = np.concatenate([g, np.zeros((3, *shape[1:]), np.float32)])
    lr, t = 0.02, 3.0
    jargs = [jnp.asarray(a) for a in (p, m, v, uids, g)]
    plain = jfast.sparse_adam_table(*jargs, lr, jnp.float32(t))
    fused = jadam.sparse_adam_table_fused(*jargs, lr, jnp.float32(t), interpret=True)
    tp, tm, tv = _torch(p, m, v)
    tadam.sparse_adam_table_fused(tp, tm, tv, torch.from_numpy(uids),
                                  torch.from_numpy(g),
                                  tadam.adam_scalars(lr, torch.tensor(t)))
    for want in (plain, fused):
        for name, got, w in zip("pmv", (tp, tm, tv), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-5,
                                       atol=1e-7, err_msg=name)


def test_sweep_rejects_mismatched_state():
    p, m, v = _torch(*_state((8, 3), seed=0))
    scal = tadam.adam_scalars(0.01, torch.tensor(1.0))
    with pytest.raises(ValueError, match="shapes differ"):
        tadam.fused_adam_sweep(p, m[:4], v, scal)
    with pytest.raises(ValueError, match="float32"):
        tadam.fused_adam_sweep(p, m.double(), v, scal)
    with pytest.raises(ValueError, match="float32"):
        tadam.fused_adam_sweep(p, m, v, scal.double())
    with pytest.raises(ValueError, match=r"scal must be \[2\]"):
        tadam.fused_adam_sweep(p, m, v, scal[:1])
