"""Port BPRMF vs the JAX BPRMF on the same (carried-across) weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.models.convert import bprmf_from_jax

U, I, K = 23, 41, 16
# rtol 1e-6, plus atol 1e-7 (about one f32 ulp of an O(1) score) for scores
# near zero: the K-term sums run in another order than JAX's
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def pair():
    jm = JBPRMF(U, I, embed_k=K)
    params, frozen = jm.init(jax.random.PRNGKey(3))
    # non-zero biases so the bias path is exercised
    params["Bi"] = jnp.asarray(
        np.random.default_rng(3).normal(size=I).astype(np.float32)
    )
    tm = bprmf_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    return jm, params, frozen, tm


def test_weights_carried_bit_for_bit(pair):
    jm, params, frozen, tm = pair
    uf, iv, ib = jm.factored_eval(params, frozen)
    tuf, tiv, tib = tm.factored_eval()
    for j, t in ((uf, tuf), (iv, tiv), (ib, tib)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))


def test_scores_match_jax(pair):
    jm, params, frozen, tm = pair
    rng = np.random.default_rng(0)
    users = rng.integers(0, U, 64).astype(np.int32)
    items = rng.integers(0, I, 64).astype(np.int32)
    with torch.no_grad():
        got = tm.score(torch.from_numpy(users).long(), torch.from_numpy(items).long())
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jm.score(params, frozen, users, items)), **TOL
        )
        np.testing.assert_allclose(
            tm.predict_all().numpy(), np.asarray(jm.predict_all(params, frozen)),
            **TOL,
        )
        block = np.asarray([5, 0, 22, 5], np.int32)
        np.testing.assert_allclose(
            tm.predict_user_block(torch.from_numpy(block).long()).numpy(),
            np.asarray(jm.predict_user_block(params, frozen, jnp.asarray(block))),
            **TOL,
        )


def test_init_shapes_and_generator():
    g = torch.Generator().manual_seed(7)
    m = BPRMF(10, 30, embed_k=8, device="cpu", generator=g)
    assert m.Gu.shape == (10, 8) and m.Gi.shape == (30, 8) and m.Bi.shape == (30,)
    assert m.device.type == "cpu"
    assert float(m.Bi.detach().abs().max()) == 0.0
    # glorot bound sqrt(6 / (fan_in + fan_out))
    assert float(m.Gi.detach().abs().max()) <= np.sqrt(6.0 / 38)
    again = BPRMF(10, 30, embed_k=8, device="cpu",
                  generator=torch.Generator().manual_seed(7))
    assert torch.equal(m.Gu, again.Gu) and torch.equal(m.Gi, again.Gi)


def test_convert_rejects_bad_params():
    good = {"Gu": np.zeros((3, 4), np.float32), "Gi": np.zeros((5, 4), np.float32),
            "Bi": np.zeros(5, np.float32)}
    with pytest.raises(ValueError, match="float32"):
        bprmf_from_jax({**good, "Gu": good["Gu"].astype(np.float64)}, device="cpu")
    with pytest.raises(ValueError, match="inconsistent"):
        bprmf_from_jax({**good, "Bi": np.zeros(4, np.float32)}, device="cpu")
