"""Port losses vs the JAX package: ``l2_loss``, ``bpr_pairwise_loss`` and
``BPRMF.loss`` with its gradients, on the same numpy-seeded inputs.
Tolerance rtol 1e-5 (f32 sums in another order; atol 1e-7 for gradient
entries that are near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.models import base as jbase
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu_torch.models import base as tbase
from fashionvisualexpl_tpu_torch.models.convert import bprmf_from_jax

TOL = dict(rtol=1e-5, atol=1e-7)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_l2_and_pairwise_loss_match_jax(scale):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(40, 7)) * scale).astype(np.float32)
    np.testing.assert_allclose(
        float(tbase.l2_loss(_t(x))), float(jbase.l2_loss(jnp.asarray(x))), **TOL
    )
    # scale 30 pushes differences past the -80 clip
    xp = (rng.normal(size=200) * scale).astype(np.float32)
    xn = (rng.normal(size=200) * scale).astype(np.float32)
    tp, tn = _t(xp).requires_grad_(), _t(xn).requires_grad_()
    got = tbase.bpr_pairwise_loss(tp, tn)
    gp, gn = torch.autograd.grad(got, (tp, tn))
    want, (jgp, jgn) = jax.value_and_grad(jbase.bpr_pairwise_loss, argnums=(0, 1))(
        jnp.asarray(xp), jnp.asarray(xn)
    )
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), **TOL)
    np.testing.assert_allclose(gn.numpy(), np.asarray(jgn), **TOL)


def test_bprmf_loss_and_grads_match_jax():
    U, I, K, B, reg = 17, 29, 8, 64, 0.05
    jm = JBPRMF(U, I, embed_k=K)
    params, frozen = jm.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    params["Bi"] = jnp.asarray(rng.normal(size=I).astype(np.float32))
    users = rng.integers(0, U, B).astype(np.int32)
    pos = rng.integers(0, I, B).astype(np.int32)
    neg = rng.integers(0, I, B).astype(np.int32)

    want, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, frozen, users, pos, neg, reg)
    )(params)
    tm = bprmf_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    got = tm.loss(_t(users).long(), _t(pos).long(), _t(neg).long(), reg)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   err_msg=name, **TOL)
