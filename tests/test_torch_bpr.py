"""Port K1 (fused BPR loss) vs the JAX package: the plain forward/backward
pair that the CUDA kernels mirror, on the same numpy-seeded inputs, against
``bpr_triplet_loss(..., interpret=True)`` and ``bpr_triplet_loss_reference``.
Loss rtol 1e-5 (f32 sums in another order); gradients rtol 1e-4, atol 1e-6
(the kernel's association (bp - bn) + sum(gu * (gp - gn)) against autodiff
of the reference's); the clip case at input scale 20."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.ops import bpr as jbpr
from fashionvisualexpl_tpu_torch.ops import bpr as tbpr

LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _inputs(B, K, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    rows = [(rng.normal(size=(B, K)) * scale).astype(np.float32) for _ in range(3)]
    vecs = [rng.normal(size=B).astype(np.float32) for _ in range(2)]
    return rows + vecs


@pytest.mark.parametrize("B,K,tile,scale", [
    (64, 16, 16, 1.0), (100, 8, 32, 1.0), (8, 128, 8, 1.0), (48, 12, 16, 20.0),
])
def test_loss_and_grads_match_jax_kernel(B, K, tile, scale):
    arrays = _inputs(B, K, seed=B, scale=scale)
    jargs = [jnp.asarray(a) for a in arrays]
    want, jgrads = jax.value_and_grad(
        lambda *a: jbpr.bpr_triplet_loss(*a, tile, True), argnums=(0, 1, 2, 3, 4)
    )(*jargs)
    ref = jbpr.bpr_triplet_loss_reference(*jargs)
    ref_grads = jax.grad(jbpr.bpr_triplet_loss_reference,
                         argnums=(0, 1, 2, 3, 4))(*jargs)

    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = (tbpr.bpr_forward.launches, tbpr.bpr_backward.launches)
    got = tbpr.bpr_triplet_loss(*targs)
    tgrads = torch.autograd.grad(got, targs)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (tbpr.bpr_forward.launches, tbpr.bpr_backward.launches) == before

    got = float(got.detach())
    np.testing.assert_allclose(got, float(want), **LOSS_TOL)
    np.testing.assert_allclose(got, float(ref), **LOSS_TOL)
    plain = tbpr.bpr_triplet_loss_reference(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(float(plain), float(ref), **LOSS_TOL)
    for name, g, jg, rg in zip(("gu", "gp", "gn", "bp", "bn"), tgrads, jgrads,
                               ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), err_msg=name,
                                   **GRAD_TOL)


def test_sigma_residual_matches_jax_and_is_zero_at_the_clip():
    arrays = _inputs(40, 8, seed=3, scale=20.0)
    _, jsigma = jbpr._fwd_pallas(*(jnp.asarray(a) for a in arrays), 16, True)
    loss, sigma = tbpr.bpr_forward(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-5, atol=1e-7)
    gu, gp, gn, bp, bn = arrays
    diff = (bp - bn) + np.sum(gu * (gp - gn), axis=1)
    clipped = (diff <= jbpr.CLIP_LO) | (diff >= jbpr.CLIP_HI)
    assert clipped.any() and (sigma.numpy()[clipped] == 0).all()
    assert loss.shape == () and sigma.shape == (40,)


def test_backward_scales_by_the_upstream_gradient():
    arrays = [torch.from_numpy(a) for a in _inputs(10, 4, seed=5)]
    _, sigma = tbpr.bpr_forward(*arrays)
    one = tbpr.bpr_backward(sigma, *arrays[:3], torch.tensor(1.0))
    three = tbpr.bpr_backward(sigma, *arrays[:3], torch.tensor(3.0))
    for a, b in zip(one, three):
        torch.testing.assert_close(b, 3.0 * a, rtol=1e-6, atol=0.0)


def test_wrappers_reject_bad_inputs():
    gu, gp, gn, bp, bn = (torch.from_numpy(a) for a in _inputs(6, 4))
    with pytest.raises(ValueError, match="float32"):
        tbpr.bpr_forward(gu.double(), gp, gn, bp, bn)
    with pytest.raises(ValueError, match=r"\[6\]"):
        tbpr.bpr_forward(gu, gp, gn, bp[:5], bn)
    with pytest.raises(ValueError, match="alike"):
        tbpr.bpr_forward(gu, gp[:, :3], gn, bp, bn)


@pytest.mark.parametrize("B,K", [(1, 128), (31, 8), (32, 8), (33, 128), (8191, 128),
                                 (8193, 129), (65537, 512), (100, 7), (5, 60000)])
@pytest.mark.parametrize("aligned", [True, False])
def test_forward_tiles_cover_every_triple_once(B, K, aligned):
    route, T, blocks = tbpr.fwd_tiles(B, K, aligned)
    assert T == tbpr.FWD_TILES[route] and blocks == -(-B // T)
    covered = np.zeros(B, dtype=np.int64)
    for i in range(blocks):  # block i's tile, the last one ragged
        covered[i * T:min((i + 1) * T, B)] += 1
    assert (covered == 1).all()
    assert (blocks - 1) * T < B <= blocks * T


def test_forward_reads_float4_columns_only_where_they_are_legal():
    # the training shape: 32 triples a block, 256 blocks (one wave)
    assert tbpr.fwd_tiles(8192, 128, True) == ("vec", 32, 256)
    # K*4 not a multiple of 16, or a pointer off 16 bytes: scalar loads
    for K in (1, 7, 129, 130):
        assert tbpr.fwd_tiles(8192, K, True) == ("plain", 16, 512)
    assert tbpr.fwd_tiles(8192, 128, False) == ("plain", 16, 512)
    # any width takes the vec route when aligned (no shared memory for rows)
    assert tbpr.fwd_tiles(4096, 60000, True) == ("vec", 32, 128)
    # B below the tile: one block, masked to B triples
    assert tbpr.fwd_tiles(1, 128, True) == ("vec", 32, 1)
    assert tbpr.fwd_tiles(15, 7, True) == ("plain", 16, 1)
