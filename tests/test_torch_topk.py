"""Port ``ops/topk.py`` against the JAX package, function by function.

Tie-storm data: factors quantized to multiples of 1/4 at D=16, so every
score is exact in f32 whatever the summation order and ties are
everywhere.  Counts, bucket tensors and widths must then be bit-equal.
Top-k ids are compared on tie-free data only (``torch.topk`` and
``approx_max_k`` order ties differently); on tie data the values are."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.ops import topk as J
from fashionvisualexpl_tpu_torch.ops import topk as P

Bu, I, D, T, Pb = 40, 1000, 16, 3, 9


def _q(a):
    return (np.round(a * 4) / 4).astype(np.float32)


def _inputs(seed, quantized=True):
    rng = np.random.default_rng(seed)
    f = _q if quantized else (lambda a: a.astype(np.float32))
    uf, iv, ib = f(rng.normal(size=(Bu, D))), f(rng.normal(size=(I, D))), f(rng.normal(size=I))
    ref = f(rng.normal(size=(Bu, T)))
    banned = np.stack([rng.choice(I, size=Pb, replace=False) for _ in range(Bu)]).astype(np.int32)
    banned[0, :3] = -1  # pad convention
    banned[1, 4] = banned[1, 3]  # duplicates exclude once
    banned[2, 0] = I + 5  # out of range: dropped
    return uf, iv, ib, ref, banned


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(0)
    rv = -np.sort(-rng.normal(size=(6, 5)).astype(np.float32), axis=1)
    bv = rng.normal(size=(6, 7)).astype(np.float32)
    ri = rng.integers(0, 100, (6, 5)).astype(np.int32)
    bi = rng.integers(100, 200, (6, 7)).astype(np.int32)
    jv, ji = J._merge_topk(*_j(rv, ri, bv, bi), 5)
    pv, pi = P._merge_topk(*_t(rv, ri, bv, bi), 5)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("item_block", [7, 256, 4096])
@pytest.mark.parametrize("with_bias", [True, False])
def test_streaming_counts_bit_equal(item_block, with_bias):
    uf, iv, ib, ref, banned = _inputs(1)
    ib_ = ib if with_bias else None
    want = J.streaming_counts(*_j(uf, iv), None if ib_ is None else jnp.asarray(ib_),
                              jnp.asarray(ref), jnp.asarray(banned), item_block=item_block,
                              item_offset=3)
    got = P.streaming_counts(*_t(uf, iv), None if ib_ is None else torch.from_numpy(ib_),
                             torch.from_numpy(ref), torch.from_numpy(banned),
                             item_block=item_block, item_offset=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # no exclusions
    want = J.streaming_counts(*_j(uf, iv, ib, ref), None, item_block=item_block)
    got = P.streaming_counts(*_t(uf, iv, ib, ref), None, item_block=item_block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("item_block", [64, 300])
def test_streaming_topk_and_counts_matches_jax(item_block):
    k = 12
    uf, iv, ib, ref, banned = _inputs(2, quantized=False)  # tie-free top-k
    jv, ji, jc = J.streaming_topk_and_counts(*_j(uf, iv, ib), k, jnp.asarray(ref),
                                             jnp.asarray(banned), item_block=item_block)
    pv, pi, pc = P.streaming_topk_and_counts(*_t(uf, iv, ib), k, torch.from_numpy(ref),
                                             torch.from_numpy(banned), item_block=item_block)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    # counts on quantized data, bit-equal; a catalog smaller than k fills
    # with -inf and OUT_OF_RANGE_ID
    uf, iv, ib, ref, banned = _inputs(3)
    _, _, jc = J.streaming_topk_and_counts(*_j(uf, iv, ib), k, jnp.asarray(ref),
                                           jnp.asarray(banned), item_block=item_block)
    _, _, pc = P.streaming_topk_and_counts(*_t(uf, iv, ib), k, torch.from_numpy(ref),
                                           torch.from_numpy(banned), item_block=item_block)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    jv, ji, none = J.streaming_topk_and_counts(*_j(uf, iv[:5], ib[:5]), 8, item_block=4)
    pv, pi, pnone = P.streaming_topk_and_counts(*_t(uf, iv[:5], ib[:5]), 8, item_block=4)
    assert none is None and pnone is None
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert (pi.numpy()[:, 5:] == P.OUT_OF_RANGE_ID).all()
    np.testing.assert_array_equal(np.sort(pi.numpy()[:, :5], 1), np.sort(np.asarray(ji)[:, :5], 1))


@pytest.mark.parametrize("item_block", [100, 256, 5000])
def test_bucketing_bit_equal(item_block):
    uf, iv, ib, ref, banned = _inputs(4)
    np.testing.assert_array_equal(
        np.concatenate(P._bucket_positions(banned, I, min(item_block, I))[1:]),
        np.concatenate(J._bucket_positions(banned, I, min(item_block, I))[1:]))
    W = P.banned_bucket_width(banned, I, item_block, chunk=17)
    assert W == J.banned_bucket_width(banned, I, item_block, chunk=17)
    loc, msk = P.bucket_banned_ids(banned, I, item_block, width=W)
    jloc, jmsk = J.bucket_banned_ids(banned, I, item_block, width=W)
    np.testing.assert_array_equal(loc, jloc)
    np.testing.assert_array_equal(msk, jmsk)
    dloc, dmsk = P.bucket_banned_ids_device(torch.from_numpy(banned), I, item_block, W)
    jdloc, jdmsk = jax.jit(lambda b: J.bucket_banned_ids_device(b, I, item_block, W))(
        jnp.asarray(banned))
    np.testing.assert_array_equal(dloc.numpy(), np.asarray(jdloc))
    np.testing.assert_array_equal(dmsk.numpy(), np.asarray(jdmsk))
    np.testing.assert_array_equal(dloc.numpy(), loc)
    # the bucketed scan equals the id-mask scan
    want = J.streaming_counts(*_j(uf, iv, ib, ref, banned), item_block=item_block)
    got = P.streaming_counts_bucketed(*_t(uf, iv, ib, ref), dloc, dmsk, item_block=item_block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jgot = J.streaming_counts_bucketed(*_j(uf, iv, ib, ref, loc, msk), item_block=item_block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_pinned_width_rejects_overflow():
    _, _, _, _, banned = _inputs(5)
    W = P.banned_bucket_width(banned, I, 256)
    assert W > 1  # Pb=9 over 4 blocks guarantees a bucket of two or more
    with pytest.raises(ValueError, match="exceeds pinned"):
        P.bucket_banned_ids(banned, I, 256, width=W - 1)
    loc, msk, over = P.bucket_banned_ids_device(torch.from_numpy(banned), I, 256, W - 1,
                                                return_overflow=True)
    jloc, jmsk, jover = J.bucket_banned_ids_device(jnp.asarray(banned), I, 256, W - 1,
                                                   return_overflow=True)
    assert int(over) == int(jover) > 0
    np.testing.assert_array_equal(loc.numpy(), np.asarray(jloc))
    np.testing.assert_array_equal(msk.numpy(), np.asarray(jmsk))
    with pytest.raises(ValueError, match="blocks"):
        P.streaming_counts_bucketed(*_t(*_inputs(5)[:4]), loc, msk, item_block=128)


def test_filter_items_topk_matches_jax():
    rng = np.random.default_rng(6)
    vals = -np.sort(-rng.normal(size=(10, 15)).astype(np.float32), axis=1)
    idx = np.stack([rng.choice(50, 15, replace=False) for _ in range(10)]).astype(np.int32)
    banned = idx[:, ::3].copy()
    counts = rng.integers(0, banned.shape[1] + 1, 10).astype(np.int32)
    jv, ji = J.filter_items_topk(*_j(vals, idx, banned, counts), 6)
    pv, pi = P.filter_items_topk(*_t(vals, idx, banned, counts), 6)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
