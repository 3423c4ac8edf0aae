"""Port ``ops/counts.py`` (the plain version of kernel K2, which CPU tensors
take) against the JAX package's Pallas kernel in interpret mode.

Quantized data (multiples of 1/4, D=16: every score exact in f32), with
-1 pads, duplicate banned ids, out-of-range ids, pad users and pad items,
and T > 1 reference columns: the counts must be bit-equal.  The geometry
checks raise as the JAX package's do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.ops import counts as J
from fashionvisualexpl_tpu.ops.topk import bucket_banned_ids
from fashionvisualexpl_tpu_torch.ops import counts as P


def _inputs(seed, Bu, I, D, T, Pb, with_bias=True):
    rng = np.random.default_rng(seed)
    q = lambda a: (np.round(a * 4) / 4).astype(np.float32)
    uf, iv, ref = q(rng.normal(size=(Bu, D))), q(rng.normal(size=(I, D))), q(rng.normal(size=(Bu, T)))
    ib = q(rng.normal(size=I)) if with_bias else None
    banned = rng.integers(-1, I + 3, size=(Bu, Pb)).astype(np.int32)
    banned[0, :] = -1
    if Bu > 1 and Pb > 1:
        banned[1, 1] = banned[1, 0]
    return uf, iv, ib, ref, banned


@pytest.mark.parametrize("Bu,I,T,Pb,item_block,user_tile,with_bias", [
    (48, 1000, 3, 9, 256, 16, True),  # ragged users and items: pads both
    (5, 300, 1, 4, 128, 256, True),  # fewer users than a tile (ut = 8)
    (33, 512, 2, 21, 256, 8, False),  # no bias (zeros), items a tile multiple
])
def test_streaming_counts_kernel_bit_equal_to_pallas(Bu, I, T, Pb, item_block, user_tile,
                                                      with_bias):
    uf, iv, ib, ref, banned = _inputs(Bu, Bu, I, 16, T, Pb, with_bias)
    loc, msk = bucket_banned_ids(banned, I, item_block)
    want = J.streaming_counts_pallas(
        jnp.asarray(uf), jnp.asarray(iv), None if ib is None else jnp.asarray(ib),
        jnp.asarray(ref), jnp.asarray(loc), jnp.asarray(msk), item_block=item_block,
        user_tile=user_tile, interpret=True)
    before = P.counts_kernel.launches
    got = P.streaming_counts_kernel(
        torch.from_numpy(uf), torch.from_numpy(iv),
        None if ib is None else torch.from_numpy(ib), torch.from_numpy(ref),
        torch.from_numpy(loc), torch.from_numpy(msk), item_block=item_block,
        user_tile=user_tile)
    assert P.counts_kernel.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.int32 and got.shape == (Bu, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_counts_kernel_bit_equal_with_pads_and_nan():
    """counts_kernel at its own contract: pad items at -inf bias, a pad
    user at +inf ref, and a NaN score never count."""
    Bu, Ip, tile = 16, 512, 256
    uf, iv, ib, ref, banned = _inputs(9, Bu, Ip, 16, 2, 6)
    ib[-40:] = -np.inf
    ref[-1] = np.inf
    uf[3, 0] = np.nan
    loc, msk = bucket_banned_ids(banned, Ip, tile)
    loc = np.where(msk, loc, -1).astype(np.int32)
    want = J.counts_kernel(*(jnp.asarray(a) for a in (uf, iv, ib, ref, loc)),
                           item_tile=tile, user_tile=8, interpret=True)
    got = P.counts_kernel(*(torch.from_numpy(a) for a in (uf, iv, ib, ref, loc)),
                          item_tile=tile, user_tile=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[-1] == 0).all() and (got.numpy()[3] == 0).all()


@pytest.mark.parametrize("what", ["items", "users", "tiles"])
def test_geometry_errors_raise_as_jax(what):
    Bu, Ip, tile, ut = 16, 512, 256, 8
    uf, iv, ib, ref, _ = _inputs(1, Bu, Ip, 16, 1, 2)
    loc = np.full((Ip // tile, Bu, 1), -1, np.int32)
    if what == "items":
        iv, ib, loc = iv[:500], ib[:500], loc
    elif what == "users":
        ut = 5
    else:
        loc = loc[:1]
    jargs = [jnp.asarray(a) for a in (uf, iv, ib, ref, loc)]
    pargs = [torch.from_numpy(np.ascontiguousarray(a)) for a in (uf, iv, ib, ref, loc)]
    with pytest.raises(ValueError) as jerr:
        J.counts_kernel(*jargs, item_tile=tile, user_tile=ut, interpret=True)
    with pytest.raises(ValueError) as perr:
        P.counts_kernel(*pargs, item_tile=tile, user_tile=ut)
    key = "banned buckets" if what == "tiles" else "geometry"
    assert key in str(jerr.value) and key in str(perr.value)
