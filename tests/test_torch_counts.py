"""Port ``ops/counts.py`` (the plain version of kernel K2, which CPU tensors
take) against the JAX package's Pallas kernel in interpret mode.

Quantized data (multiples of 1/4, D=16 and VBPR's D=148: every score exact
in f32), with -1 pads, duplicate banned ids, out-of-range ids, pad users and
pad items, and T > 1 reference columns: the counts must be bit-equal.  The geometry
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


@pytest.mark.parametrize("Bu,I,D,T,Pb,item_block,user_tile,with_bias", [
    (48, 1000, 16, 3, 9, 256, 16, True),  # ragged users and items: pads both
    (5, 300, 16, 1, 4, 128, 256, True),  # fewer users than a tile (ut = 8)
    (33, 512, 16, 2, 21, 256, 8, False),  # no bias (zeros), items a tile multiple
    (40, 700, 148, 3, 9, 256, 16, True),  # D in chunks on the card: pads, T = 3
    (24, 512, 148, 1, 4, 128, 8, False),  # ... and no bias
])
def test_streaming_counts_kernel_bit_equal_to_pallas(Bu, I, D, T, Pb, item_block, user_tile,
                                                      with_bias):
    uf, iv, ib, ref, banned = _inputs(Bu, Bu, I, D, T, Pb, with_bias)
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


# --- the CUDA kernel's recheck band, on the CPU --------------------------
# The kernel scores every pair in bf16x3 on the tensor cores and scores
# again exactly (one f32 fmaf chain in ascending d, then + ib) every pair
# whose approximate score lies within ops/counts.py::band_eps of a
# reference.  Here a plain numpy emulation of that arithmetic (the split of
# mma.cuh::split_bf16x2, round to nearest even onto bf16 by bit masking,
# and an f32 accumulation that truncates after every single product, the
# order of counts.cu: per 16-deep step lo.hi', then hi.lo', then hi.hi')
# must stay within band_eps of the fmaf-chain score on every pair.  Above
# D = 128 the kernel stages D in chunks (of 80 columns at D = 148) but keeps
# the accumulators across them and runs the k16 steps in ascending order:
# the emulation's single ascending pass over the k16 steps is that order.

def _bf16_rne(x):
    """Round f32 onto bf16 to nearest, ties to even (bit masking)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
    return ((b + bias) & np.uint32(0xFFFF0000)).view(np.float32)


def _split(x):
    """mma.cuh::split_bf16x2: hi = rn_bf16(x), lo = rn_bf16(x - hi)."""
    x = np.asarray(x, np.float32)
    hi = _bf16_rne(x)
    return hi, _bf16_rne(x - hi)


def _trunc_f32(v):
    """float64 -> float32, rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _emulated_bf16x3(uf, iv, ib):
    """[B, I] f32 scores s~ = acc + ib as the kernel forms them, every
    accumulation truncated (products of bf16 values are exact in float64)."""
    D = uf.shape[1]
    uh, ul = _split(uf)
    vh, vl = _split(iv)
    acc = np.zeros((uf.shape[0], iv.shape[0]), np.float32)
    for k0 in range(0, D, 16):
        ks = range(k0, min(k0 + 16, D))
        for a, b in ((ul, vh), (uh, vl), (uh, vh)):
            for k in ks:
                p = a[:, k, None].astype(np.float64) * b[None, :, k].astype(np.float64)
                acc = _trunc_f32(acc.astype(np.float64) + p)
    return (acc + ib[None, :]).astype(np.float32)


def _fmaf_chain(uf, iv, ib):
    """[B, I] f32 scores of the exact path: fmaf in ascending d from 0
    (each step through float64: the f32 product is exact there), + ib."""
    x = np.zeros((uf.shape[0], iv.shape[0]), np.float32)
    for d in range(uf.shape[1]):
        p = uf[:, d, None].astype(np.float64) * iv[None, :, d].astype(np.float64)
        x = (p + x.astype(np.float64)).astype(np.float32)
    return (x + ib[None, :]).astype(np.float32)


def _band_rows(kind, D, seed):
    rng = np.random.default_rng(seed)
    B, I = 12, 48
    if kind == "gaussian":
        uf, iv = rng.normal(size=(B, D)), rng.normal(size=(I, D)) * 0.3
        ib = rng.normal(size=I) * 0.1
    elif kind == "heavy":  # Student t, 1.5 degrees of freedom: huge outliers
        uf, iv = rng.standard_t(1.5, size=(B, D)), rng.standard_t(1.5, size=(I, D))
        ib = rng.standard_t(1.5, size=I)
    else:  # cancelling: large +- terms, dot products near 0
        big_u, big_v = rng.normal(size=(B, 1)) * 1e3, rng.normal(size=(I, 1)) * 1e3
        sign = np.where(np.arange(D) % 2 == 0, 1.0, -1.0)
        uf = big_u * np.ones(D) + rng.normal(size=(B, D))
        iv = big_v * sign + rng.normal(size=(I, D)) * 1e-3
        if D % 2:  # an odd D leaves one large term: cancel it too
            iv[:, -1] = rng.normal(size=I) * 1e-3
        ib = rng.normal(size=I) * 1e-2
    return (uf.astype(np.float32), iv.astype(np.float32), ib.astype(np.float32))


@pytest.mark.parametrize("kind", ["gaussian", "heavy", "cancelling"])
@pytest.mark.parametrize("D", [16, 33, 128, 148, 300])
def test_emulated_bf16x3_stays_within_the_band(kind, D):
    uf, iv, ib = _band_rows(kind, D, seed=D)
    assert np.array_equal(_bf16_rne(uf), torch.from_numpy(uf).bfloat16().float().numpy())
    approx = _emulated_bf16x3(uf, iv, ib).astype(np.float64)
    exact = _fmaf_chain(uf, iv, ib).astype(np.float64)
    eps = P.band_eps(torch.from_numpy(uf), torch.from_numpy(iv),
                     torch.from_numpy(ib)).numpy()
    assert eps.shape == approx.shape
    gap = np.abs(approx - exact)
    assert np.isfinite(gap).all()
    assert (gap <= eps).all(), float((gap / eps).max())
    # the kernel's decision with refs on the exact scores and one f32 ulp off
    # them: a pair decided directly (|s~ - r| > eps) counts as the exact one
    for ref in (exact, np.nextafter(exact.astype(np.float32), np.float32(np.inf)),
                np.nextafter(exact.astype(np.float32), np.float32(-np.inf))):
        ref = np.asarray(ref, np.float64)[:, :1]
        d = approx - ref
        direct = np.abs(d) > eps
        np.testing.assert_array_equal((d > 0)[direct], (exact >= ref)[direct])


@pytest.mark.parametrize("D", [1, 6, 16, 128, 148, 1024])
def test_worst_case_split_stays_within_the_band(D):
    """Rows whose every coordinate is a worst case of the bf16 split
    (ops/counts.py::band_worst_case): the emulated score misses the exact
    one by about 2^-15 a product, more than a band of (4D + 100) * 2^-22
    would hold at D <= 6, and still within band_eps; with refs between the
    two scores, a direct decision is right and the counts are the exact
    ones."""
    uf, iv, ib, ref, want = P.band_worst_case(D, seed=D)
    u, v, b = uf.numpy(), iv.numpy(), ib.numpy()
    approx = _emulated_bf16x3(u, v, b).astype(np.float64)
    exact = _fmaf_chain(u, v, b).astype(np.float64)
    eps = P.band_eps(uf, iv, ib).numpy()
    gap = np.abs(approx - exact)
    assert (gap <= eps).all(), float((gap / eps).max())
    unit = 2.0**-22 * np.outer(np.linalg.norm(u.astype(np.float64), axis=1),
                               np.linalg.norm(v.astype(np.float64), axis=1))
    miss = float((gap / unit).min())
    assert miss > max(120, 4 * D + 100 if D <= 6 else 0), miss
    r = ref.numpy().astype(np.float64)
    d = approx - r
    direct = np.abs(d) > eps
    np.testing.assert_array_equal((d > 0)[direct], (exact >= r)[direct])
    np.testing.assert_array_equal((exact >= r).sum(axis=1), want[:, 0].numpy())
    assert ((approx < r) & (exact >= r)).any()  # refs between s~ and s
    banned = torch.full((1, uf.shape[0], 1), -1, dtype=torch.int32)
    got = P.counts_kernel(uf, iv, ib, ref, banned, item_tile=128, user_tile=8)
    assert torch.equal(got, want)


def test_band_eps_scale_and_infinite_bias():
    """band_scale multiplies the band (infinity sends every pair to the
    exact chain); an infinite bias adds nothing to it (both scores are then
    the same infinity)."""
    uf = torch.tensor([[3.0, 4.0]])
    iv = torch.tensor([[1.0, 0.0], [0.0, 2.0]])
    ib = torch.tensor([0.5, -float("inf")])
    eps = P.band_eps(uf, iv, ib)
    want = 1.001 * ((4 * 2 + 300) * 2.0**-22 * 5.0 * torch.tensor([1.0, 2.0], dtype=torch.float64)
                    + 2.0**-22 * torch.tensor([0.5, 0.0], dtype=torch.float64)) + 2.0**-100
    torch.testing.assert_close(eps[0], want, rtol=1e-12, atol=0)
    assert torch.isinf(P.band_eps(uf, iv, ib, band_scale=float("inf"))).all()
    with pytest.raises(ValueError, match="_band_scale"):
        P.counts_kernel(uf, iv, ib, torch.zeros(1, 1), torch.full((1, 1, 1), -1, dtype=torch.int32),
                        item_tile=2, user_tile=1, _band_scale=0.5)
