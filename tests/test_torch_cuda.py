"""Port on the CUDA card: the segmax kernel against its plain version,
RecServer's on-card stage-1 paths against a full-catalog oracle, the
training kernels (fused BPR loss K1, fused Adam sweep K6) and the
streaming-eval counts kernel K2 against theirs.

Imports no jax, so it runs where JAX is absent:
``python -m pytest tests/test_torch_cuda.py --noconftest``.  Without a card
every test skips.  Kernel tolerance atol 1e-4, rtol 1e-5: the kernel sums
the D products sequentially in f32 FMAs, cuBLAS in another order, on scores
of magnitude up to ~20.  K1: loss rtol 1e-5 (another summation order),
sigma rtol 1e-4, atol 1e-5 * scale**2 (diff's K products are summed with
FMAs in lane order, and their rounding grows with the products); the
gradients, from the same sigma, rtol 1e-4, atol 1e-5; the forward on both
of its routes (float4 and scalar loads) is bit-equal from run to run.
K6: the same f32 operations in the same order, m and v rtol 1e-6, p rtol
1e-5.  K2: counts bit-equal on quantized data (every
score exact in f32, so any summation order gives the same bits).  K7 (the
edge tower): forward rtol 1e-5, atol 1e-6 (25 taps and the pooled values
summed in another order; the forward's exact bf16 pieces on the tensor
cores, also on worst-case splits), two forward runs bit-equal; gradients rtol 1e-4, atol 1e-5 + 1e-6 * S, S the
sum of |terms| (the plain backward of |dout|), as in ``chip_smoke.py``; two
backward runs bit-equal (no float atomics).  K4 (row gather) and K5 (row
scatter-set): bit-equal to their plain versions (compared as int32) at the
packed rows' widths, aligned and not, with out-of-range, negative and pad
ids.  The packed step on the card against the same step on CPU copies: 4
K4 + 2 K5 launches a step; losses rtol 1e-5; tau columns and untouched
rows bit-equal; touched rows rtol 2e-4, atol 1e-6, where at most 0.1% of
the values may sit one stored moment code apart (``index_add_`` sums a
row's duplicate gradients with atomics, in no fixed order, so a value at a
bf16 or e5m2 rounding boundary may round the other way)."""

import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.ops import adam as A
from fashionvisualexpl_tpu_torch.ops import bpr as K1
from fashionvisualexpl_tpu_torch.ops import counts as K2
from fashionvisualexpl_tpu_torch.ops import edge_tower as K7
from fashionvisualexpl_tpu_torch.ops import gather as K4
from fashionvisualexpl_tpu_torch.ops import row_scatter as K5
from fashionvisualexpl_tpu_torch.ops import segmax as S
from fashionvisualexpl_tpu_torch.serve import RecServer
from fashionvisualexpl_tpu_torch.train import packed_generic as PG
from fashionvisualexpl_tpu_torch.train.fast import (
    init_fast_state,
    make_fast_bprmf_step,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [1, 8, 30, 32, 64, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, seg):
    g = torch.Generator(device=cuda_device).manual_seed(seg)
    B, D, Ip = 37, 100, seg * 47
    uf = (torch.randn(B, D, device=cuda_device, generator=g) * 0.3).to(dtype)
    iv = torch.randn(Ip, D, device=cuda_device, generator=g).to(dtype)
    ib = torch.randn(Ip, device=cuda_device, generator=g)
    ib[-seg - 3:] = -1e30
    before = S.segmax_scores.launches
    got = S.segmax_scores(uf, iv, ib, seg)
    torch.cuda.synchronize()
    assert S.segmax_scores.launches == before + 1
    want = S.segmax_scores_reference(uf, iv, ib, seg)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,D,seg,n_seg", [
    (100, 128, 16, 300), (100, 128, 64, 90), (100, 128, 128, 40), (100, 128, 1024, 5),
    (4097, 64, 32, 70), (4097, 128, 32, 70), (8, 128, 8, 500), (37, 33, 32, 50),
    (100, 33, 24, 40), (20, 600, 32, 10), (8, 128, 16, 300), (64, 128, 64, 90),
    (8, 128, 24, 40), (64, 128, 1024, 5), (8, 128, 4096, 1),
    (8, 64, 32, 70), (100, 16, 32, 70), (100, 72, 16, 90), (8, 72, 8, 90),
    (8, 200, 32, 10),
])
def test_kernel_geometries_match_plain_version_on_card(cuda_device, dtype, B, D, seg, n_seg):
    """The tensor-core kernels' paths (D a multiple of 8 up to 128 with
    the items' fragments in registers, D not a multiple of 8 or above 128
    from shared memory, seg a multiple of 32, 16 or 8 or none, seg above
    the block's item tile, B not a multiple of 8 or 16) and the CUDA-core
    body (f32, D = 600)."""
    g = torch.Generator(device=cuda_device).manual_seed(B + D + seg)
    Ip = seg * n_seg
    uf = (torch.randn(B, D, device=cuda_device, generator=g) * (3 / D**0.5)).to(dtype)
    iv = torch.randn(Ip, D, device=cuda_device, generator=g).to(dtype)
    ib = torch.randn(Ip, device=cuda_device, generator=g) * 0.1
    ib[-seg - 3:] = -1e30
    got = S.segmax_scores(uf, iv, ib, seg)
    torch.cuda.synchronize()
    want = S.segmax_scores_reference(uf, iv, ib, seg)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_on_card(cuda_device):
    uf = torch.zeros(4, 8, device=cuda_device).T  # [8, 4], column-major
    iv = torch.zeros(64, 8, device=cuda_device)[:, :4]  # [64, 4], strided
    with pytest.raises(ValueError, match="contiguous"):
        S.segmax_scores(uf, iv, torch.zeros(64, device=cuda_device), 8)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw", [dict(), dict(stage1_dtype="fp32", oversample=1),
           dict(quantized=True, oversample=4)],
    ids=["bf16-kernel", "fp32", "int8"],
)
def test_recserver_on_card_matches_oracle(cuda_device, kw):
    U, I, K, k = 300, 5000, 32, 10
    data = synthetic_interactions(U, I, interactions_per_user=8, seed=0)
    model = BPRMF(U, I, embed_k=K, device=cuda_device,
                  generator=torch.Generator(device=cuda_device).manual_seed(1))
    with torch.no_grad():
        model.Bi.normal_(0.0, 0.01, generator=torch.Generator(
            device=cuda_device).manual_seed(2))
    srv = RecServer(model, data, k=k, seg=32, item_block=1024, **kw)
    srv.refresh()
    before = S.segmax_scores.launches
    ids, vals = srv.query(np.arange(U))
    assert (S.segmax_scores.launches > before) == ("stage1_dtype" not in kw
                                                   and "quantized" not in kw)
    with torch.no_grad():
        scores = model.predict_all().double().cpu().numpy()
    for u, row in enumerate(data.training_list):
        scores[u, row] = -np.inf
    o_ids = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(vals, np.take_along_axis(scores, o_ids, 1),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,scale", [(1, 8, 1.0), (100, 64, 1.0), (777, 128, 1.0),
                                       (300, 33, 20.0)])
def test_bpr_kernels_match_plain_versions_on_card(cuda_device, B, K, scale):
    g = torch.Generator(device=cuda_device).manual_seed(B)
    rows = [torch.randn(B, K, device=cuda_device, generator=g) * scale
            for _ in range(3)]
    vecs = [torch.randn(B, device=cuda_device, generator=g) for _ in range(2)]
    args = [x.requires_grad_() for x in rows + vecs]
    before = (K1.bpr_forward.launches, K1.bpr_backward.launches)
    loss = K1.bpr_triplet_loss(*args)
    grads = torch.autograd.grad(loss, args)
    torch.cuda.synchronize()
    assert (K1.bpr_forward.launches, K1.bpr_backward.launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        want_loss, want_sigma = K1.bpr_forward_reference(*args)
        _, sigma = K1.bpr_forward(*args)
        torch.testing.assert_close(loss.detach(), want_loss, rtol=1e-5, atol=0.0)
        # diff's rounding grows with its products, which scale as scale**2
        torch.testing.assert_close(sigma, want_sigma, rtol=1e-4, atol=1e-5 * scale**2)
        want = K1.bpr_backward_reference(sigma, *args[:3],
                                         torch.ones((), device=cuda_device))
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-5)
    if scale > 1:
        assert bool((sigma == 0).any())  # the clip was reached


def _bpr_args(dev, B, K, scale, seed, offset=0):
    """gu, gp, gn [B, K] (times scale) and bp, bn [B]; offset 1 starts each
    tensor one float into its storage, off the 16 bytes a float4 load needs."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(shape, s):
        n = int(np.prod(shape))
        return (torch.randn(n + offset, device=dev, generator=g) * s)[offset:].view(shape)

    return [t((B, K), scale) for _ in range(3)] + [t((B,), 1.0) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 7, 8, 128, 129, 512])
@pytest.mark.parametrize("B", [1, 31, 32, 33, 8191, 8193, 65537])
def test_bpr_forward_routes_match_plain_version_on_card(cuda_device, B, K):
    for offset in (0, 1):  # 1: misaligned, the scalar-load route
        for scale in (1.0, 20.0):  # scale 20 pushes diff past the clip
            args = _bpr_args(cuda_device, B, K, scale, seed=B * K + offset, offset=offset)
            route = K1.fwd_tiles(B, K, offset == 0)[0]
            assert route == ("vec" if offset == 0 and K % 4 == 0 else "plain")
            before = K1.bpr_forward.launches
            loss, sigma = K1.bpr_forward(*args)
            want_loss, want_sigma = K1.bpr_forward_reference(*args)
            torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0.0)
            torch.testing.assert_close(sigma, want_sigma, rtol=1e-4,
                                       atol=1e-5 * scale**2)
            again, sigma2 = K1.bpr_forward(*args)
            torch.cuda.synchronize()
            assert K1.bpr_forward.launches == before + 2  # one launch a call
            # the last block sums the partials in a fixed order: same bits
            assert loss.view(torch.int32).item() == again.view(torch.int32).item()
            assert torch.equal(sigma.view(torch.int32), sigma2.view(torch.int32))
            if scale > 1 and B > 1000:
                assert bool((sigma == 0).any())  # the clip was reached


@pytest.mark.cuda
def test_bpr_forward_workspace_across_calls_and_streams_on_card(cuda_device):
    # back-to-back calls with other grids on one stream (each must find the
    # ticket reset by the last), interleaved with calls on a second stream
    # that may run beside them (its own ticket and partials)
    sizes = (8193, 33, 1, 65537, 32, 8192)
    args = [_bpr_args(cuda_device, B, 128, 1.0, seed=B) for B in sizes]
    main, side = torch.cuda.current_stream(), torch.cuda.Stream()
    side.wait_stream(main)
    got, got_side = [], []
    for a in args:
        got.append(K1.bpr_forward(*a))
        with torch.cuda.stream(side):
            got_side.append(K1.bpr_forward(*a))
    torch.cuda.synchronize()
    assert (args[0][0].device.index, side.cuda_stream) in K1._workspaces
    for a, (loss, sigma), (loss_s, sigma_s) in zip(args, got, got_side):
        want_loss, want_sigma = K1.bpr_forward_reference(*a)
        torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0.0)
        torch.testing.assert_close(sigma, want_sigma, rtol=1e-4, atol=1e-5)
        assert loss.view(torch.int32).item() == loss_s.view(torch.int32).item()
        assert torch.equal(sigma.view(torch.int32), sigma_s.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((1001, 7), 0), ((4099,), 0), ((3,), 0),
                                          ((4099,), 1)])
def test_adam_sweep_matches_plain_version_on_card(cuda_device, shape, offset):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    n = int(torch.tensor(shape).prod())

    def table(scale):  # offset 1: data not 16-byte aligned (scalar loop)
        x = torch.randn(n + offset, device=cuda_device, generator=g) * scale
        return x[offset:].view(shape)

    p, m, v = table(1.0), table(0.1), table(0.1).abs()
    want = [x.clone() for x in (p, m, v)]
    scal = A.adam_scalars(0.01, torch.tensor(5.0, device=cuda_device))
    before = A.fused_adam_sweep.launches
    A.fused_adam_sweep(p, m, v, scal)
    torch.cuda.synchronize()
    assert A.fused_adam_sweep.launches == before + 1
    A.fused_adam_sweep_reference(*want, scal)
    torch.testing.assert_close(m, want[1], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(v, want[2], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(p, want[0], rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_fast_step_kernel_route_matches_plain_route_on_card(cuda_device):
    U, I, K, B = 500, 300, 32, 256
    model = BPRMF(U, I, embed_k=K, device=cuda_device,
                  generator=torch.Generator(device=cuda_device).manual_seed(3))
    params = {k: v.detach() for k, v in model.named_parameters()}
    kern = init_fast_state({k: v.clone() for k, v in params.items()})
    plain = init_fast_state({k: v.clone() for k, v in params.items()})
    step_k = make_fast_bprmf_step(None, 0.01, 0.01, fused_adam=True, pallas_bpr=True)
    step_p = make_fast_bprmf_step(None, 0.01, 0.01)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    before = (K1.bpr_forward.launches, A.fused_adam_sweep.launches)
    for _ in range(4):
        batch = tuple(torch.randint(0, hi, (B,), device=cuda_device, generator=g,
                                    dtype=torch.int32) for hi in (U, I, I))
        kern, lk = step_k(kern, batch)
        plain, lp = step_p(plain, batch)
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=0.0)
    assert (K1.bpr_forward.launches - before[0],
            A.fused_adam_sweep.launches - before[1]) == (4, 12)
    for k in params:
        for field in ("params", "mu", "nu"):
            torch.testing.assert_close(getattr(kern, field)[k], getattr(plain, field)[k],
                                       rtol=2e-4, atol=1e-6)


@pytest.mark.cuda
def test_training_kernels_reject_non_contiguous_on_card(cuda_device):
    x = torch.zeros(8, 6, device=cuda_device)
    vec = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        K1.bpr_forward(x[:, :4], x[:, :4], x[:, :4], vec, vec)
    with pytest.raises(ValueError, match="contiguous"):
        A.fused_adam_sweep(x.T, x.T.contiguous(), x.T.contiguous(),
                           A.adam_scalars(0.01, torch.tensor(1.0, device=cuda_device)))


def _counts_inputs(dev, B, I, D, T, Pb, seed):
    """Quantized inputs (multiples of 1/64, |x| <= 1: every score is exact
    in f32) with -1 pads, duplicate ids, pad users and pad items."""
    rng = np.random.default_rng(seed)
    q = lambda a: torch.tensor(np.clip(np.round(a * 64) / 64, -1, 1),
                               dtype=torch.float32, device=dev)
    uf, iv = q(rng.normal(size=(B, D)) * 0.5), q(rng.normal(size=(I, D)) * 0.5)
    ib, ref = q(rng.normal(size=I)), q(rng.normal(size=(B, T)) * 2)
    banned = rng.integers(-1, I, size=(B, Pb)).astype(np.int32)
    banned[0, :] = -1
    if B > 1 and Pb > 1:
        banned[1, 1] = banned[1, 0]
    return uf, iv, ib, ref, torch.from_numpy(banned).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,D,T,Pb,item_tile", [
    (8, 300, 16, 1, 4, 128), (100, 5000, 128, 3, 9, 2048),
    (257, 4099, 33, 2, 21, 256), (1, 17, 8, 1, 1, 2048),
])
def test_counts_kernel_matches_plain_version_on_card(cuda_device, B, I, D, T, Pb,
                                                     item_tile):
    from fashionvisualexpl_tpu_torch.ops.topk import (
        banned_bucket_width,
        bucket_banned_ids_device,
    )

    uf, iv, ib, ref, banned = _counts_inputs(cuda_device, B, I, D, T, Pb, seed=B)
    W = banned_bucket_width(banned.cpu().numpy(), I, item_tile)
    loc, msk = bucket_banned_ids_device(banned, I, item_tile, W)
    before = K2.counts_kernel.launches
    got = K2.streaming_counts_kernel(uf, iv, ib, ref, loc, msk, item_block=item_tile)
    torch.cuda.synchronize()
    assert K2.counts_kernel.launches == before + 1
    want = K2.streaming_counts_kernel(uf.cpu(), iv.cpu(), ib.cpu(), ref.cpu(),
                                      loc.cpu(), msk.cpu(), item_block=item_tile)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_counts_kernel_quantized_wide_bans_on_card(cuda_device):
    """D = 33 (staged with 4-byte loads), T = 3, and four banned ids of one
    item tile per user (W >= 4): bit-equal to the plain version."""
    from fashionvisualexpl_tpu_torch.ops.topk import (
        banned_bucket_width,
        bucket_banned_ids_device,
    )

    B, I, D, T, tile = 300, 5000, 33, 3, 256
    uf, iv, ib, ref, banned = _counts_inputs(cuda_device, B, I, D, T, 8, seed=33)
    rng = np.random.default_rng(33)
    start = rng.integers(0, I - 4, B)
    start -= start % tile - np.minimum(start % tile, tile - 4)  # 4 ids in one tile
    banned[:, :4] = torch.from_numpy((start[:, None] + np.arange(4)).astype(np.int32)).to(
        cuda_device)
    W = banned_bucket_width(banned.cpu().numpy(), I, tile)
    assert W >= 4
    loc, msk = bucket_banned_ids_device(banned, I, tile, W)
    got = K2.streaming_counts_kernel(uf, iv, ib, ref, loc, msk, item_block=tile)
    want = K2.streaming_counts_kernel(uf.cpu(), iv.cpu(), ib.cpu(), ref.cpu(), loc.cpu(),
                                      msk.cpu(), item_block=tile)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "cancelling"])
def test_counts_kernel_band_equals_exact_chain_on_card(cuda_device, kind):
    """The default band and _band_scale=inf (every pair through the exact
    fmaf chain) give bit-equal counts on data whose scores are not exact in
    f32: Gaussian rows, and rows of large +- terms whose dot products are
    near 0, with the refs placed on such scores."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, I, D, tile = 256, 16384, 128, 2048
    uf = torch.randn(B, D, device=cuda_device, generator=g) * 0.3
    iv = torch.randn(I, D, device=cuda_device, generator=g) * 0.3
    if kind == "cancelling":
        big = torch.randn(I, 1, device=cuda_device, generator=g) * 30
        sign = torch.randint(0, 2, (B, 1), device=cuda_device, generator=g) * 2.0 - 1
        iv += big
        uf[:, : D // 2] += sign
        uf[:, D // 2:] -= sign
    ib = torch.randn(I, device=cuda_device, generator=g) * 0.1
    j = torch.randint(0, I, (B, 2), device=cuda_device, generator=g)
    ref = torch.einsum("bd,bwd->bw", uf, iv[j]) + ib[j]
    loc = torch.full((I // tile, B, 1), -1, dtype=torch.int32, device=cuda_device)
    n_re = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    n_all = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    band = K2.counts_kernel(uf, iv, ib, ref, loc, tile, 256, _rechecked=n_re)
    exact = K2.counts_kernel(uf, iv, ib, ref, loc, tile, 256, _band_scale=float("inf"),
                             _rechecked=n_all)
    torch.cuda.synchronize()
    assert torch.equal(band, exact)
    assert int(n_all) == B * I and 0 < int(n_re) < B * I


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 6, 16, 128])
def test_counts_kernel_band_holds_the_worst_split_on_card(cuda_device, D):
    """Rows whose every coordinate is a worst case of the bf16 split, refs
    between the bf16x3 and the exact scores (ops/counts.py::band_worst_case):
    the default band sends those pairs to the exact chain, and the counts
    equal _band_scale=inf's and the exact ones."""
    uf, iv, ib, ref, want = (t.to(cuda_device) for t in K2.band_worst_case(D, seed=D))
    loc = torch.full((1, uf.shape[0], 1), -1, dtype=torch.int32, device=cuda_device)
    n_re = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    band = K2.counts_kernel(uf, iv, ib, ref, loc, 128, 8, _rechecked=n_re)
    exact = K2.counts_kernel(uf, iv, ib, ref, loc, 128, 8, _band_scale=float("inf"))
    torch.cuda.synchronize()
    assert torch.equal(band, exact)
    assert torch.equal(band, want)
    assert int(n_re) > 0


@pytest.mark.cuda
def test_counts_kernel_rejects_what_it_does_not_take_on_card(cuda_device):
    z = lambda *s: torch.zeros(*s, device=cuda_device)
    loc = torch.full((1, 8, 1), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="T <= 4"):
        K2.counts_kernel(z(8, 4), z(256, 4), z(256), z(8, 5), loc, 256, 8)
    with pytest.raises(ValueError, match="multiple of 128"):
        K2.counts_kernel(z(8, 4), z(200, 4), z(200), z(8, 1), loc, 200, 8)
    with pytest.raises(ValueError, match="contiguous"):
        K2.counts_kernel(z(4, 8).T, z(256, 4), z(256), z(8, 1), loc, 256, 8)


def _tower_inputs(dev, B, H, W, C, value=None, seed=0, edges=False):
    """Uniform images, constant ones (``value``), or with ``edges`` edge maps
    as the model's stack holds them: k/255, mostly zero."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if value is not None:
        x = torch.full((B, H, W, 1), value, device=dev)
    elif edges:
        k = torch.randint(1, 256, (B, H, W, 1), device=dev, generator=g)
        keep = torch.rand(B, H, W, 1, device=dev, generator=g) < 0.15
        x = torch.where(keep, k, 0).float() / 255
    else:
        x = torch.rand(B, H, W, 1, device=dev, generator=g)
    w = torch.randn(5, 5, 1, C, device=dev, generator=g) * 0.1
    b = torch.randn(C, device=dev, generator=g) * 0.1
    return x, w, b, torch.randn(B, C, device=dev, generator=g)


def _check_tower(x, w, b, dout):
    before = (K7.edge_tower_fwd.launches, K7.edge_tower_bwd.launches)
    out = K7.edge_tower_fwd(x, w, b)
    out2 = K7.edge_tower_fwd(x, w, b)
    dw, db = K7.edge_tower_bwd(x, w, b, dout)
    dw2, db2 = K7.edge_tower_bwd(x, w, b, dout)
    torch.cuda.synchronize()
    assert (K7.edge_tower_fwd.launches, K7.edge_tower_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    torch.testing.assert_close(out, K7.edge_tower_gap_plain(x, w, b), rtol=1e-5, atol=1e-6)
    assert torch.equal(out, out2)
    want = K7.edge_tower_gap_plain_backward(x, w, b, dout)
    sums = K7.edge_tower_gap_plain_backward(x, w, b, dout.abs())
    for got, ref, s in zip((dw, db), want, sums):
        assert bool(((got - ref).abs() <= 1e-5 + 1e-6 * s + 1e-4 * ref.abs()).all())
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C", [
    (5, 8, 16, 4), (8, 6, 10, 3), (3, 12, 8, 8),  # the JAX test geometries
    (64, 32, 32, 64), (2, 224, 224, 64),  # the training step's and the reference's
    (4, 10, 12, 40), (3, 14, 14, 256), (2, 64, 4092, 8),  # part warps, 4 groups, W >> 64
    (3, 12, 8, 257), (2, 32, 32, 600),  # more than one group of 256 channels
    (3, 18, 200, 100), (2, 2, 2, 1), (5, 34, 36, 130),  # C not a multiple of 64, ragged tiles
])
def test_edge_tower_kernels_match_plain_version_on_card(cuda_device, B, H, W, C):
    _check_tower(*_tower_inputs(cuda_device, B, H, W, C, seed=B + C))


@pytest.mark.cuda
@pytest.mark.parametrize("value", [0.5, 0.0])
def test_edge_tower_kernels_route_ties_like_the_plain_version_on_card(cuda_device, value):
    """Constant images tie every pool window (and, at 0, the ReLU boundary)."""
    _check_tower(*_tower_inputs(cuda_device, 16, 32, 32, 64, value=value))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C", [(64, 32, 32, 64), (2, 224, 224, 64)])
def test_edge_tower_kernels_match_plain_version_on_edge_maps_on_card(cuda_device, B, H, W, C):
    """k/255 edge maps, mostly zero: zero regions tie every pool window at
    pre = bias."""
    _check_tower(*_tower_inputs(cuda_device, B, H, W, C, seed=B + C, edges=True))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C", [(64, 32, 32, 64), (2, 224, 224, 64), (3, 12, 200, 70)])
def test_edge_tower_forward_holds_the_worst_case_split_on_card(cuda_device, B, H, W, C):
    """Every pixel and weight drops about the most its bf16 pieces can, and
    every conv term has one sign: the forward stays within its tolerance of
    the plain version, and two runs give the same bits."""
    x, w, b = K7.split_worst_case(B, H, W, C, seed=B + C, device=cuda_device)
    out = K7.edge_tower_fwd(x, w, b)
    out2 = K7.edge_tower_fwd(x, w, b)
    torch.testing.assert_close(out, K7.edge_tower_gap_plain(x, w, b), rtol=1e-5, atol=1e-6)
    assert torch.equal(out, out2)


@pytest.mark.cuda
def test_edge_tower_kernels_reject_what_they_do_not_take_on_card(cuda_device):
    x, w, b, dout = _tower_inputs(cuda_device, 2, 8, 8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        K7.edge_tower_fwd(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        K7.edge_tower_bwd(x, w, b, dout.T.contiguous().T)
    with pytest.raises(ValueError, match="even"):
        K7.edge_tower_gap(x[:, :7], w, b)


@pytest.mark.cuda
def test_attentive_fashion_kernel_route_matches_plain_route_on_card(cuda_device):
    """edge_tower='auto' on the card runs K7 (one forward and one backward
    per encoded batch); its loss and gradients equal the plain tower's."""
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion

    U, I = 40, 30
    rng = np.random.default_rng(0)
    inputs = (rng.random((I, 12)).astype(np.float32),
              rng.random((I, 16, 16, 1)).astype(np.float32),
              np.eye(5, dtype=np.float32)[rng.integers(0, 5, I)])
    models = [AttentiveFashion(U, I, *inputs, embed_k=16, attention_layers=(8, 1),
                               encoder_hidden=32, conv_filters=64, edge_tower=t,
                               device=cuda_device) for t in ("auto", "xla")]
    assert [m.tower_route for m in models] == ["kernel", "plain"]
    u, p, n = (torch.as_tensor(rng.integers(0, hi, 64), device=cuda_device)
               for hi in (U, I, I))
    before = (K7.edge_tower_fwd.launches, K7.edge_tower_bwd.launches)
    results = []
    for m in models:
        loss = m.loss(u, p, n, 0.01, rng=torch.Generator(device=cuda_device).manual_seed(3))
        results.append((loss, torch.autograd.grad(loss, list(m.parameters()))))
    torch.cuda.synchronize()
    assert (K7.edge_tower_fwd.launches - before[0],
            K7.edge_tower_bwd.launches - before[1]) == (2, 2)
    (lk, gk), (lp, gp) = results
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-6)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    before = K7.edge_tower_fwd.launches
    models[0].batch_eval = 8
    torch.testing.assert_close(models[0].precompute_eval(), models[1].precompute_eval(),
                               rtol=1e-5, atol=1e-6)
    assert K7.edge_tower_fwd.launches - before == 4  # ceil(30 / 8) blocks


@pytest.mark.cuda
def test_attentive_fashion_auto_takes_the_kernel_at_any_filter_count_on_card(cuda_device):
    """edge_tower='auto' on the card at even H, W is K7 whatever the
    filter count (257: two channel groups); its encodings equal the plain
    tower's."""
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion

    U, I = 6, 10
    rng = np.random.default_rng(1)
    inputs = (rng.random((I, 12)).astype(np.float32),
              rng.random((I, 8, 8, 1)).astype(np.float32),
              np.eye(5, dtype=np.float32)[rng.integers(0, 5, I)])
    models = [AttentiveFashion(U, I, *inputs, embed_k=16, attention_layers=(8, 1),
                               encoder_hidden=32, conv_filters=257, edge_tower=t,
                               device=cuda_device) for t in ("auto", "xla")]
    assert [m.tower_route for m in models] == ["kernel", "plain"]
    before = K7.edge_tower_fwd.launches
    got = models[0].encode_items()
    assert K7.edge_tower_fwd.launches - before == 1
    torch.testing.assert_close(got, models[1].encode_items(), rtol=1e-5, atol=1e-6)


def _bit_table(dev, R, W, seed, offset=0):
    """[R, W] float32 of random 32-bit patterns (NaNs and denormals among
    them), its data ``offset`` words into a buffer (offset 1: not 16-byte
    aligned)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randint(-2**31, 2**31 - 1, (R * W + offset,), device=dev, generator=g,
                        dtype=torch.int32)
    return buf[offset:].view(R, W).view(torch.float32)


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("width", [385, 388, 257, 259, 193, 195, 512, 2, 1])
def test_row_kernels_copy_bits_like_their_plain_versions_on_card(cuda_device, width,
                                                                   offset):
    R, B = 1000, 300
    table = _bit_table(cuda_device, R, width, seed=width, offset=offset)
    g = torch.Generator(device=cuda_device).manual_seed(width + 1)
    ids = torch.randint(0, R, (B,), device=cuda_device, generator=g, dtype=torch.int32)
    ids[:6] = torch.tensor([2**30, -1, R, -R - 1, R - 1, 0], dtype=torch.int32)
    before = (K4.gather_rows.launches, K5.scatter_rows_set.launches)
    got = K4.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(K4.gather_rows_reference(table, ids)))

    uids = torch.randperm(R, device=cuda_device, generator=g)[:B].to(torch.int32)
    uids[:4] = torch.tensor([2**30, -1, R, -5], dtype=torch.int32)  # all dropped
    vals = _bit_table(cuda_device, B, width, seed=width + 2, offset=offset)
    kern, plain = table.clone(), table.clone()
    assert K5.scatter_rows_set(kern, uids, vals) is kern
    torch.cuda.synchronize()
    K5.scatter_rows_set_reference(plain, uids, vals)
    assert torch.equal(_bits(kern), _bits(plain))
    assert (K4.gather_rows.launches - before[0], K5.scatter_rows_set.launches - before[1]) \
        == (1, 1)


@pytest.mark.cuda
def test_row_kernels_reject_non_contiguous_and_bench_on_card(cuda_device):
    """Strided tensors raise; the benches run at a small size."""
    table = torch.zeros(8, 6, device=cuda_device)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        K4.gather_rows(table[:, :4], ids)
    with pytest.raises(ValueError, match="contiguous"):
        K5.scatter_rows_set(table, ids, torch.zeros(6, 4, device=cuda_device).T)
    k, t = K4.bench_gather(table_rows=1000, dim=16, batch=256, reps=3)
    assert k > 0 and t > 0
    k, t = K5.bench_scatter(table_rows=1000, dim=16, batch=256, reps=3)
    assert k > 0 and t > 0


def _decoded(table, W, md, tau):
    """p, m, v (decoded), tau of a packed table, on the CPU."""
    t = table.cpu()
    mw = PG._mom_width(md, W)
    cols = t[:, W:W + mw]
    if md == "float32":
        m, v = cols[:, :W], cols[:, W:]
    elif md == "bfloat16":
        m, v = PG._mv_unpack(cols)
    else:
        m, v = PG._mv_unpack_fp8(cols, W)
    return t[:, :W], m, v, t[:, tau]


@pytest.mark.cuda
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "float8"])
def test_packed_step_kernel_route_matches_plain_route_on_card(cuda_device, moment_dtype):
    U, I, K, B, lr, steps = 500, 300, 32, 256, 0.01, 4
    model = BPRMF(U, I, embed_k=K, device="cpu", generator=torch.Generator().manual_seed(3))
    plain = PG.pack_generic_state(model, dict(model.named_parameters()),
                                  moment_dtype=moment_dtype, row_align=128)
    kern = PG.GenericPackedState(*(t.to(cuda_device) for t in plain[:3]), {})
    step = PG.make_generic_packed_step(model, lr, 0.01, moment_dtype=moment_dtype,
                                       lazy_catchup=True)
    g = torch.Generator().manual_seed(4)
    before = (K4.gather_rows.launches, K5.scatter_rows_set.launches)
    for _ in range(steps):
        batch = tuple(torch.randint(0, hi, (B,), generator=g, dtype=torch.int32)
                      for hi in (U, I, I))
        kern, lk = step(kern, (None, tuple(b.to(cuda_device) for b in batch), None))
        plain, lp = step(plain, (None, batch, None))
        torch.testing.assert_close(lk.cpu(), lp, rtol=1e-5, atol=0.0)
    torch.cuda.synchronize()
    assert (K4.gather_rows.launches - before[0],
            K5.scatter_rows_set.launches - before[1]) == (4 * steps, 2 * steps)
    for name, W, tau in (("user_pmv", K, K + PG._mom_width(moment_dtype, K)),
                         ("item_pmv", K, K + PG._mom_width(moment_dtype, K)
                          + PG._scalar_group(moment_dtype))):
        a, b = getattr(kern, name).cpu(), getattr(plain, name)
        untouched = b[:, tau] == 0
        assert torch.equal(_bits(a[:, tau]), _bits(b[:, tau]))
        assert torch.equal(_bits(a[untouched]), _bits(b[untouched]))
        assert torch.equal(_bits(a[:, tau + 1:]), _bits(b[:, tau + 1:]))  # pads
        code = {"float32": 0.0, "bfloat16": 2.0**-7, "float8": 0.25}[moment_dtype]
        for x, y, drift in zip(_decoded(a, W, moment_dtype, tau)[:3],
                               _decoded(b, W, moment_dtype, tau)[:3],
                               (2 * lr * steps, 0.0, 0.0)):
            err = (x - y).abs()
            beyond = ~(err <= 1e-6 + 2e-4 * y.abs())
            assert int(beyond.sum()) <= 1e-3 * y.numel(), name
            assert bool((err[beyond] <= drift + code * y.abs()[beyond] + 1e-6).all()), name


@pytest.mark.cuda
def test_attentive_fashion_packed_step_on_card(cuda_device):
    """The packed AttentiveFashion step on the card runs K4 x4, K5 x2 and
    K7 2 + 2 a step, and matches the same step on the CPU (plain tower,
    plain row ops) from one state with the same dropout masks."""
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion

    U, I, B = 40, 30, 64
    rng = np.random.default_rng(2)
    inputs = (rng.random((I, 12)).astype(np.float32),
              rng.random((I, 16, 16, 1)).astype(np.float32),
              np.eye(5, dtype=np.float32)[rng.integers(0, 5, I)])
    models = [AttentiveFashion(U, I, *inputs, embed_k=16, attention_layers=(8, 1),
                               encoder_hidden=32, conv_filters=64, device=d,
                               generator=torch.Generator(device=d).manual_seed(5))
              for d in (cuda_device, "cpu")]
    assert [m.tower_route for m in models] == ["kernel", "plain"]
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        with torch.no_grad():
            b.copy_(a.cpu())
    states = [PG.pack_generic_state(m, dict(m.named_parameters())) for m in models]
    steps = [PG.make_generic_packed_step(m, 0.01, 0.01, lazy_catchup=True) for m in models]
    before = (K4.gather_rows.launches, K5.scatter_rows_set.launches,
              K7.edge_tower_fwd.launches, K7.edge_tower_bwd.launches)
    for s in range(2):
        ids = tuple(torch.as_tensor(rng.integers(0, hi, B), dtype=torch.int32)
                    for hi in (U, I, I))
        masks = [torch.as_tensor(rng.random((B, w)) < 0.5) for w in (32, 64, 32) * 2]
        losses = []
        for i, dev in enumerate((cuda_device, "cpu")):
            states[i], loss = steps[i](states[i], (None, tuple(x.to(dev) for x in ids),
                                                   [m_.to(dev) for m_ in masks]))
            losses.append(loss.cpu())
        torch.testing.assert_close(losses[0], losses[1], rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()
    assert (K4.gather_rows.launches - before[0], K5.scatter_rows_set.launches - before[1],
            K7.edge_tower_fwd.launches - before[2],
            K7.edge_tower_bwd.launches - before[3]) == (8, 4, 4, 4)
    got = PG.unpack_generic_params(states[0], models[0].packed_spec())
    want = PG.unpack_generic_params(states[1], models[1].packed_spec())
    for k in ("Gu", "Gi"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=2e-4, atol=1e-5)
    # dense params: where Adam's sqrt(v_hat) is tiny (e.g. the last
    # attention bias, to which the softmax is blind) the update's sign
    # follows rounding noise; everywhere else they agree
    bc2 = 1.0 - 0.999**2
    for name, (p_, _, v_) in states[1].dense.items():
        for k, v in PG._flat_dense(name, v_).items():
            live = torch.sqrt(v / bc2) >= 10 * 1e-7
            torch.testing.assert_close(got[k].cpu()[live], want[k][live], rtol=2e-4,
                                       atol=1e-5)
