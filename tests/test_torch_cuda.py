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
packed rows' widths (VBPR's and GradFashion's with their frozen columns
fused too), aligned and not, with out-of-range, negative and pad ids; K4
on each of its routes, the route of every launch asserted (widths on both
sides of the bulk threshold and at every W % 4, 8-byte and 4-byte bases,
a table view with a storage offset, the last row of a table whose bytes
end off a 16-byte boundary, B = 0, 1 and off the ring, NaN and denormal
patterns, the lanes forced at wide rows and the bulk copies at narrow
ones), and what its C entry refuses.  K5 likewise: each of its routes
forced where the geometry allows it (refused by name where not) at every
packed width, widths 1-5 and either side of the bulk threshold, table and
vals aligned and not, pads (2**30, -1, R, -5) dropped, every unwritten row
and the first and last words of each written row's neighbours unchanged,
a vals view whose first and last rows' 16-byte spans leave its buffer,
the A/B script's plans, batches off its rings, and its refusals.
K2 and K3 also at VBPR's and GradFashion's factored D = 148 (K3 at 150, 152,
160 and 164 too, its iv 8-byte aligned only, and the route each geometry
takes; K2 at 150, 256, 272 and 1024 too, in two to eleven chunks of D).
ACF's packed rows (769 / 513 / 385 floats, 25857 / 25601 / 25473 with
its 7x7x512 spatial maps fused) through K4 on the route each plan names
and through K5, bit-equal.  CompVBPR's factored D = 208 through K2 and
K3 (``segmax_mma_kernel``), and its packed user rows (625 / 417 / 313
floats, 640 / 512 / 384 at row_align 128) through K4 and K5 on every
route, forced.
The packed step on the card against the same step on CPU copies: 4
K4 + 2 K5 launches a step (ACF: 5 K4, the extra item rows among them);
losses rtol 1e-5; tau columns and untouched rows bit-equal; touched rows rtol 2e-4, atol 1e-6, where at most 0.1% of
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


# D in (128, 160] in rows of 8- or 16-byte copies (VBPR's and GradFashion's
# 148, 152, 160) on the register (B <= 64) and warpgroup kernels, at every
# epilogue: seg a multiple of 8, 16 or 32, none (12: the score tile), and
# above the 256-item tile (one segment walked in sub-tiles); ragged
# catalogs (seg x n_seg), trailing pads.  D = 150 (4-byte rows) and 164 on
# segmax_mma_kernel.
WIDE_SEGS = {8: 150, 12: 100, 16: 75, 32: 37, 64: 19, 1024: 3}
WIDE_GEOMETRIES = [(B, D, seg, n) for D in (148, 152, 160) for B in (8, 64, 65, 100, 4097)
                   for seg, n in WIDE_SEGS.items()]
FALLBACK_GEOMETRIES = [(B, D, seg, n) for D in (150, 164)
                       for B, seg, n in ((8, 32, 37), (100, 16, 75), (4097, 32, 37))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,D,seg,n_seg", [
    (100, 128, 16, 300), (100, 128, 64, 90), (100, 128, 128, 40), (100, 128, 1024, 5),
    (4097, 64, 32, 70), (4097, 128, 32, 70), (8, 128, 8, 500), (37, 33, 32, 50),
    (100, 33, 24, 40), (20, 600, 32, 10), (8, 128, 16, 300), (64, 128, 64, 90),
    (8, 128, 24, 40), (64, 128, 1024, 5), (8, 128, 4096, 1),
    (8, 64, 32, 70), (100, 16, 32, 70), (100, 72, 16, 90), (8, 72, 8, 90),
    (8, 200, 32, 10), (8, 148, 32, 70), (100, 148, 32, 70), (4097, 148, 32, 20),
    (8, 150, 32, 50), (100, 150, 16, 40),
    (8, 208, 32, 70), (64, 208, 32, 70), (100, 208, 16, 40), (4097, 208, 32, 20),
    (1024, 208, 1024, 3),
] + WIDE_GEOMETRIES + FALLBACK_GEOMETRIES)
def test_kernel_geometries_match_plain_version_on_card(cuda_device, dtype, B, D, seg, n_seg):
    """The tensor-core kernels' paths (D up to 160 in 8- or 16-byte rows
    with the items' fragments in registers, any other D from shared
    memory, seg a multiple of 32, 16 or 8 or none, seg
    above the block's item tile, B not a multiple of 8 or 16) and the
    CUDA-core body (f32, D = 600); VBPR's and GradFashion's D = 148 and
    its neighbours (WIDE_GEOMETRIES, FALLBACK_GEOMETRIES)."""
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
@pytest.mark.parametrize("B", [8, 100, 4097])
def test_kernel_takes_8_byte_aligned_rows_on_card(cuda_device, B):
    """iv the view big[1:] of a contiguous D = 148 tensor: 8-byte aligned,
    not 16.  The register and warpgroup kernels take it with 8-byte copies."""
    seg, D, Ip = 32, 148, 32 * 37
    g = torch.Generator(device=cuda_device).manual_seed(B)
    uf = (torch.randn(B, D, device=cuda_device, generator=g) * (3 / D**0.5)).bfloat16()
    big = torch.randn(Ip + 1, D, device=cuda_device, generator=g).bfloat16()
    iv = big[1:]
    assert iv.is_contiguous() and S.operand_align(uf, iv) == 8
    ib = torch.randn(Ip, device=cuda_device, generator=g) * 0.1
    ib[-seg - 3:] = -1e30
    before = S.segmax_scores.routes.copy()
    got = S.segmax_scores(uf, iv, ib, seg)
    torch.cuda.synchronize()
    kernel = "segmax_wgmma_kernel" if B > 64 else "segmax_mma_regs_kernel"
    assert S.segmax_scores.routes - before == {kernel: 1}
    torch.testing.assert_close(got, S.segmax_scores_reference(uf, iv, ib, seg),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D,align,Dp,copy_bytes,wide", [
    (148, 16, 160, 8, True), (148, 8, 160, 8, True), (152, 16, 160, 16, True),
    (160, 16, 160, 16, True), (128, 16, 128, 16, True), (100, 8, 160, 8, True),
    (128, 8, 160, 8, True), (150, 16, 160, 4, False), (164, 16, 176, 8, False),
    (152, 8, 160, 8, True),
    (148, 4, 160, 4, False), (148, 2, 160, 2, False), (33, 16, 48, 2, False),
    (208, 16, 208, 16, False), (208, 8, 208, 8, False),
])
def test_route_takes_wide_rows_to_the_register_and_warpgroup_kernels_on_card(
        cuda_device, D, align, Dp, copy_bytes, wide):
    """fvx_segmax_route: D up to 160 in rows of 8- or 16-byte copies goes
    to the register kernel at B <= 64 and to the warpgroup kernel above;
    D = 150 (4-byte rows), 164 and rows aligned to 4 or 2 bytes go to
    segmax_mma_kernel.  D is zero-padded to 128 for 16-byte rows up to
    128, else to 160.  The register kernel's shared rows are 160 bf16
    apart (64 bytes mod 128) at both Dp."""
    for B, large in ((1, False), (64, False), (65, True), (4096, True)):
        r = S.segmax_route(B, D, 32, align)
        want = ("segmax_wgmma_kernel" if large else "segmax_mma_regs_kernel") if wide \
            else "segmax_mma_kernel"
        assert (r["kernel"], r["Dp"], r["copy_bytes"]) == (want, Dp, copy_bytes), (B, r)
        if r["kernel"] == "segmax_mma_regs_kernel":
            assert r["ld"] == 160
        assert r["smem"] <= 232448
    with pytest.raises(ValueError, match="bad geometry"):
        S.segmax_route(0, D, 32)


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
    (100, 5000, 148, 3, 9, 2048), (257, 4099, 148, 1, 21, 256), (4100, 3000, 148, 1, 2, 2048),
    (257, 4099, 150, 2, 21, 256), (300, 5000, 256, 1, 4, 256), (64, 2000, 272, 3, 4, 256),
    (100, 5000, 208, 3, 9, 2048), (4100, 3000, 208, 1, 2, 2048), (257, 4099, 208, 2, 21, 256),
    (100, 3000, 1024, 3, 9, 2048),
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
def test_counts_kernel_at_d148_wide_bans_on_card(cuda_device):
    """VBPR's and GradFashion's D = 148 (two chunks of D), T = 3, four
    banned ids of one item tile per user (W >= 4), users and items off the
    tiles: bit-equal to the plain version."""
    from fashionvisualexpl_tpu_torch.ops.topk import (
        banned_bucket_width,
        bucket_banned_ids_device,
    )

    B, I, D, T, tile = 301, 5003, 148, 3, 256
    uf, iv, ib, ref, banned = _counts_inputs(cuda_device, B, I, D, T, 8, seed=148)
    first = torch.arange(B, device=cuda_device) % (I // tile) * tile
    banned[:, :4] = (first[:, None] + torch.arange(4, device=cuda_device)).to(torch.int32)
    W = banned_bucket_width(banned.cpu().numpy(), I, tile)
    assert W >= 4
    loc, msk = bucket_banned_ids_device(banned, I, tile, W)
    got = K2.streaming_counts_kernel(uf, iv, ib, ref, loc, msk, item_block=tile)
    want = K2.streaming_counts_kernel(uf.cpu(), iv.cpu(), ib.cpu(), ref.cpu(), loc.cpu(),
                                      msk.cpu(), item_block=tile)
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
@pytest.mark.parametrize("D", [128, 148, 1024])
@pytest.mark.parametrize("kind", ["gaussian", "cancelling"])
def test_counts_kernel_band_equals_exact_chain_on_card(cuda_device, kind, D):
    """The default band and _band_scale=inf (every pair through the exact
    fmaf chain) give bit-equal counts on data whose scores are not exact in
    f32: Gaussian rows, and rows of large +- terms whose dot products are
    near 0, with the refs placed on such scores.  D arrives in one chunk at
    128, two at 148 (the user tile whole) and eleven at 1024 (the user tile
    staged with each), and pairs were rechecked."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, I, tile = 256, 16384, 2048
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
@pytest.mark.parametrize("D", [1, 6, 16, 128, 148, 1024])
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


def _fused_widths():
    """The packed row widths of VBPR and GradFashion at the CLI's default
    widths (K=128, d=20, 4096-wide CNN / edge features, 512-wide color
    histograms), fp32 and bf16 moments, from ``packed_spec``."""
    from fashionvisualexpl_tpu_torch.models.grad_fashion import GradFashion
    from fashionvisualexpl_tpu_torch.models.vbpr import VBPR

    z = np.zeros
    models = (VBPR(2, 2, z((2, 4096), np.float32), device="cpu"),
              GradFashion(2, 2, z((2, 512), np.float32), z((2, 4096), np.float32), device="cpu"))
    widths = set()
    for model in models:
        for md in ("float32", "bfloat16"):
            st = PG.pack_generic_state(model, dict(model.named_parameters()),
                                       frozen=dict(model.named_buffers()), moment_dtype=md)
            widths |= {st.user_pmv.shape[1], st.item_pmv.shape[1]}
    return sorted(widths)


def test_fused_widths_are_the_packed_specs():
    """VBPR items [128 | 256 | 3 | 4096 | 1] = 4484 (bf16 moments 4355),
    GradFashion items 4996 (4867), users 445 (297)."""
    assert _fused_widths() == [297, 445, 4355, 4484, 4867, 4996]


@pytest.mark.cuda
def test_row_kernels_at_fused_widths_on_card(cuda_device):
    """K4 and K5 at VBPR's and GradFashion's packed row widths, frozen
    columns fused: bit-equal to their plain versions, pads dropped."""
    R, B = 1000, 300
    for width in _fused_widths():
        table = _bit_table(cuda_device, R, width, seed=width, offset=0)
        g = torch.Generator(device=cuda_device).manual_seed(width)
        ids = torch.randint(0, R, (B,), device=cuda_device, generator=g, dtype=torch.int32)
        ids[-50:] = 2**30
        got = K4.gather_rows(table, ids)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(K4.gather_rows_reference(table, ids))), width
        uids = torch.randperm(R, device=cuda_device, generator=g)[:B].to(torch.int32)
        uids[-50:] = 2**30
        vals = _bit_table(cuda_device, B, width, seed=width + 1, offset=0)
        kern, plain = table.clone(), table.clone()
        K5.scatter_rows_set(kern, uids, vals)
        torch.cuda.synchronize()
        K5.scatter_rows_set_reference(plain, uids, vals)
        assert torch.equal(_bits(kern), _bits(plain)), width


def _acf_widths():
    """{(side, moment dtype, fused): width} of ACF's packed rows at K=128
    over 7x7x512 spatial maps, from ``packed_spec``."""
    from fashionvisualexpl_tpu_torch.models.acf import ACF

    model = ACF(2, 2, np.zeros((2, 49, 512), np.float32), device="cpu",
                padded_positives=np.zeros((2, 20), np.int32),
                positive_counts=np.zeros(2, np.int32))
    widths = {}
    for md in ("float32", "bfloat16", "float8"):
        for fused in (False, True):
            st = PG.pack_generic_state(model, dict(model.named_parameters()),
                                       frozen=dict(model.named_buffers()) if fused else None,
                                       moment_dtype=md)
            widths[("users", md, fused)] = st.user_pmv.shape[1]
            widths[("items", md, fused)] = st.item_pmv.shape[1]
    return widths


def test_acf_widths_are_the_packed_specs():
    """Items [Gi | Pi | moments (| Fspat) | tau]: 769 / 513 / 385 at fp32 /
    bf16 / fp8 moments, 25857 / 25601 / 25473 fused; users 385 / 257 /
    193."""
    w = _acf_widths()
    assert [w[("items", md, False)] for md in ("float32", "bfloat16", "float8")] == [
        769, 513, 385]
    assert [w[("items", md, True)] for md in ("float32", "bfloat16", "float8")] == [
        25857, 25601, 25473]
    assert {w[("users", md, f)] for md in ("float32", "bfloat16", "float8")
            for f in (False, True)} == {385, 257, 193}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned16", "aligned4"])
@pytest.mark.parametrize("width", [769, 513, 25857, 25601, 25473])
def test_row_kernels_at_acf_widths_on_card(cuda_device, width, offset):
    """K4 on bulk_lanes (every ACF item width is 1 mod 4) and K5 at ACF's
    item rows, bit-equal to their plain versions, pads and out-of-range
    ids included."""
    R, B = 300, 200
    table = _bit_table(cuda_device, R, width, seed=width, offset=offset)
    plan = _gather_checked(table, _gather_ids(cuda_device, R, B, width))
    assert plan.route == "bulk_lanes"
    g = torch.Generator(device=cuda_device).manual_seed(width + 3)
    uids = torch.randperm(R, device=cuda_device, generator=g)[:B].to(torch.int32)
    uids[-40:] = 2**30
    uids[:2] = torch.tensor([-1, R], dtype=torch.int32)
    vals = _bit_table(cuda_device, B, width, seed=width + 1, offset=offset)
    kern, plain = table.clone(), table.clone()
    before = K5.scatter_rows_set.launches
    K5.scatter_rows_set(kern, uids, vals)
    torch.cuda.synchronize()
    K5.scatter_rows_set_reference(plain, uids, vals)
    assert torch.equal(_bits(kern), _bits(plain))
    assert K5.scatter_rows_set.launches == before + 1


def _gather_checked(table, ids, route=None):
    """K4 on (table, ids), bit-equal to its plain version, one launch on the
    route its plan names (none for B = 0); returns the plan."""
    before = (K4.gather_rows.launches, dict(K4.gather_rows.routes))
    got = K4.gather_rows(table, ids, _route=route)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(K4.gather_rows_reference(table, ids)))
    plan = K4.gather_plan(table.shape[1], table.data_ptr(), got.data_ptr(), route)
    routes = {k: v - before[1].get(k, 0) for k, v in K4.gather_rows.routes.items()
              if v != before[1].get(k, 0)}
    n = int(ids.shape[0] > 0)
    assert K4.gather_rows.launches - before[0] == n
    assert routes == ({plan.route: 1} if n else {})
    return plan


def _gather_ids(dev, R, B, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, R, (B,), device=dev, generator=g, dtype=torch.int32)
    special = torch.tensor([2**30, -1, R - 1, 0, R, -R - 1, -R, R - 1], dtype=torch.int32)
    k = min(B, len(special))
    ids[:k] = special[:k].to(dev)
    return ids


# widths on both sides of the bulk threshold (2048-byte rows) at every
# W % 4, rows of one trip and of several a lane, and every width the
# packed paths gather
GATHER_WIDTHS = (1, 2, 3, 4, 5, 6, 7, 127, 128, 129, 130, 193, 195, 257, 259, 297, 313, 384,
                 385, 388, 417, 445, 508, 509, 510, 511, 512, 513, 514, 515, 625, 640, 1023,
                 1024, 4355, 4484, 4867, 4996)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2], ids=["aligned16", "aligned4", "aligned8"])
@pytest.mark.parametrize("width", GATHER_WIDTHS)
def test_gather_routes_copy_bits_on_card(cuda_device, width, offset):
    table = _bit_table(cuda_device, 1000, width, seed=width, offset=offset)
    plan = _gather_checked(table, _gather_ids(cuda_device, 1000, 300, width))
    vec = width % 4 == 0 and offset == 0
    if 4 * width >= K4.BULK_MIN_BYTES:
        assert plan.route == ("bulk_store" if vec else "bulk_lanes")
    else:
        assert plan.route == ("lanes16" if vec else "lanes4")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned16", "aligned4"])
@pytest.mark.parametrize("route,width", [("lanes", w) for w in (1024, 1025, 2050, 4355, 4484,
                                                                  4867, 4996)]
                         + [("bulk", w) for w in (1, 2, 3, 4, 7, 128, 193, 385, 388, 511)])
def test_gather_forced_routes_on_card(cuda_device, route, width, offset):
    """The lanes forced at wide rows and the bulk copies at narrow ones,
    tiny rows included."""
    table = _bit_table(cuda_device, 777, width, seed=width + 5, offset=offset)
    plan = _gather_checked(table, _gather_ids(cuda_device, 777, 301, width), route)
    assert plan.route.startswith(route)


# CompVBPR's packed user rows (Gu and the four Tu*, Wu = 208: fp32 /
# bf16 / fp8 moments, and at row_align 128)
COMP_VBPR_USER_WIDTHS = (625, 417, 313, 640, 512, 384)


def test_comp_vbpr_widths_are_the_packed_specs():
    from fashionvisualexpl_tpu_torch.models.comp_vbpr import CompVBPR

    rng = np.random.default_rng(0)
    model = CompVBPR(6, 8, rng.random((8, 16), np.float32), rng.random((8, 512), np.float32),
                     rng.random((8, 8, 8, 1), np.float32), rng.random((8, 32), np.float32),
                     device="cpu")
    params = dict(model.named_parameters())
    widths = [PG.pack_generic_state(model, params, moment_dtype=md, row_align=a).user_pmv
              .shape[1] for a in (1, 128) for md in ("float32", "bfloat16", "float8")]
    assert tuple(widths) == COMP_VBPR_USER_WIDTHS


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned16", "aligned4"])
@pytest.mark.parametrize("route", ["lanes", "bulk"])
@pytest.mark.parametrize("width", COMP_VBPR_USER_WIDTHS)
def test_gather_forced_routes_at_comp_vbpr_widths_on_card(cuda_device, width, route, offset):
    """K4 at CompVBPR's user rows on each kind of route, forced: bit-equal."""
    table = _bit_table(cuda_device, 1000, width, seed=width + 7, offset=offset)
    plan = _gather_checked(table, _gather_ids(cuda_device, 1000, 300, width), route)
    assert plan.route.startswith(route)


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "bulk", "lanes"])
@pytest.mark.parametrize("R,width", [(37, 4355), (37, 385), (5, 4867), (3, 1), (1, 4099)])
def test_gather_table_edges_on_card(cuda_device, R, width, route):
    """A view one float into its storage (base 4 bytes past a 16-byte
    boundary) whose bytes end off a 16-byte boundary: its first and last
    rows' aligned spans reach outside the table, so the bulk route copies
    those pieces from the table directly."""
    assert R * width * 4 % 16 != 0
    table = _bit_table(cuda_device, R, width, seed=R + width, offset=1)
    ids = torch.tensor([0, R - 1] * 40 + [2**30, -1, -R, 0], dtype=torch.int32,
                       device=cuda_device)
    plan = _gather_checked(table, ids, route)
    assert plan.route == ("bulk_lanes" if route == "bulk" or (
        route is None and 4 * width >= K4.BULK_MIN_BYTES) else "lanes4")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [0, 1, 2, 3, 5, 13, 97, 4097])
@pytest.mark.parametrize("width", [4484, 4355, 385, 388])
def test_gather_batch_sizes_on_card(cuda_device, width, B):
    """B = 0 (no launch), 1, and batches off the bulk rings (stages a warp
    times 4 warps times the blocks)."""
    table = _bit_table(cuda_device, 500, width, seed=B + width)
    _gather_checked(table, _gather_ids(cuda_device, 500, B, B + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("route,width", [
    ("lanes4", 385), ("lanes4", 386), ("lanes16", 388), ("bulk_store", 388),
    ("bulk_store", 1024), ("bulk_lanes", 385), ("bulk_lanes", 1023), ("bulk_lanes", 1024)])
def test_gather_nan_and_denormal_bits_on_card(cuda_device, route, width):
    """NaN payloads, infinities, denormals and -0 travel as bits on every
    route, 16-byte words assembled across two source words included."""
    patterns = torch.tensor([0x7FC00001, -1, 1, -2139095041, 0x7F800000, -2**31, 0x7FBFFFFF,
                             0x00400000], dtype=torch.int32)
    R = 64
    table = patterns.repeat(R * width // 8 + 1)[:R * width].view(R, width).to(cuda_device)
    table = table.view(torch.float32)
    ids = torch.randint(0, R, (200,), dtype=torch.int32).to(cuda_device)
    assert _gather_checked(table, ids, route).route == route


@pytest.mark.cuda
def test_gather_refusals_on_card(cuda_device):
    """A route the geometry does not allow raises before a launch; the C
    entry refuses a bad route or geometry with cudaErrorInvalidValue (1)
    and launches nothing, and the wrapper raises: no plain fallback."""
    table = _bit_table(cuda_device, 64, 385, seed=1)
    ids = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    before = K4.gather_rows.launches
    with pytest.raises(ValueError, match="lanes16 cannot"):
        K4.gather_rows(table, ids, _route="lanes16")
    with pytest.raises(ValueError, match="bulk_store needs"):
        K4.gather_rows(table, ids, _route="bulk_store")
    for plan in (K4.GatherPlan("bulk_store", 4, 1552), K4.GatherPlan("bulk_lanes", 17, 1552),
                 K4.GatherPlan("bulk_lanes", 4, 1544), K4.GatherPlan("lanes4", 3, 0),
                 K4.GatherPlan("bulk_lanes", 16, 16384)):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            K4.gather_rows(table, ids, _route=plan)
    assert K4.gather_rows.launches == before
    fn = K4._entries[0] if K4._entries else K4._bind()[0]
    out = torch.empty(8, 388, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    number = {name: i for i, name in enumerate(K4.ROUTES)}
    assert fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), 64, 385, 8, len(K4.ROUTES), 4,
              0, stream) == 1
    assert fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), 0, 385, 8, number["lanes4"],
              8, 0, stream) == 1
    for route, param, piece in (("bulk_store", 4, 1552), ("lanes16", 4, 0)):
        assert fn(table.data_ptr() + 4, ids.data_ptr(), out.data_ptr(), 63, 388, 8,
                  number[route], param, piece, stream) == 1


@pytest.mark.cuda
def test_gather_residency_on_card(cuda_device):
    """The persistent grids: one block of bulk_store an SM, two of
    bulk_lanes, and several of the lanes kernels."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for width in (4484, 4996, 4355, 4867):
        plan = K4.gather_plan(width, 0, 0)
        assert K4.gather_residency(width, plan) == (
            1 if plan.route == "bulk_store" else 2, sms)
    for width in (128, 385, 388):
        per_sm, n = K4.gather_residency(width, K4.gather_plan(width, 0, 0))
        assert per_sm >= 2 and n == sms


def _scatter_checked(table, ids, vals, route=None):
    """K5 on a clone of ``table``: bit-equal to its plain version on a
    clone (the written rows equal to vals, every other row unchanged), the
    first and last words of each written row's neighbours unchanged, one
    launch on the route its plan names (none for B = 0); returns the
    plan."""
    before = (K5.scatter_rows_set.launches, dict(K5.scatter_rows_set.routes))
    off = table.data_ptr() % 16 // 4  # the copy at the table's address mod 16
    kern = torch.empty(table.numel() + off, device=table.device)[off:].view_as(table)
    kern.copy_(table)
    plain = table.clone()
    assert K5.scatter_rows_set(kern, ids, vals, _route=route) is kern
    torch.cuda.synchronize()
    K5.scatter_rows_set_reference(plain, ids, vals)
    assert torch.equal(_bits(kern), _bits(plain))
    R = table.shape[0]
    kept = ids[(ids >= 0) & (ids < R)].long()
    assert torch.equal(_bits(kern[kept]), _bits(vals[(ids >= 0) & (ids < R)]))
    near = torch.cat([kept - 1, kept + 1]).clamp(0, R - 1)
    near = near[~torch.isin(near, kept)]
    for col in (0, -1):  # what a misaligned 16-byte store would break
        assert torch.equal(_bits(kern[near, col]), _bits(table[near, col]))
    plan = (route if isinstance(route, K5.ScatterPlan) else
            K5.scatter_plan(table.shape[1], kern.data_ptr(), vals.data_ptr(), route))
    routes = {k: v - before[1].get(k, 0) for k, v in K5.scatter_rows_set.routes.items()
              if v != before[1].get(k, 0)}
    n = int(ids.shape[0] > 0)
    assert K5.scatter_rows_set.launches - before[0] == n
    assert routes == ({plan.route: 1} if n else {})
    return plan


def _scatter_ids(dev, R, B, seed):
    """B ids: the last row, the first, then unique random rows, every
    seventh slot from the third on a pad (2**30, -1, R, -5 in turn, all
    dropped)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(R, device=dev, generator=g)
    ids = torch.cat([torch.tensor([R - 1, 0], device=dev),
                     perm[(perm != 0) & (perm != R - 1)]])[:B].to(torch.int32)
    pads = torch.tensor([2**30, -1, R, -5], dtype=torch.int32, device=dev)
    n = ids[2::7].shape[0]
    ids[2::7] = pads.repeat(n // 4 + 1)[:n]
    return ids


# every width the packed paths write, tiny rows and both sides of the
# lanes / bulk thresholds (LANES_MAX_BYTES: 256 words of 4 or 16 bytes)
SCATTER_WIDTHS = (1, 2, 3, 4, 5, 193, 195, 255, 256, 257, 259, 297, 313, 384, 385, 388, 417,
                  445, 512, 513, 625, 640, 769, 1023, 1024, 1025, 1028, 4355, 4484, 4867, 4996,
                  25473, 25601, 25857)


def _scatter_route(width, vec):
    """The route a plan names by default: a lanes route while 256 of its
    words hold the row."""
    lanes = "lanes16" if vec else "lanes4"
    if 4 * width <= K5.LANES_MAX_BYTES[lanes]:
        return lanes
    return "bulk_store" if vec else "bulk_lanes"


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned16", "aligned4"])
@pytest.mark.parametrize("width", SCATTER_WIDTHS)
def test_scatter_routes_copy_bits_on_card(cuda_device, width, offset):
    """Every route forced where the geometry allows it (the lanes and the
    bulk copies at every width, the 16-byte routes at W % 4 == 0 between
    aligned bases), refused by name where it does not, and the planned
    route, each bit-equal with the pads dropped; table and vals off a
    16-byte boundary together (aligned4)."""
    R, B = 97, 61
    table = _bit_table(cuda_device, R, width, seed=width, offset=offset)
    vals = _bit_table(cuda_device, B, width, seed=width + 1, offset=offset)
    ids = _scatter_ids(cuda_device, R, B, width)
    plan = _scatter_checked(table, ids, vals)
    vec = width % 4 == 0 and offset == 0
    assert plan.route == _scatter_route(width, vec)
    for route in K5.ROUTES:
        if route.endswith(("16", "store")) and not vec:
            with pytest.raises(ValueError, match=f"{route} (cannot|needs)"):
                K5.scatter_rows_set(table.clone(), ids, vals, _route=route)
        elif route.startswith("bulk") or width <= K5.MAX_LANES_WIDTH:
            assert _scatter_checked(table, ids, vals, route).route == route


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "lanes", "bulk"])
@pytest.mark.parametrize("B,width", [(38, 4355), (37, 385), (6, 4867), (4, 1), (1, 4098),
                                     (8, 25857), (9, 513)])
def test_scatter_vals_edges_on_card(cuda_device, B, width, route):
    """vals a view one float into its buffer, which ends with its last
    row: its first and last rows' 16-byte spans reach outside the buffer
    (B * W * 4 is no multiple of 16), so the bulk routes copy those pieces
    from vals directly."""
    assert (B * width + 1) * 4 % 16 != 0
    R = 3 * B + 2
    table = _bit_table(cuda_device, R, width, seed=R + width)
    vals = _bit_table(cuda_device, B, width, seed=B + width, offset=1)
    perm = torch.randperm(R - 1, generator=torch.Generator().manual_seed(B))[:B - 1]
    ids = torch.cat([perm[:B // 2], torch.tensor([R - 1]), perm[B // 2:]]).to(torch.int32)
    plan = _scatter_checked(table, ids.to(cuda_device), vals, route)
    assert plan.route == ("bulk_lanes" if route == "bulk" else
                          "lanes4" if route == "lanes" else _scatter_route(width, False))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kept-first", "scattered"])
@pytest.mark.parametrize("width", [193, 385, 388, 4355, 4484, 25857])
def test_scatter_mostly_pads_on_card(cuda_device, width, layout):
    """The dedupe's layout, most slots pads: 150 kept rows of 3000 slots,
    first (as the sorted dedupe leaves them) or scattered among the pads
    (2**30 and -1): every route skips the pads and writes the kept rows."""
    R, B, K = 400, 3000, 150
    table = _bit_table(cuda_device, R, width, seed=width)
    vals = _bit_table(cuda_device, B, width, seed=width + 2)
    g = torch.Generator().manual_seed(width)
    ids = torch.full((B,), 2**30, dtype=torch.int32)
    ids[1::2] = -1
    at = torch.arange(K) if layout == "kept-first" else torch.randperm(B, generator=g)[:K]
    ids[at] = torch.randperm(R, generator=g)[:K].to(torch.int32)
    ids = ids.to(cuda_device)
    for route in (None, "lanes", "bulk"):
        _scatter_checked(table, ids, vals, route)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [193, 385, 388, 769, 4484, 25473])
def test_scatter_repeats_write_every_row_on_card(cuda_device, width):
    """16,384 rows, as the timing phases write them, 12 times over: before
    each launch the written rows are set to the complement of vals, so a
    launch that skipped a piece would leave it showing (a run of launches
    over the same rows cannot)."""
    R, B = 20_000, 16_384
    g = torch.Generator(device=cuda_device).manual_seed(width)
    table = _bit_table(cuda_device, R, width, seed=width)
    vals = _bit_table(cuda_device, B, width, seed=width + 1)
    rows = torch.randperm(R, device=cuda_device, generator=g)[:B]
    ids = rows.to(torch.int32)
    t32, v32 = _bits(table), _bits(vals)
    before = K5.scatter_rows_set.launches
    for _ in range(12):
        t32[rows] = ~v32
        K5.scatter_rows_set(table, ids, vals)
        torch.cuda.synchronize()
        assert torch.equal(t32[rows], v32)
    assert K5.scatter_rows_set.launches == before + 12


@pytest.mark.cuda
@pytest.mark.parametrize("B", [0, 1, 2, 3, 5, 13, 97, 4097])
@pytest.mark.parametrize("width", [4484, 4355, 385, 388])
def test_scatter_batch_sizes_on_card(cuda_device, width, B):
    """B = 0 (no launch), 1, and batches off the bulk rings (stages a warp
    times 4 warps times the blocks) and off the lanes' warps."""
    R = max(2 * B, 8)
    table = _bit_table(cuda_device, R, width, seed=B + width)
    vals = _bit_table(cuda_device, B, width, seed=B + width + 1)
    _scatter_checked(table, _scatter_ids(cuda_device, R, B, B + 1), vals)


@pytest.mark.cuda
@pytest.mark.parametrize("width,plans", [
    (193, [("lanes4", u, 0) for u in (2, 4, 8, 16)]),
    (195, [("lanes4", u, 0) for u in (4, 8, 16)]),
    (388, [("lanes16", u, 0) for u in (2, 4, 8)] + [("lanes4", 16, 0)]),
    (4484, [("bulk_store", st, pc) for st, pc in ((6, 3600), (12, 3600), (8, 4096), (2, 16))]
     + [("bulk_lanes", st, pc) for st, pc in ((4, 8192), (6, 4096), (16, 1024))]),
    (4355, [("bulk_lanes", st, pc) for st, pc in ((4, 5808), (4, 8192), (8, 2048), (3, 17424))]),
    (25857, [("bulk_lanes", 4, 7392), ("bulk_lanes", 2, 16), ("lanes4", 2, 0)]),
])
def test_scatter_plans_of_the_sweep_on_card(cuda_device, width, plans):
    """Whole plans as the A/B script sweeps them (loads a lane; stages and
    piece bytes, pieces down to 16 bytes), each bit-equal on its route."""
    R, B = 80, 41
    table = _bit_table(cuda_device, R, width, seed=width)
    vals = _bit_table(cuda_device, B, width, seed=width + 9)
    ids = _scatter_ids(cuda_device, R, B, width)
    for plan in plans:
        assert _scatter_checked(table, ids, vals, K5.ScatterPlan(*plan)).route == plan[0]


@pytest.mark.cuda
def test_scatter_refusals_on_card(cuda_device):
    """A route the geometry does not allow raises before a launch; the C
    entry refuses a bad route or geometry with cudaErrorInvalidValue (1)
    and launches nothing, and the wrapper raises naming the route: no
    plain fallback."""
    table = _bit_table(cuda_device, 64, 385, seed=1)
    ids = torch.arange(8, dtype=torch.int32, device=cuda_device)
    vals = _bit_table(cuda_device, 8, 385, seed=2)
    before = (K5.scatter_rows_set.launches, sum(K5.scatter_rows_set.routes.values()))
    want = table.clone()
    with pytest.raises(ValueError, match="lanes16 cannot"):
        K5.scatter_rows_set(table, ids, vals, _route="lanes16")
    with pytest.raises(ValueError, match="bulk_store needs"):
        K5.scatter_rows_set(table, ids, vals, _route="bulk_store")
    for plan in (K5.ScatterPlan("bulk_store", 4, 1552), K5.ScatterPlan("bulk_lanes", 17, 1552),
                 K5.ScatterPlan("bulk_lanes", 4, 1544), K5.ScatterPlan("lanes4", 3, 0),
                 K5.ScatterPlan("lanes16", 16, 0), K5.ScatterPlan("bulk_lanes", 16, 16384)):
        with pytest.raises(RuntimeError, match=f"\\({plan.route}\\): cudaError 1"):
            K5.scatter_rows_set(table, ids, vals, _route=plan)
    torch.cuda.synchronize()
    assert torch.equal(_bits(table), _bits(want))  # nothing written
    assert (K5.scatter_rows_set.launches,
            sum(K5.scatter_rows_set.routes.values())) == before
    fn = K5._entries[0] if K5._entries else K5._bind()[0]
    stream = torch.cuda.current_stream().cuda_stream
    number = {name: i for i, name in enumerate(K5.ROUTES)}
    args = (table.data_ptr(), ids.data_ptr(), vals.data_ptr())
    assert fn(*args, 64, 385, 8, len(K5.ROUTES), 4, 0, stream) == 1
    assert fn(*args, -1, 385, 8, number["lanes4"], 8, 0, stream) == 1
    assert fn(*args, 64, 0, 8, number["lanes4"], 8, 0, stream) == 1
    wide = _bit_table(cuda_device, 64, 388, seed=3)
    wvals = _bit_table(cuda_device, 8, 388, seed=4)
    for route, param, piece in (("bulk_store", 4, 1552), ("lanes16", 4, 0)):
        assert fn(wide.data_ptr() + 4, ids.data_ptr(), wvals.data_ptr(), 63, 388, 8,
                  number[route], param, piece, stream) == 1
        assert fn(wide.data_ptr(), ids.data_ptr(), wvals.data_ptr() + 8, 64, 388, 7,
                  number[route], param, piece, stream) == 1
    assert fn(wide.data_ptr() + 2, ids.data_ptr(), wvals.data_ptr(), 63, 388, 8,
              number["lanes4"], 4, 0, stream) == 1
    assert fn(wide.data_ptr(), ids.data_ptr(), wvals.data_ptr(), 64, 388, 8,
              number["lanes16"], 16, 0, stream) == 1  # 16 loads of 16 bytes: no kernel
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_scatter_residency_on_card(cuda_device):
    """The persistent grids: the bulk kernels at least one block an SM and
    no more than their rings fit in its 228 KB of shared memory, the lanes
    kernels several."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for width in (4484, 4996, 4355, 4867, 769, 25857):
        plan = K5.scatter_plan(width, 0, 0)
        per_sm, n = K5.scatter_residency(width, plan)
        smem = K5.bulk_smem(plan) + 1024  # the runtime's own KB a block
        assert n == sms and 1 <= per_sm <= 233_472 // smem, (width, plan, per_sm)
    for width in (193, 195, 388):
        per_sm, n = K5.scatter_residency(width, K5.scatter_plan(width, 0, 0))
        assert per_sm >= 2 and n == sms


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
    routes = K5.scatter_rows_set.routes.copy()
    for _ in range(steps):
        batch = tuple(torch.randint(0, hi, (B,), generator=g, dtype=torch.int32)
                      for hi in (U, I, I))
        kern, lk = step(kern, (None, tuple(b.to(cuda_device) for b in batch), None))
        plain, lp = step(plain, (None, batch, None))
        torch.testing.assert_close(lk.cpu(), lp, rtol=1e-5, atol=0.0)
    torch.cuda.synchronize()
    assert (K4.gather_rows.launches - before[0],
            K5.scatter_rows_set.launches - before[1]) == (4 * steps, 2 * steps)
    # row_align=128: 16-byte rows between aligned tensors, on lanes16
    assert K5.scatter_rows_set.routes - routes == {"lanes16": 2 * steps}
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


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "by-id"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_acf_packed_step_on_card(cuda_device, moment_dtype, fused):
    """The packed ACF step on the card runs 5 K4 (the extra item rows
    among them) and 2 K5 a step, and matches the same step on CPU copies:
    losses rtol 1e-5, tau, Fspat and untouched rows bit-equal, touched
    rows and the dense attention as the packed BPRMF card test holds
    them."""
    from fashionvisualexpl_tpu_torch.models.acf import ACF

    U, I, B, lr, steps = 60, 50, 32, 0.01, 3
    rng = np.random.default_rng(7)
    pos = rng.integers(0, I, (U, 6)).astype(np.int32)
    cnt = rng.integers(0, 7, U).astype(np.int32)
    spat = rng.normal(size=(I, 9, 16)).astype(np.float32)
    models = [ACF(U, I, spat, padded_positives=pos, positive_counts=cnt, embed_k=16,
                  layers_component=(8, 1), layers_item=(8, 1), device=d,
                  generator=torch.Generator(device=d).manual_seed(5))
              for d in (cuda_device, "cpu")]
    with torch.no_grad():
        for a, b in zip(models[0].parameters(), models[1].parameters()):
            b.copy_(a.cpu())
    frozen = [dict(m.named_buffers()) for m in models]
    states = [PG.pack_generic_state(m, dict(m.named_parameters()),
                                    frozen=fr if fused else None, moment_dtype=moment_dtype)
              for m, fr in zip(models, frozen)]
    step = [PG.make_generic_packed_step(m, lr, 0.01, fused_frozen=fused,
                                        moment_dtype=moment_dtype, lazy_catchup=True)
            for m in models]
    before = (K4.gather_rows.launches, K5.scatter_rows_set.launches)
    for _ in range(steps):
        ids = tuple(torch.as_tensor(rng.integers(0, hi, B), dtype=torch.int32)
                    for hi in (U, I, I))
        losses = []
        for i, dev in enumerate((cuda_device, "cpu")):
            states[i], loss = step[i](states[i], (frozen[i], tuple(x.to(dev) for x in ids),
                                                  None))
            losses.append(loss.cpu())
        torch.testing.assert_close(losses[0], losses[1], rtol=1e-5, atol=0.0)
    torch.cuda.synchronize()
    assert (K4.gather_rows.launches - before[0],
            K5.scatter_rows_set.launches - before[1]) == (5 * steps, 2 * steps)
    for name, w in (("user_pmv", 16), ("item_pmv", 32)):  # Gu; Gi | Pi
        a, b = getattr(states[0], name).cpu(), getattr(states[1], name)
        keep = w + PG._mom_width(moment_dtype, w)  # the fused maps and tau follow
        assert torch.equal(_bits(a[:, keep:]), _bits(b[:, keep:]))
        untouched = b[:, -1] == 0  # tau, the last column
        assert torch.equal(_bits(a[untouched]), _bits(b[untouched]))
        code = {"float32": 0.0, "bfloat16": 2.0**-7}[moment_dtype]
        for x, y, drift in zip(_decoded(a, w, moment_dtype, keep)[:3],
                               _decoded(b, w, moment_dtype, keep)[:3],
                               (2 * lr * steps, 0.0, 0.0)):
            err = (x - y).abs()
            beyond = ~(err <= 1e-6 + 2e-4 * y.abs())
            assert int(beyond.sum()) <= 1e-3 * y.numel(), name
            assert bool((err[beyond] <= drift + code * y.abs()[beyond] + 1e-6).all()), name
    bc2 = 1.0 - 0.999**steps
    for name in ("comp", "item"):
        for (p_k, p_c), (_, v_c) in zip(zip(states[0].dense[name][0].values(),
                                            states[1].dense[name][0].values()),
                                        zip(states[0].dense[name][2].values(),
                                            states[1].dense[name][2].values())):
            live = torch.sqrt(v_c / bc2) >= 10 * 1e-7
            torch.testing.assert_close(p_k.cpu()[live], p_c[live], rtol=2e-4, atol=1e-5)


def _streamed_pair(dev, U, I, H, seed):
    """A resident AttentiveFashion and a host_features one on the same
    weights (K7 on the card), the data and the store of the host one."""
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
    from fashionvisualexpl_tpu_torch.train.streamed import ArrayFeatureStore

    rng = np.random.default_rng(seed)
    inputs = (rng.random((I, 12)).astype(np.float32),
              (rng.integers(0, 256, (I, H, H, 1)) / 255.0).astype(np.float32),
              np.eye(5, dtype=np.float32)[rng.integers(0, 5, I)])
    models = [AttentiveFashion(U, I, *inputs, embed_k=16, attention_layers=(8, 1),
                               encoder_hidden=32, conv_filters=64, host_features=host,
                               device=dev, generator=torch.Generator(device=dev).manual_seed(7))
              for host in (False, True)]
    assert [m.tower_route for m in models] == ["kernel", "kernel"]
    data = synthetic_interactions(U, I, interactions_per_user=6, seed=seed)
    return models, data, ArrayFeatureStore(*inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(4, 32), (2, 224)], ids=["4x32x32", "2x224x224"])
def test_streamed_step_equals_resident_step_on_card(cuda_device, B, H):
    """Two steps of ``run_streamed_steps`` (rows from the host store through
    pinned buffers) and of the resident ``Trainer.run_steps`` from one
    state, the same triples and step seeds, both on K7 (2 + 2 launches a
    step): the same losses and params, bit for bit."""
    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data import native as N
    from fashionvisualexpl_tpu_torch.train.streamed import StreamedTrainer
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    (resident, host), data, store = _streamed_pair(cuda_device, 30, 24, H, seed=B)
    cfg = TrainConfig(batch_size=B, lr=0.01, reg=0.001)
    trainers = [Trainer(resident, data, cfg), StreamedTrainer(host, data, cfg, store)]
    g = torch.Generator(device=cuda_device).manual_seed(1)
    triples = tuple(torch.randint(0, hi, (2, B), generator=g, device=cuda_device)
                    for hi in (30, 24, 24))
    runs = []
    for tr in trainers:
        state, frozen = tr.init_state()
        before = (K7.edge_tower_fwd.launches, K7.edge_tower_bwd.launches,
                  N.gather_rows_native.calls)
        if isinstance(tr, StreamedTrainer):
            state, loss = tr.run_streamed_steps(state, triples, store, 11)
        else:
            state, loss = tr.run_steps(state, frozen, triples, 11)
        torch.cuda.synchronize()
        launched = (K7.edge_tower_fwd.launches - before[0],
                    K7.edge_tower_bwd.launches - before[1])
        assert launched == (4, 4)
        runs.append((state, loss, N.gather_rows_native.calls - before[2]))
    (rs, rl, _), (ss, sl, gathers) = runs
    assert gathers == (6 if N.load_library() is not None else 0)  # 3 a batch
    assert torch.equal(sl, rl), (float(sl), float(rl))
    for k, p in rs.params.items():
        assert torch.equal(ss.params[k], p), (k, float((ss.params[k] - p).abs().max()))


@pytest.mark.cuda
def test_staging_ring_never_refills_a_buffer_in_flight_on_card(cuda_device):
    """The prefetcher gathers ahead into a ring of pinned buffers while the
    copies out of them wait behind a long kernel on the stream: every batch
    that reaches the card equals ``src[ids]`` (a buffer refilled before its
    copy ran would give the next batch's rows)."""
    from fashionvisualexpl_tpu_torch.data.pipeline import HostPrefetcher, StagingRing
    from fashionvisualexpl_tpu_torch.train.streamed import ArrayFeatureStore

    R, B, steps, depth = 64, 8, 24, 2
    rows = np.arange(R, dtype=np.float32)[:, None, None, None]
    store = ArrayFeatureStore(np.repeat(rows[:, :, 0, 0], 3, 1),
                              np.ascontiguousarray(np.broadcast_to(rows, (R, 64, 64, 1))),
                              np.repeat(rows[:, :, 0, 0], 2, 1))
    ids = np.random.default_rng(0).integers(0, R, (steps, 2, B)).astype(np.int32)
    ring = StagingRing(depth + 2, store.shapes(B), cuda_device)

    def gather(s):
        i = ring.acquire()
        store.gather(ids[s, 0], ids[s, 1], out=ring.views[i])
        return i

    got = []
    for s, i in HostPrefetcher(iter(range(steps)), gather, depth=depth):
        torch.cuda._sleep(20_000_000)  # ~10 ms: the copy below waits behind it
        got.append(store.split(ring.to_device(i)))
    torch.cuda.synchronize()
    for s, feats in enumerate(got):
        for key, want in store.gather(ids[s, 0], ids[s, 1]).items():
            assert torch.equal(feats[key].cpu(), torch.from_numpy(want)), (s, key)


# --- the mesh's collectives with ranks sharing one card ---------------------

_GLOO_RANK = r"""
import datetime, json, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
from fashionvisualexpl_tpu_torch.core import mesh as M

rank, world, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
mesh = M.make_mesh(1, world, device="cuda")
x = torch.arange(6, dtype=torch.float32, device="cuda") + 10 * rank
c = torch.arange(3, dtype=torch.int32, device="cuda") + rank
s, g, i = M.psum(x, mesh, "model"), M.all_gather(x, mesh, "model"), M.psum(c, mesh, "model")
torch.cuda.synchronize()
print(json.dumps({"devices": [str(t.device) for t in (s, g, i)], "sum": s.tolist(),
                  "gather": g.tolist(), "isum": i.tolist(), "dtype": str(i.dtype),
                  "staged": dict(M.staged_bytes)}))
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_mesh_collectives_of_gloo_ranks_sharing_the_card(cuda_device, tmp_path):
    """Two gloo ranks on cuda:0: ``psum`` (float32 and int32) and
    ``all_gather`` take and return CUDA tensors; gloo's CUDA all_reduce runs
    as it is, its all_gather (which gloo lacks for CUDA tensors) is staged
    through pinned host memory, its bytes counted: 24 B to the host and
    48 B back per rank."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "rank.py"
    script.write_text(_GLOO_RANK)
    rdv = str(tmp_path / "rdv")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", rdv, repo],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    for r, (out, _) in enumerate(outs):
        got = json.loads(out.strip().splitlines()[-1])
        assert got["devices"] == ["cuda:0"] * 3
        assert got["sum"] == [10.0 + 2 * j for j in range(6)]
        assert got["gather"] == [[float(j) for j in range(6)], [10.0 + j for j in range(6)]]
        assert got["isum"] == [1, 3, 5] and got["dtype"] == "torch.int32"
        assert got["staged"] == {"all_gather": 24 + 48}, got["staged"]
