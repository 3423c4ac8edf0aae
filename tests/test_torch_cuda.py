"""Port on the CUDA card: the segmax kernel against its plain version,
RecServer's on-card stage-1 paths against a full-catalog oracle, and the
training kernels (fused BPR loss K1, fused Adam sweep K6) against theirs.

Imports no jax, so it runs where JAX is absent:
``python -m pytest tests/test_torch_cuda.py --noconftest``.  Without a card
every test skips.  Kernel tolerance atol 1e-4, rtol 1e-5: the kernel sums
the D products sequentially in f32 FMAs, cuBLAS in another order, on scores
of magnitude up to ~20.  K1: loss rtol 1e-5 (another summation order),
sigma rtol 1e-4, atol 1e-5 * scale**2 (diff's K products are summed with
FMAs in lane order, and their rounding grows with the products); the
gradients, from the same sigma, rtol 1e-4, atol 1e-5.  K6: the same f32 operations in the same order, m and v
rtol 1e-6, p rtol 1e-5."""

import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.ops import adam as A
from fashionvisualexpl_tpu_torch.ops import bpr as K1
from fashionvisualexpl_tpu_torch.ops import segmax as S
from fashionvisualexpl_tpu_torch.serve import RecServer
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
