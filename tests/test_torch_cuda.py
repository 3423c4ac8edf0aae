"""Port on the CUDA card: the segmax kernel against its plain version, and
RecServer's on-card stage-1 paths against a full-catalog oracle.

Imports no jax, so it runs where JAX is absent:
``python -m pytest tests/test_torch_cuda.py --noconftest``.  Without a card
every test skips.  Kernel tolerance atol 1e-4, rtol 1e-5: the kernel sums
the D products sequentially in f32 FMAs, cuBLAS in another order, on scores
of magnitude up to ~20."""

import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.ops import segmax as S
from fashionvisualexpl_tpu_torch.serve import RecServer


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
