"""The model of the tensor cores' f32 sums (``ops/tc_rounding.py``) on the
CPU: its rounding, its exact cases, the probe operands' power to tell its
rivals apart, and the conv replay of K7's bf16 kernels against a float64
conv.  The model against the card's ``wgmma`` and ``mma.sync`` outputs is
checked on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import pytest
import torch
import torch.nn.functional as F

from fashionvisualexpl_tpu_torch.ops import tc_rounding as R

# MEASURED and its rivals, each one feature apart: to nearest even, one
# rounding per addition, normalized product exponents, 1 or 3 extra bits
RIVALS = {
    "to nearest": (16, 2, False, True),
    "per addition": (1, 2, True, True),
    "normalized exponents": (16, 2, True, False),
    "1 extra bit": (16, 1, True, True),
    "3 extra bits": (16, 3, True, True),
}


def test_round_f32_directions():
    s = torch.tensor([1 + 2.0**-24 + 2.0**-30, -(1 + 2.0**-24 + 2.0**-30), 1 + 2.0**-24,
                      1 + 3 * 2.0**-24], dtype=torch.float64)
    assert R.round_f32(s, True).tolist() == [1.0, -1.0, 1.0, 1 + 2.0**-23]
    assert R.round_f32(s, False).tolist() == [1 + 2.0**-23, -(1 + 2.0**-23), 1.0, 1 + 2.0**-22]


def test_tc_sums_exact_where_the_terms_fit():
    """Small integers sum exactly under every model of the family."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-8, 9, (32, 16), generator=g).double()
    b = torch.randint(-8, 9, (32, 16), generator=g).double()
    c = torch.randint(-100, 101, (32,), generator=g).double()
    want = c + (a * b).sum(dim=-1)
    for m in R.candidates():
        assert torch.equal(R.tc_sums(c, a, b, *m), want), R.name(m)


def test_tc_sums_ties_and_sub_ulp_terms():
    """1 + 0.75 ulp: truncation keeps 1, nearest goes up; 1 + 15 terms of a
    quarter ulp: one cut of the exact sum gives 1 + 3 ulps, one rounding per
    addition (each quarter lost) gives 1."""
    one = torch.ones(1, dtype=torch.float64)
    a = torch.zeros(1, 16, dtype=torch.float64)
    a[0, 0] = 1.0
    b = torch.zeros(1, 16, dtype=torch.float64)
    b[0, 0] = 0.75 * 2.0**-23
    assert float(R.tc_sums(one, a, b)) == 1.0
    assert float(R.tc_sums(one, a, b, *RIVALS["to nearest"])) == 1 + 2.0**-23
    a = torch.ones(1, 16, dtype=torch.float64)
    b = torch.full((1, 16), 2.0**-25, dtype=torch.float64)
    b[0, 0] = 0.0
    assert float(R.tc_sums(one, a, b, 16, 20, True, True)) == 1 + 3 * 2.0**-23
    assert float(R.tc_sums(one, a, b, 1, 20, True, True)) == 1.0


def test_probe_operands_tell_the_rivals_apart():
    """On a card that follows MEASURED, every rival one feature apart gets
    outputs of the probe wrong: the probe tells truncation from rounding to
    nearest and one rounding per k16 step from one per addition."""
    runs = []
    for kind in R.KINDS:
        a, b, c = R.probe_operands(kind, 0)
        d = R.tc_sums(c, a.double()[:, None, :], b.double()[None, :, :]).float()
        runs.append((a, b, c, d))
    wrong = R.fit(runs, [R.MEASURED, *RIVALS.values()])
    assert wrong[R.MEASURED] == 0
    for label, m in RIVALS.items():
        assert wrong[m] > 0, label


@pytest.mark.parametrize("H,W", [(8, 10), (6, 6)])
def test_conv_sums_within_the_model_bound_of_the_exact_conv(H, W):
    """The replay of K7's bf16 conv against a float64 conv: within (26 2^-25
    + 2 2^-23) A of it, A = sum_j |w_j x_j| (``edge_tower.cu``'s band)."""
    g = torch.Generator().manual_seed(H)
    x = (torch.rand(3, 1, H, W, generator=g) * 2 - 1).bfloat16().float()
    w = (torch.randn(25, 6, generator=g) * 0.1).bfloat16().float()
    z = R.conv_sums(x, w, chunk=2)
    kern = w.T.reshape(6, 1, 5, 5).double()
    exact = F.conv2d(x.double(), kern, padding=2)
    a = F.conv2d(x.double().abs(), kern.abs(), padding=2)
    assert bool(((z.double() - exact).abs() <= (26 * 2.0**-25 + 2 * 2.0**-23) * a).all())
    assert z.dtype == torch.float32 and z.shape == (3, 6, H, W)


def test_probes_refuse_cpu_tensors():
    a, b, c = R.probe_operands("mixed", 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.probe_sums(a, b, c)
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.probe_tap_sums(torch.zeros(64, 64, dtype=torch.bfloat16),
                         torch.zeros(64, 32, dtype=torch.bfloat16))


def test_tc_sums_of_zeros_are_zero():
    """All-zero steps (the edge maps' empty windows) sum to 0, not NaN."""
    z = torch.zeros(4, dtype=torch.float64)
    a = torch.zeros(4, 16, dtype=torch.float64)
    b = torch.ones(4, 16, dtype=torch.float64)
    for m in (R.MEASURED, (1, 20, False, False)):
        assert torch.equal(R.tc_sums(z, a, b, *m), z)
    x = torch.zeros(2, 1, 8, 8)
    assert torch.equal(R.conv_sums(x, torch.randn(25, 3)), torch.zeros(2, 3, 8, 8))
