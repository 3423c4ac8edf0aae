"""Port CNN (``models/cnn.py``, CompVBPR's AlexNet-style edge tower) vs the
JAX package's ``CNN.apply``, on the CPU, from JAX's params carried across
on the same numpy-seeded images.

- the forward at 16x16, 32x32, an odd 20x28 (the stride-4 conv's and the
  -inf pools' asymmetric SAME padding) and the reference's 224x224 at
  B = 2, 1- and 3-channel: rtol 1e-5, atol 1e-6;
- train-mode dropout with JAX's own keep-masks fed in;
- the gradients of every parameter against ``jax.grad``: rtol 1e-4 (atol
  1e-5 of each gradient's largest entry);
- ``tests/test_cnn.py``'s shape and dropout checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.models.cnn import CNN as JCNN
from fashionvisualexpl_tpu_torch.models.cnn import CNN, same_pads

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5


def pair(hw, k=8, cin=1, key=0):
    """(JAX CNN, its params, the port's CNN holding them)."""
    jc = JCNN(k, in_channels=cin, input_hw=hw)
    params = jc.init(jax.random.PRNGKey(key))
    pc = CNN(k, in_channels=cin, input_hw=hw, device="cpu")
    with torch.no_grad():
        for name, p in pc.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name])))
    return jc, params, pc


def images(B, hw, cin=1, seed=0):
    return np.random.default_rng(seed).random((B, *hw, cin)).astype(np.float32)


def jax_masks(key, B, rate=0.5):
    """JAX's train-mode keep-masks of ``apply(rng=key)``: fc6's, fc7's."""
    r1, r2 = jax.random.split(key)
    return [torch.from_numpy(np.array(jax.random.bernoulli(r, 1.0 - rate, (B, 4096))))
            for r in (r1, r2)]


@pytest.mark.parametrize("hw,cin,B", [((16, 16), 1, 3), ((32, 32), 1, 3), ((20, 28), 1, 3),
                                      ((19, 19), 3, 2), ((224, 224), 1, 2)],
                         ids=["16x16", "32x32", "20x28", "19x19x3", "224x224"])
def test_apply_matches_jax(hw, cin, B):
    jc, params, pc = pair(hw, cin=cin)
    assert pc.flat_dim == jc.flat_dim
    assert sorted(dict(pc.named_parameters())) == sorted(params)
    x = images(B, hw, cin)
    want = np.asarray(jc.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pc.encode(torch.from_numpy(x)).numpy()
    assert got.shape == (B, 8)
    np.testing.assert_allclose(got, want, **TOL)


def test_same_padding_is_xlas():
    """The stride-4 11x11 conv pads 3 before and 4 after at 224 and 32; the
    stride-1 convs symmetrically; an odd size takes the extra pixel after."""
    assert same_pads(224, 11, 4) == same_pads(32, 11, 4) == (3, 4)
    assert same_pads(19, 11, 4) == (4, 4)
    assert same_pads(28, 5, 1) == (2, 2) and same_pads(7, 3, 1) == (1, 1)
    assert same_pads(5, 2, 2) == (0, 1) and same_pads(4, 2, 2) == (0, 0)


def test_train_mode_dropout_with_jax_masks():
    jc, params, pc = pair((20, 28), key=1)
    x = images(4, (20, 28), seed=1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jc.apply(params, jnp.asarray(x), rng=key))
    with torch.no_grad():
        got = pc.encode(torch.from_numpy(x), rng=jax_masks(key, 4)).numpy()
        eval_mode = pc.encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(got, eval_mode)


def test_grads_match_jax_for_every_param():
    jc, params, pc = pair((20, 28), key=2)
    x = images(3, (20, 28), seed=2)
    key = jax.random.PRNGKey(4)
    w = np.random.default_rng(5).normal(size=(3, 8)).astype(np.float32)

    def jloss(pp):
        return jnp.sum(jc.apply(pp, jnp.asarray(x), rng=key) * w)

    jg = jax.grad(jloss)(params)
    names = [k for k, _ in pc.named_parameters()]
    out = pc.encode(torch.from_numpy(x), rng=jax_masks(key, 3))
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), list(pc.parameters()))
    for name, g in zip(names, grads):
        want = np.asarray(jg[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_FLOOR * float(np.abs(want).max()), err_msg=name)


def test_shapes_small_input():
    """tests/test_cnn.py::test_shapes_small_input."""
    cnn = CNN(16, in_channels=1, input_hw=(32, 32), device="cpu")
    out = cnn.encode(torch.from_numpy(images(3, (32, 32))))
    assert out.shape == (3, 16) and bool(torch.isfinite(out).all())


def test_dropout_behavior():
    """tests/test_cnn.py::test_dropout_behavior: eval mode deterministic,
    train mode stochastic."""
    cnn = CNN(8, in_channels=1, input_hw=(16, 16), device="cpu",
              generator=torch.Generator().manual_seed(1))
    x = torch.ones(2, 16, 16, 1)
    with torch.no_grad():
        torch.testing.assert_close(cnn.encode(x), cnn.encode(x), rtol=0, atol=0)
        t1 = cnn.encode(x, rng=torch.Generator().manual_seed(0))
        t2 = cnn.encode(x, rng=torch.Generator().manual_seed(1))
    assert not torch.allclose(t1, t2)


def test_init_draws_glorot_and_bf16_runs():
    cnn = CNN(8, in_channels=1, input_hw=(16, 16), device="cpu",
              generator=torch.Generator().manual_seed(2))
    for name, p in cnn.named_parameters():
        x = p.detach()
        if name.endswith("_b"):
            assert float(x.abs().max()) == 0.0, name
            continue
        recept = int(np.prod(x.shape[:-2]))
        lim = np.sqrt(6.0 / ((x.shape[-2] + x.shape[-1]) * recept))
        assert float(x.abs().max()) <= lim and float(x.std()) > lim / 4, name
    bf16 = CNN(8, in_channels=1, input_hw=(16, 16), compute_dtype="bfloat16", device="cpu")
    bf16.load_state_dict(cnn.state_dict())
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    x = torch.rand(3, 16, 16, 1, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y16, y32 = bf16.encode(x), cnn.encode(x)
    assert y16.dtype == torch.float32 and y16.shape == (3, 8)
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), rtol=0,
                               atol=5e-2 * float(y32.abs().max()))
    with pytest.raises(ValueError, match="compute_dtype must be one of"):
        CNN(8, compute_dtype="float16", device="cpu")
