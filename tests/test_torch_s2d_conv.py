"""Port space-to-depth edge tower (``ops/s2d_conv.py``) vs the JAX
package's ``ops/s2d_conv.py`` and the direct tower, on the CPU: the seven
checks of ``tests/test_s2d_conv.py`` (forward and gradients against the
direct conv -> relu -> pool -> GAP, rtol 1e-5, atol 1e-6; the packed
kernel's tap structure; the space-to-depth layout; AttentiveFashion with
``edge_tower="s2d"`` against ``"xla"``; odd sizes refused), each also
against the JAX function on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.ops import s2d_conv as js2d
from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
from fashionvisualexpl_tpu_torch.ops.edge_tower import edge_tower_gap_plain
from fashionvisualexpl_tpu_torch.ops.s2d_conv import (
    _s2d_kernel_index_map,
    edge_tower_s2d_gap,
    pack_kernel_s2d,
    space_to_depth,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def inputs(B, hw, F, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.random((B, *hw, 1)).astype(np.float32)
    cw = rng.normal(size=(5, 5, 1, F)).astype(np.float32) * 0.1
    cb = rng.normal(size=(F,)).astype(np.float32) * 0.1
    return imgs, cw, cb


@pytest.mark.parametrize("hw", [(8, 8), (16, 12)])
def test_s2d_tower_matches_xla(hw):
    imgs, cw, cb = inputs(3, hw, 8, 0)
    got = edge_tower_s2d_gap(*map(torch.from_numpy, (imgs, cw, cb))).numpy()
    np.testing.assert_allclose(
        got, edge_tower_gap_plain(*map(torch.from_numpy, (imgs, cw, cb))).numpy(), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(js2d.edge_tower_s2d_gap(*map(jnp.asarray, (imgs, cw, cb)))), **TOL)


def test_s2d_tower_gradients_match():
    imgs, cw, cb = inputs(2, (8, 8), 4, 1)
    w, b = (torch.from_numpy(x).requires_grad_() for x in (cw, cb))
    x = torch.from_numpy(imgs)
    gw1, gb1 = torch.autograd.grad(edge_tower_gap_plain(x, w, b).sum(), (w, b))
    gw2, gb2 = torch.autograd.grad(edge_tower_s2d_gap(x, w, b).sum(), (w, b))
    jw, jb = jax.grad(lambda a, c: js2d.edge_tower_s2d_gap(jnp.asarray(imgs), a, c).sum(),
                      argnums=(0, 1))(jnp.asarray(cw), jnp.asarray(cb))
    for got, want in ((gw2, gw1.numpy()), (gb2, gb1.numpy()), (gw2, jw), (gb2, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_packed_kernel_tap_structure():
    """Each packed output channel carries exactly kh*kw live taps; the map
    and the packed kernel equal JAX's."""
    w = pack_kernel_s2d(torch.ones(5, 5, 1, 2)).numpy()  # [3, 3, 4, 8]
    assert w.shape == (3, 3, 4, 8)
    np.testing.assert_array_equal(w.reshape(-1, 8).sum(axis=0), np.full(8, 25.0))
    np.testing.assert_array_equal(_s2d_kernel_index_map(), js2d._s2d_kernel_index_map())
    cw = inputs(1, (2, 2), 3, 2)[1]
    np.testing.assert_array_equal(pack_kernel_s2d(torch.from_numpy(cw)).numpy(),
                                  np.asarray(js2d.pack_kernel_s2d(jnp.asarray(cw))))


def test_space_to_depth_roundtrip():
    x = torch.arange(2 * 4 * 6 * 1, dtype=torch.float32).reshape(2, 4, 6, 1)
    y = space_to_depth(x, 2).numpy()  # [2, 2, 3, 4]
    assert y.shape == (2, 2, 3, 4)
    np.testing.assert_array_equal(y[1, 0, 1], x.numpy()[1, 0:2, 2:4, 0].ravel())
    np.testing.assert_array_equal(y, np.asarray(js2d.space_to_depth(jnp.asarray(x.numpy()))))


def _af_arrays(seed):
    rng = np.random.default_rng(seed)
    I = 10
    return (rng.random((I, 5)).astype(np.float32), rng.random((I, 8, 8, 1)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, I)])


def test_model_s2d_tower_matches_xla_tower():
    """AttentiveFashion(edge_tower='s2d') == edge_tower='xla' end to end
    (encoded items, loss), and the JAX s2d model's encodings."""
    from fashionvisualexpl_tpu.models.attentive_fashion import AttentiveFashion as JAF
    from fashionvisualexpl_tpu_torch.models.convert import attentive_fashion_from_jax

    arrays = _af_arrays(2)
    kw = dict(embed_k=8, attention_layers=(4, 1), encoder_hidden=8, dropout_rate=0.0)
    jm = JAF(6, 10, *arrays, edge_tower="s2d", **kw)
    params, frozen = jm.init(jax.random.PRNGKey(0))
    np_p, np_f = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, frozen)
    m_s2d = attentive_fashion_from_jax(jm, np_p, np_f, "cpu")
    assert m_s2d.tower_route == "s2d"
    m_xla = AttentiveFashion(6, 10, *arrays, edge_tower="xla", device="cpu", **kw)
    m_xla.load_state_dict(m_s2d.state_dict())
    with torch.no_grad():
        e2 = m_s2d.encode_items().numpy()
        np.testing.assert_allclose(e2, m_xla.encode_items().numpy(), **TOL)
        np.testing.assert_allclose(e2, np.asarray(jm.encode_items(params, frozen)), **TOL)
        u, p, n = (torch.tensor(v) for v in ([0, 1, 2], [1, 2, 3], [4, 5, 6]))
        np.testing.assert_allclose(float(m_s2d.loss(u, p, n, 0.01)),
                                   float(m_xla.loss(u, p, n, 0.01)), rtol=1e-5)


def test_s2d_rejects_odd_hw():
    rng = np.random.default_rng(3)
    with pytest.raises(ValueError, match="even"):
        AttentiveFashion(4, 6, rng.random((6, 5)).astype(np.float32),
                         rng.random((6, 7, 7, 1)).astype(np.float32),
                         np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)],
                         embed_k=8, edge_tower="s2d", device="cpu")
    with pytest.raises(ValueError, match="even"):
        edge_tower_s2d_gap(torch.zeros(1, 7, 8, 1), torch.zeros(5, 5, 1, 2), torch.zeros(2))
