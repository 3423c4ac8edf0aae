"""Port edge tower (``ops/edge_tower.py``, K7) vs the JAX package's.

On the CPU the port computes the tower by its plain version; it is held
against JAX's fused kernel (Pallas, interpret mode) and ``edge_tower_gap_xla``
at the JAX test geometries (``tests/test_edge_tower.py``): forward rtol
1e-5, atol 1e-6; gradients of a sum(sin(.)) loss, and for a given upstream
gradient, rtol 1e-4, atol 1e-5 (f32 sums in another order).  Constant images
tie every pool window and the ReLU boundary: the tie winners must agree
with both JAX versions.  The kernels' arithmetic is held against JAX in
plain PyTorch: the backward's factored tap sums, and the forward's exact
bf16 pieces with truncating accumulation (``edge_tower_gap_split_forward``)
at the forward tolerance, also on worst-case splits, and within its derived
bound of a float64 tower.  The kernel entry points raise for CPU tensors;
the kernels themselves are checked on the card
(``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.ops.edge_tower import edge_tower_gap as jgap
from fashionvisualexpl_tpu.ops.edge_tower import edge_tower_gap_xla as jxla
from fashionvisualexpl_tpu_torch.ops import edge_tower as E

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
GEOMETRIES = [(5, 8, 16, 4), (8, 6, 10, 3), (3, 12, 8, 8)]


def _inputs(B=5, H=8, W=16, C=4, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.random((B, H, W, 1)).astype(np.float32)
    cw = (0.1 * rng.standard_normal((5, 5, 1, C))).astype(np.float32)
    cb = (0.1 * rng.standard_normal((C,))).astype(np.float32)
    return imgs, cw, cb


def _jax_versions(imgs, cw, cb):
    """{name: f(w, b)} of JAX's two towers on fixed images."""
    x = jnp.asarray(imgs)
    return {"fused": lambda w, b: jgap(x, w, b, 4, True),
            "xla": lambda w, b: jxla(x, w, b)}


@pytest.mark.parametrize("B,H,W,C", GEOMETRIES)
def test_forward_matches_jax(B, H, W, C):
    imgs, cw, cb = _inputs(B, H, W, C, seed=B + C)
    got = E.edge_tower_gap(*(torch.from_numpy(a) for a in (imgs, cw, cb))).numpy()
    np.testing.assert_allclose(
        got, E.edge_tower_gap_plain(*(torch.from_numpy(a) for a in (imgs, cw, cb))).numpy(),
        rtol=0, atol=0)  # on the CPU the wrapper is the plain version
    for name, f in _jax_versions(imgs, cw, cb).items():
        np.testing.assert_allclose(got, np.asarray(f(jnp.asarray(cw), jnp.asarray(cb))),
                                   err_msg=name, **FWD)


@pytest.mark.parametrize("B,H,W,C", GEOMETRIES)
def test_gradients_match_jax(B, H, W, C):
    imgs, cw, cb = _inputs(B, H, W, C, seed=2 * B + C)
    w = torch.from_numpy(cw).requires_grad_(True)
    b = torch.from_numpy(cb).requires_grad_(True)
    x = torch.from_numpy(imgs).requires_grad_(True)
    torch.sin(E.edge_tower_gap(x, w, b)).sum().backward()
    assert x.grad is None  # frozen features: no image gradient
    for name, f in _jax_versions(imgs, cw, cb).items():
        gw, gb = jax.grad(lambda w_, b_: jnp.sum(jnp.sin(f(w_, b_))), argnums=(0, 1))(
            jnp.asarray(cw), jnp.asarray(cb))
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), err_msg=name, **GRAD)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), err_msg=name, **GRAD)


def test_plain_backward_matches_jax_vjp():
    imgs, cw, cb = _inputs(7, 10, 12, 6, seed=3)
    dout = np.random.default_rng(4).standard_normal((7, 6)).astype(np.float32)
    dw, db = E.edge_tower_gap_plain_backward(
        *(torch.from_numpy(a) for a in (imgs, cw, cb, dout)))
    assert dw.shape == (5, 5, 1, 6) and db.shape == (6,)
    for name, f in _jax_versions(imgs, cw, cb).items():
        _, vjp = jax.vjp(f, jnp.asarray(cw), jnp.asarray(cb))
        jw, jb = vjp(jnp.asarray(dout))
        np.testing.assert_allclose(dw.numpy(), np.asarray(jw), err_msg=name, **GRAD)
        np.testing.assert_allclose(db.numpy(), np.asarray(jb), err_msg=name, **GRAD)


@pytest.mark.parametrize("value", [0.5, 0.0])
def test_tie_routing_matches_both_jax_towers(value):
    """Constant images tie every pool window (and, at 0, every ReLU
    boundary): the first-match winners (even column, top row) agree."""
    _, cw, cb = _inputs(C=4)
    imgs = np.full((4, 8, 12, 1), value, np.float32)
    w = torch.from_numpy(cw).requires_grad_(True)
    b = torch.from_numpy(cb).requires_grad_(True)
    E.edge_tower_gap(torch.from_numpy(imgs), w, b).sum().backward()
    for name, f in _jax_versions(imgs, cw, cb).items():
        gw, gb = jax.grad(lambda w_, b_: jnp.sum(f(w_, b_)), argnums=(0, 1))(
            jnp.asarray(cw), jnp.asarray(cb))
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), err_msg=name, **FWD)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), err_msg=name, **FWD)


def test_plain_tower_takes_odd_sizes_like_xla():
    """The plain tower is SAME at odd H, W too (the pool pads at the end);
    the kernel and its wrapper need even sizes."""
    imgs, cw, cb = _inputs(3, 7, 9, 5, seed=6)
    t = [torch.from_numpy(a) for a in (imgs, cw, cb)]
    np.testing.assert_allclose(E.edge_tower_gap_plain(*t).numpy(),
                               np.asarray(jxla(*map(jnp.asarray, (imgs, cw, cb)))), **FWD)
    with pytest.raises(ValueError, match="even"):
        E.edge_tower_gap(*t)


def test_kernel_entry_points_raise_on_cpu_tensors():
    t = [torch.from_numpy(a) for a in _inputs()]
    before = (E.edge_tower_fwd.launches, E.edge_tower_bwd.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        E.edge_tower_fwd(*t)
    with pytest.raises(ValueError, match="CUDA tensors"):
        E.edge_tower_bwd(*t, torch.zeros(5, 4))
    assert (E.edge_tower_fwd.launches, E.edge_tower_bwd.launches) == before


@pytest.mark.parametrize("bad,match", [
    (dict(images=torch.zeros(2, 8, 8)), r"\[B, H, W, 1\]"),
    (dict(images=torch.zeros(2, 8, 8, 2)), r"\[B, H, W, 1\]"),
    (dict(conv_w=torch.zeros(3, 3, 1, 4)), r"\[5, 5, 1, C\]"),
    (dict(conv_b=torch.zeros(5)), r"conv_b must be \[4\]"),
    (dict(images=torch.zeros(0, 8, 8, 1)), "at least one"),
    (dict(images=torch.zeros(2, 8, 8, 1, dtype=torch.float64)), "float32"),
])
def test_geometry_errors(bad, match):
    args = dict(images=torch.zeros(2, 8, 8, 1), conv_w=torch.zeros(5, 5, 1, 4),
                conv_b=torch.zeros(4))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        E.edge_tower_gap(**args)


def test_fwd_tiles_fit_the_blocks_shared_memory():
    """The forward's tiles: whole 32x32 images, 7 x 2 tiles at 224x224,
    columns in N tiles of 16 pooled pixels (at most 4 a tile, shared evenly,
    so very wide rows run), and the two im2col tiles plus the three staged
    bf16 planes within a block's shared memory at any width."""
    assert E.fwd_tiles(32, 32) == (16, 16, 1)
    assert E.fwd_tiles(224, 224) == (16, 64, 14)
    assert E.fwd_tiles(6, 10) == (3, 16, 1)
    assert E.fwd_tiles(64, 4092) == (16, 64, 64)
    for h, w in ((8, 16), (12, 8), (2, 2), (224, 224), (64, 4092), (2, 130), (34, 36)):
        rp, cw, tiles = E.fwd_tiles(h, w)
        assert 1 <= rp <= E.TILE_ROWS and cw % E.FWD_CHUNK == 0 and cw <= E.FWD_TILE_COLS
        assert tiles == -(-(h // 2) // rp) * -(-(w // 2) // cw)
        ps = next(s for s in range(2 * cw + 4, 2 * cw + 70, 2) if 16 <= s % 64 <= 48)
        assert 2 * 64 * 96 * 2 + 3 * 2 * (2 * rp + 4) * ps <= 232448


def _edge_images(B, H, W, seed):
    """Edge maps as the model's stack holds them (``data/pipeline.py``: L-mode
    tiffs / 255): values k/255, mostly zero."""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 256, (B, H, W, 1)) * (rng.random((B, H, W, 1)) < 0.15)
    return (k / 255.0).astype(np.float32)


def _factored_cases():
    for B, H, W, C in GEOMETRIES:
        yield f"random-{B}x{H}x{W}x{C}", (*_inputs(B, H, W, C, seed=3 * B + C),)
    _, cw, cb = _inputs(C=4, seed=8)
    for v in (0.5, 0.0):
        yield f"constant-{v}", (np.full((4, 8, 12, 1), v, np.float32), cw, cb)
    _, cw, cb = _inputs(C=6, seed=9)
    yield "edges-k/255", (_edge_images(6, 12, 16, seed=10), cw, cb)


@pytest.mark.parametrize("case", list(_factored_cases()), ids=lambda c: c[0])
def test_factored_backward_matches_jax_vjp(case):
    """The kernel's algebra on the CPU: masks by the tie rule, tap sums by
    unfold over the three bf16 pieces, dW = sum_b g T_b, against the VJP of
    JAX's fused tower (interpret mode) and of its XLA tower."""
    _, (imgs, cw, cb) = case
    dout = np.random.default_rng(imgs.shape[0]).standard_normal(
        (imgs.shape[0], cw.shape[3])).astype(np.float32)
    dw, db = E.edge_tower_gap_factored_backward(
        *(torch.from_numpy(a) for a in (imgs, cw, cb, dout)))
    assert dw.shape == (5, 5, 1, cw.shape[3]) and db.shape == (cw.shape[3],)
    for name, f in _jax_versions(imgs, cw, cb).items():
        _, vjp = jax.vjp(f, jnp.asarray(cw), jnp.asarray(cb))
        jw, jb = vjp(jnp.asarray(dout))
        np.testing.assert_allclose(dw.numpy(), np.asarray(jw), err_msg=name, **GRAD)
        np.testing.assert_allclose(db.numpy(), np.asarray(jb), err_msg=name, **GRAD)


@pytest.mark.parametrize("kind", ["random", "k/255", "small-normals"])
def test_bf16x3_split_is_exact(kind):
    rng = np.random.default_rng(11)
    if kind == "random":
        x = rng.standard_normal(100_000) * np.exp2(rng.integers(-60, 60, 100_000))
    elif kind == "k/255":
        x = np.arange(256) / 255.0
    else:  # the smallest values whose pieces all stay normal, and ulp-sized tails
        x = rng.uniform(1, 2, 100_000) * np.exp2(rng.integers(-100, -80, 100_000))
    x = torch.from_numpy(x.astype(np.float32))
    hi, mid, lo = E.split_bf16x3(x)
    for piece in (hi, mid, lo):  # each piece is a bf16 value
        assert torch.equal(piece, piece.to(torch.bfloat16).float())
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())


def test_bwd_tiles_fit_the_blocks_shared_memory():
    """The backward's tiles: whole 32x32 images, 7 x 2 tiles at 224x224,
    rows in multiples of 4 (a slab's windows), and the staged tile of
    16-byte entries within a block's shared memory at any width."""
    assert E.bwd_tiles(32, 32) == (16, 16, 1)
    assert E.bwd_tiles(224, 224) == (16, 56, 14)
    assert E.bwd_tiles(6, 10) == (4, 5, 1)
    assert E.bwd_tiles(64, 4092) == (16, 64, 64)
    for h, w in ((8, 16), (12, 8), (224, 224), (64, 4092), (2, 130)):
        rp, cw, tiles = E.bwd_tiles(h, w)
        assert rp % 4 == 0 and cw <= E.BWD_TILE_COLS
        assert tiles == -(-(h // 2) // rp) * -(-(w // 2) // cw)
        ws = next(s for s in range(2 * cw + 4, 2 * cw + 8) if s % 4 == 1)
        assert 16 * (2 * rp + 4) * ws <= 232448



def _split_forward_cases():
    for B, H, W, C in GEOMETRIES:
        yield f"random-{B}x{H}x{W}x{C}", (*_inputs(B, H, W, C, seed=5 * B + C),)
    _, cw, cb = _inputs(C=4, seed=12)
    for v in (0.5, 0.0):
        yield f"constant-{v}", (np.full((4, 8, 12, 1), v, np.float32), cw, cb)
    _, cw, cb = _inputs(C=6, seed=13)
    yield "edges-k/255", (_edge_images(6, 12, 16, seed=14), cw, cb)
    yield "worst-case-split", tuple(t.numpy() for t in E.split_worst_case(3, 10, 12, 5, seed=15))


@pytest.mark.parametrize("case", list(_split_forward_cases()), ids=lambda c: c[0])
def test_split_forward_matches_jax_within_its_bound(case):
    """The forward kernel's arithmetic on the CPU (the exact bf16 pieces,
    six products, two accumulators, every addition truncated) against JAX's
    fused tower (interpret mode) and its XLA tower at the forward
    tolerance, and against a float64 tower within the derived bound.  On
    edge maps and worst-case splits the bound itself fits the tolerance."""
    name, (imgs, cw, cb) = case
    t = [torch.from_numpy(a) for a in (imgs, cw, cb)]
    got = E.edge_tower_gap_split_forward(*t)
    assert got.dtype == torch.float32 and got.shape == (imgs.shape[0], cw.shape[3])
    for jname, f in _jax_versions(imgs, cw, cb).items():
        np.testing.assert_allclose(got.numpy(), np.asarray(f(jnp.asarray(cw), jnp.asarray(cb))),
                                   err_msg=jname, **FWD)
    z = torch.nn.functional.conv2d(t[0].permute(0, 3, 1, 2).double(),
                                   t[1].double().permute(3, 2, 0, 1), padding=2)
    exact = torch.nn.functional.max_pool2d(
        torch.relu(z + t[2].double()[None, :, None, None]), 2).mean(dim=(2, 3))
    bound = E.edge_tower_fwd_error_bound(*t)
    assert bool(((got.double() - exact).abs() <= bound).all())
    if name in ("edges-k/255", "worst-case-split"):
        assert bool((bound <= FWD["atol"] + FWD["rtol"] * exact.abs()).all())


def test_split_worst_case_maximises_the_dropped_pieces():
    """Every value's mid piece is about 2^-8 of it and its lo piece about
    2^-17, all positive; the pieces sum back exactly."""
    x, w, b = E.split_worst_case(2, 6, 8, 3, seed=1)
    assert x.shape == (2, 6, 8, 1) and w.shape == (5, 5, 1, 3) and b.shape == (3,)
    assert bool((b == 0).all())
    for v in (x, w):
        hi, mid, lo = E.split_bf16x3(v)
        assert bool((v > 0).all())
        assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())
        assert bool(((mid / v - 2.0**-8).abs() < 2.0**-14).all())
        assert bool(((lo / v - 2.0**-17).abs() < 2.0**-22).all())
