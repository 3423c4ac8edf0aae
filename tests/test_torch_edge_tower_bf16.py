"""The edge tower (K7) on bfloat16 images vs the JAX package's, on the CPU.

JAX's ``edge_tower_gap`` on bf16 images (Pallas, interpret mode) rounds the
weights to bf16 (``_weights(..., images.dtype)``), sums the exact products
in f32 and routes the backward's gradient through ``dze.astype(bf16)`` for
dW and the f32 g for db.  The port's two plain versions are held against
JAX's two bf16 routes:

- (a) ``edge_tower_gap_bf16_plain`` and its backward (the bf16 kernels'
  semantics, and the CPU route of ``edge_tower_gap`` on bf16 images)
  against JAX's ``edge_tower_gap(bf16, interpret=True)`` and its VJP at the
  f32 tests' tolerances (forward rtol 1e-5, atol 1e-6; gradients rtol
  1e-4, atol 1e-5): every conv product is exact, so only f32 sums differ;
- (b) ``edge_tower_gap_plain`` on bf16 images (a bf16 conv output, the
  bias, ReLU and pool in bf16, the mean in f32) against
  ``edge_tower_gap_xla`` in bf16, and the bf16 space-to-depth tower against
  JAX's: outputs within 4e-3 of their largest value (one bf16 rounding of
  a conv output), dconv_w within 1e-2 of its largest (bf16 sums of the
  backward in another order).  dconv_b is held within 1e-2 of JAX's
  f32-summed bias gradient (``edge_tower_gap_xla`` in f32 over the bf16
  values, which sends every live window's gradient to the same bias
  whichever pixel wins): XLA sums the bias gradient of a bf16 conv output
  over B*H*W pixels in bf16, and parts from that by up to 28% here, where
  the port's sum (f32 inside PyTorch's bf16 reduction) stays within the
  tolerance.

Over the JAX test geometries, odd pooled sizes, constant images (ties in
every window and, at 0, at every ReLU boundary) and k/255 edge maps.  The
kernel entry points raise for CPU tensors of either dtype, and mixed
dtypes are refused.  The bf16 backward kernel's algebra
(``edge_tower_gap_bf16_mask_backward``) is held against JAX's bf16 kernel
VJP at the gradient tolerance, also at C = 70 (two groups of channels)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.ops.edge_tower import edge_tower_gap as jgap
from fashionvisualexpl_tpu.ops.edge_tower import edge_tower_gap_xla as jxla
from fashionvisualexpl_tpu.ops.s2d_conv import edge_tower_s2d_gap as js2d
from fashionvisualexpl_tpu_torch.ops import edge_tower as E
from fashionvisualexpl_tpu_torch.ops.s2d_conv import edge_tower_s2d_gap
from tests.test_torch_edge_tower import FWD, GRAD, GEOMETRIES, _edge_images, _inputs

BF16_OUT, BF16_GRAD = 4e-3, 1e-2  # shares of the largest value (routes b and s2d)


def _cases():
    for B, H, W, C in GEOMETRIES + [(4, 14, 18, 5)]:  # 7 x 9 pooled: odd both ways
        yield f"random-{B}x{H}x{W}x{C}", _inputs(B, H, W, C, seed=7 * B + C)
    _, cw, cb = _inputs(C=4, seed=21)
    for v in (0.5, 0.0):
        yield f"constant-{v}", (np.full((4, 8, 12, 1), v, np.float32), cw, cb)
    _, cw, cb = _inputs(C=6, seed=22)
    yield "edges-k/255", (_edge_images(6, 12, 16, seed=23), cw, cb)


CASES = list(_cases())
# the bf16 backward kernel's algebra also where the channels fill more than
# one group of 64
_, _CW70, _CB70 = _inputs(C=70, seed=24)
MASK_CASES = CASES + [("random-2x8x12x70", (_inputs(2, 8, 12, 70, seed=25)[0], _CW70, _CB70))]


def _torch(imgs, cw, cb):
    return torch.from_numpy(imgs).bfloat16(), torch.from_numpy(cw), torch.from_numpy(cb)


def _jax_bf16(imgs):
    return jnp.asarray(imgs).astype(jnp.bfloat16)


def _f32_bias_vjp(imgs, cw, cb, dout):
    """JAX's bias gradient of the tower over the bf16 values of the images
    and weights, summed in f32."""
    x32 = _jax_bf16(imgs).astype(jnp.float32)
    w32 = jnp.asarray(cw).astype(jnp.bfloat16).astype(jnp.float32)
    _, vjp = jax.vjp(lambda b_: jxla(x32, w32, b_), jnp.asarray(cb))
    return vjp(jnp.asarray(dout))[0]


def _dout(imgs, cw):
    return np.random.default_rng(imgs.shape[0]).standard_normal(
        (imgs.shape[0], cw.shape[3])).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_kernel_vjp(case_id):
    """JAX's bf16 kernel (interpret mode) on the case: (forward, dconv_w,
    dconv_b) for ``_dout``, computed once a case for the tests that read
    it."""
    imgs, cw, cb = dict(MASK_CASES)[case_id]
    xj = _jax_bf16(imgs)
    out, vjp = jax.vjp(lambda w_, b_: jgap(xj, w_, b_, 4, True), jnp.asarray(cw), jnp.asarray(cb))
    jw, jb = vjp(jnp.asarray(_dout(imgs, cw)))
    return np.asarray(out), np.asarray(jw), np.asarray(jb)


def _close_to_max(got, want, share, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=share * np.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_bf16_plain_matches_jax_kernel_forward_and_vjp(case):
    """(a) against JAX's bf16 kernel (interpret mode), forward and VJP; the
    CPU route of ``edge_tower_gap`` on bf16 images is (a), gradients by
    autograd included, and the images get none."""
    case_id, (imgs, cw, cb) = case
    x, w, b = _torch(imgs, cw, cb)
    want, jw, jb = _jax_kernel_vjp(case_id)
    got = E.edge_tower_gap_bf16_plain(x, w, b)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    dout = _dout(imgs, cw)
    dw, db = E.edge_tower_gap_bf16_plain_backward(x, w, b, torch.from_numpy(dout))
    assert dw.dtype == db.dtype == torch.float32 and dw.shape == w.shape
    np.testing.assert_allclose(dw.numpy(), jw, **GRAD)
    np.testing.assert_allclose(db.numpy(), jb, **GRAD)
    wr, br = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    out = E.edge_tower_gap(xr, wr, br)
    assert torch.equal(out.detach(), got)
    out.backward(torch.from_numpy(dout))
    assert xr.grad is None
    assert torch.equal(wr.grad, dw) and torch.equal(br.grad, db)


@pytest.mark.parametrize("case", MASK_CASES, ids=lambda c: c[0])
def test_bf16_mask_backward_matches_jax_kernel_vjp(case):
    """The bf16 backward kernel's algebra in plain PyTorch (the conv as an
    im2col product of bf16 values, the winners' 0/1 masks times the im2col
    columns and a ones column, dW by g rounded to bf16 and db by the f32 g)
    against the VJP of JAX's bf16 kernel (interpret mode)."""
    case_id, (imgs, cw, cb) = case
    _, jw, jb = _jax_kernel_vjp(case_id)
    dw, db = E.edge_tower_gap_bf16_mask_backward(
        *_torch(imgs, cw, cb), torch.from_numpy(_dout(imgs, cw)))
    assert dw.dtype == db.dtype == torch.float32 and dw.shape == cw.shape
    np.testing.assert_allclose(dw.numpy(), jw, **GRAD)
    np.testing.assert_allclose(db.numpy(), jb, **GRAD)


def test_bf16_kernel_semantics_round_the_weights_and_g():
    """(a) is the f32 tower over the bf16 values of the images and weights
    (not over the f32 weights), and its dW takes g rounded to bf16 while
    db takes the f32 g."""
    imgs, cw, cb = _inputs(3, 8, 10, 4, seed=31)
    x, w, b = _torch(imgs, cw, cb)
    got = E.edge_tower_gap_bf16_plain(x, w, b)
    assert torch.equal(got, E.edge_tower_gap_plain(x.float(), w.bfloat16().float(), b))
    assert not torch.equal(got, E.edge_tower_gap_plain(x.float(), w, b))
    dout = torch.from_numpy(_dout(imgs, cw)) * 1.001
    dw, db = E.edge_tower_gap_bf16_plain_backward(x, w, b, dout)
    n = torch.ones(()) / 20  # (H/2)(W/2) = 20: not a power of two
    g = dout * n
    f_dw, f_db = E.edge_tower_gap_plain_backward(x.float(), w.bfloat16().float(), b, dout)
    np.testing.assert_allclose(db.numpy(), f_db.numpy(), rtol=1e-6, atol=1e-7)
    assert not torch.equal(dw, f_dw)  # g rounded to bf16 for dW
    gh_dw, _ = E.edge_tower_gap_plain_backward(
        x.float(), w.bfloat16().float(), b, g.bfloat16().float() * 20)
    np.testing.assert_allclose(dw.numpy(), gh_dw.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_bf16_plain_route_matches_jax_xla_route(case):
    """(b) against ``edge_tower_gap_xla`` on bf16 images, forward and VJP."""
    _, (imgs, cw, cb) = case
    x, w, b = _torch(imgs, cw, cb)
    xj = _jax_bf16(imgs)
    got = E.edge_tower_gap_plain(x, w, b)
    assert got.dtype == torch.float32
    _close_to_max(got, jxla(xj, jnp.asarray(cw), jnp.asarray(cb)), BF16_OUT)
    dout = _dout(imgs, cw)
    _, vjp = jax.vjp(lambda w_, b_: jxla(xj, w_, b_), jnp.asarray(cw), jnp.asarray(cb))
    jw, jb = vjp(jnp.asarray(dout))
    dw, db = E.edge_tower_gap_plain_backward(x, w, b, torch.from_numpy(dout))
    assert dw.dtype == db.dtype == torch.float32
    _close_to_max(dw, jw, BF16_GRAD, "dconv_w")
    _close_to_max(db, _f32_bias_vjp(imgs, cw, cb, dout), BF16_GRAD, "dconv_b")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_bf16_routes_differ_by_the_conv_outputs_rounding(case):
    """(a) and (b) compute one function; (b) rounds each conv output (and
    the bias add) to bf16, so they part by about a bf16 rounding."""
    _, (imgs, cw, cb) = case
    x, w, b = _torch(imgs, cw, cb)
    a = E.edge_tower_gap_bf16_plain(x, w, b)
    _close_to_max(E.edge_tower_gap_plain(x, w, b), a, BF16_OUT)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_bf16_s2d_tower_matches_jax(case):
    """The space-to-depth tower in bf16 (even H, W) against JAX's, forward
    and the gradients of a sum(sin(.)) loss."""
    _, (imgs, cw, cb) = case
    x, w, b = _torch(imgs, cw, cb)
    xj = _jax_bf16(imgs)
    wr, br = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    got = edge_tower_s2d_gap(x, wr, br)
    assert got.dtype == torch.float32
    _close_to_max(got.detach(), js2d(xj, jnp.asarray(cw), jnp.asarray(cb)), BF16_OUT)
    torch.sin(got).sum().backward()
    jw, jb = jax.grad(lambda w_, b_: jnp.sum(jnp.sin(js2d(xj, w_, b_))), argnums=(0, 1))(
        jnp.asarray(cw), jnp.asarray(cb))
    assert wr.grad.dtype == torch.float32
    _close_to_max(wr.grad, jw, BF16_GRAD, "dconv_w")
    dsin = np.cos(got.detach().numpy())  # d sum(sin(out)) / d out
    _close_to_max(br.grad, _f32_bias_vjp(imgs, cw, cb, dsin), BF16_GRAD, "dconv_b")


def test_bf16_kernel_entry_points_raise_on_cpu_tensors():
    x, w, b = _torch(*_inputs())
    before = (E.edge_tower_fwd.launches, E.edge_tower_bwd.launches,
              E.edge_tower_fwd.launches_bf16, E.edge_tower_bwd.launches_bf16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        E.edge_tower_fwd(x, w, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        E.edge_tower_bwd(x, w, b, torch.zeros(5, 4))
    assert (E.edge_tower_fwd.launches, E.edge_tower_bwd.launches,
            E.edge_tower_fwd.launches_bf16, E.edge_tower_bwd.launches_bf16) == before


@pytest.mark.parametrize("bad,match", [
    (dict(conv_w=torch.zeros(5, 5, 1, 4, dtype=torch.bfloat16)), "float32 conv_w"),
    (dict(conv_b=torch.zeros(4, dtype=torch.bfloat16)), "float32 conv_w and conv_b"),
    (dict(images=torch.zeros(2, 8, 8, 1, dtype=torch.float16)), "float32 or bfloat16 images"),
])
def test_bf16_dtype_mixes_are_refused(bad, match):
    args = dict(images=torch.zeros(2, 8, 8, 1, dtype=torch.bfloat16),
                conv_w=torch.zeros(5, 5, 1, 4), conv_b=torch.zeros(4))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        E.edge_tower_gap(**args)


# The bf16 forward kernel's tiles (``fwd_tiles_bf16``) as the kernel walks
# them: items (image, row band, column band), window groups of 2 pooled
# rows x 16 pooled columns, windows (rr, cc) of a group; a window past the
# tile's end adds nothing.  ``_plane`` copies the staged plane's sizes from
# ``csrc/edge_tower.cu`` (bf16_plane_half / _rows / _shift), which cannot be
# built here: these tests pin that copy (every tap a window group reads
# lies inside the plane; the planes of 3 blocks fit an SM), and the card
# tests (``tests/test_torch_cuda.py``) hold the kernel itself.
TILE_SHAPES = sorted({(h, w) for (_, h, w, _) in GEOMETRIES} | {
    (14, 18), (2, 2), (32, 32), (224, 224), (64, 4092), (34, 36), (18, 200), (10, 12)})


def _plane(rp, cw):
    """(half, rows, shift) words of the kernel's staged planes (a copy)."""
    half = cw + 6
    while half % 32 != 12:
        half += 1
    rows = 2 * (rp + rp % 2) + 4
    return half, rows, (rows * half + 32) // 32 * 32


def _walk_windows(h, w):
    """[h/2, w/2] counts of the pooled pixels an image's windows add."""
    rp, cw, tiles = E.fwd_tiles_bf16(h, w)
    hp, wp = h // 2, w // 2
    sr, sc = -(-hp // rp), -(-wp // cw)
    assert tiles == sr * sc
    half, rows, _ = _plane(rp, cw)
    counts = np.zeros((hp, wp), np.int64)
    for r0 in range(0, sr * rp, rp):
        for q0 in range(0, sc * cw, cw):
            r_end, c_end = min(r0 + rp, hp), min(q0 + cw, wp)
            nchunks = -(-(c_end - q0) // E.FWD_CHUNK)
            for grow in range((r_end - r0 + 1) // 2):
                for chunk in range(nchunks):
                    for rr in range(2):
                        for cc in range(16):
                            # the window's taps: conv rows Y, Y + 1 and
                            # columns X, X + 1 of the tile, 5 x 5 each
                            y, x = 2 * (2 * grow + rr), 2 * (E.FWD_CHUNK * chunk + cc)
                            assert y + 1 + 4 < rows and x + 1 + 4 + 6 + 1 < 2 * half
                            if r0 + 2 * grow + rr < r_end and q0 + 16 * chunk + cc < c_end:
                                counts[r0 + 2 * grow + rr, q0 + 16 * chunk + cc] += 1
    return counts


@pytest.mark.parametrize("h,w", TILE_SHAPES, ids=lambda v: str(v))
def test_bf16_fwd_tiles_cover_every_pooled_pixel_once(h, w):
    assert (_walk_windows(h, w) == 1).all()


@pytest.mark.parametrize("h,w", TILE_SHAPES, ids=lambda v: str(v))
def test_bf16_fwd_tiles_fit_three_blocks_an_sm(h, w):
    """A plane row is a whole number of 16-byte copies, its shifted copy
    starts on 128 bytes, and two plane sets with the weights and sums leave
    room for 3 blocks on an SM of an H100 (228 KB, 1 KB of it a block)."""
    rp, cw, _ = E.fwd_tiles_bf16(h, w)
    assert 1 <= rp <= E.TILE_ROWS and cw % E.FWD_CHUNK == 0 and cw <= E.FWD_BF16_TILE_COLS
    half, rows, shift = _plane(rp, cw)
    assert (4 * half) % 16 == 0 and shift % 32 == 0
    assert 3 * (4096 + 2048 + 2 * 2 * 4 * shift + 1024) <= 228 * 1024


def test_bf16_fwd_tiles_take_whole_32x32_images():
    """One item a 32x32 image (the kernel writes the mean itself: no
    second launch); larger images in tiles of 16 pooled rows by up to 96
    columns, the columns shared evenly."""
    assert E.fwd_tiles_bf16(32, 32) == (16, 16, 1)
    assert E.fwd_tiles_bf16(224, 224) == (16, 64, 14)
    assert E.fwd_tiles_bf16(64, 4092) == (16, 96, 44)
    assert E.fwd_tiles_bf16(18, 200) == (9, 64, 2)
    assert E.fwd_tiles_bf16(2, 2) == (1, 16, 1)


def test_f32_fwd_tiles_are_unchanged():
    """The f32 forward and the bf16 backward keep ``fwd_tiles``."""
    assert [E.fwd_tiles(h, w) for h, w in ((32, 32), (224, 224), (6, 10), (64, 4092), (2, 2),
                                            (34, 36), (18, 200), (8, 16))] == [
        (16, 16, 1), (16, 64, 14), (3, 16, 1), (16, 64, 64), (1, 16, 1), (16, 32, 2),
        (9, 64, 2), (4, 16, 1)]
