"""Fused edge-encoder tower (port of ``fashionvisualexpl_tpu/ops/edge_tower.py``, K7).

GAP(MaxPool2x2(ReLU(Conv5x5_SAME(images) + b))) -> [B, C] f32, for
single-channel images [B, H, W, 1] (H, W even), filters ``conv_w`` in JAX's
HWIO layout [5, 5, 1, C] and bias ``conv_b`` [C], as the hand-written CUDA
kernels of ``csrc/edge_tower.cu``: the forward's conv as ``wgmma`` products
of the weights' and the image's exact bf16 pieces over an im2col tile,
pooled in registers, never writing the [B, H, W, C] activation; the bf16
forward's with the pixels as the product's rows, built in registers from
the staged image, on a persistent grid; the f32 backward's tap sums on the
tensor cores, its conv recomputed in f32; the bf16 backward's conv and tap
sums both by ``wgmma`` on the f32 forward's im2col tile, the winners
decided in registers (design and bounds in the source).  The TPU kernel's
banded matmuls, batch tiles and VMEM budget (``auto_batch_tile``,
``kernel_vmem_bytes``) are Mosaic matters that stay behind: the CUDA
kernels stage tiles of image rows and columns in shared memory
(``fwd_tiles``, ``fwd_tiles_bf16``, ``bwd_tiles``), so any even H, W runs.

- ``edge_tower_fwd`` / ``edge_tower_bwd`` launch the forward and backward
  kernels for CUDA tensors and raise for any other; ``.launches`` counts
  their launches on float32 images, ``.launches_bf16`` on bfloat16 ones.
  The backward recomputes the conv from the images and routes each pooled
  gradient with the TPU kernel's tie rule (even column on the pre-bias
  value, top row on the ReLU'd value, only where pre > 0).
- bfloat16 images (the JAX kernel's bf16 mode, ``_weights(...,
  images.dtype)``) take f32 ``conv_w`` and ``conv_b``: the kernels round
  the weights to bf16, so every conv product is exact and the sums, the
  bias, ReLU, pool and mean run in f32; the backward scales dW by g =
  dout times the f32 reciprocal of (H/2)(W/2), rounded to bf16 (JAX's
  ``dze.astype(cd)``), and db by the f32 g.  ``edge_tower_gap_bf16_plain`` and
  ``edge_tower_gap_bf16_plain_backward`` are that in plain PyTorch;
  ``edge_tower_gap_bf16_mask_backward`` is the bf16 backward kernel's
  algebra (the conv as an im2col product, 0/1 winner masks times the
  im2col columns and a ones column), held against JAX on the CPU; nothing
  on the main path calls it.
- ``edge_tower_gap_split_forward`` and ``edge_tower_fwd_error_bound`` are
  the forward kernel's arithmetic in plain PyTorch and its error bound;
  ``edge_tower_gap_factored_backward`` and ``split_bf16x3`` the backward
  kernel's algebra (0/1 winner masks times the image's exact three-piece
  bf16 split); ``split_worst_case`` makes inputs whose pieces err the most.
  They are held against JAX on the CPU; nothing on the main path calls
  them.
- ``edge_tower_gap`` binds the two in a ``torch.autograd.Function``
  (gradients for ``conv_w`` and ``conv_b``, f32 for bf16 images too:
  straight through the weights' rounding, as JAX's ``dw.astype``; the
  images are frozen features and get none, JAX's zero-gradient contract).
  For CPU tensors it computes the plain version of its dtype.
- ``edge_tower_gap_plain`` is the plain version (``edge_tower_gap_xla``'s
  counterpart) and ``edge_tower_gap_plain_backward`` its gradient by
  autograd; PyTorch's max-pool backward takes the first maximum of each
  window, as XLA's select-and-scatter does.  Its conv runs in f32 both ways
  (``core/precision.py::conv2d_f32``: cuDNN may round f32 convs to TF32
  by default), as the kernels do; nothing outside it changes.  On bfloat16
  images it is ``edge_tower_gap_xla``'s bf16 route instead: the conv with
  ``conv_w`` cast to bf16 and a bf16 output, the bias (cast), ReLU and
  pool in bf16, the mean in f32.  It and the bf16 kernels differ by the
  bf16 rounding of the conv outputs, as JAX's two routes do.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from fashionvisualexpl_tpu_torch.core.precision import conv2d_f32, fp32_math

K = 5  # kernel size of the reference tower (AttentiveFashion.py:57)
TILE_ROWS = 16  # pooled rows of a tile, both kernels
FWD_CHUNK = 16  # pooled columns of one of the forward's N tiles (64 conv pixels)
FWD_TILE_COLS = 64  # the forward's tile: pooled columns at most
BWD_TILE_COLS = 64  # the backward's tile: pooled columns at most
FWD_BF16_TILE_COLS = 96  # the bf16 forward's tile: pooled columns at most (3 blocks an SM)


def check_geometry(images, conv_w, conv_b) -> Tuple[int, int, int, int]:
    """(B, H, W, C) of the tower's inputs; raises ValueError unless images
    are [B, H, W, 1] with B >= 1 and H, W even, conv_w [5, 5, 1, C], conv_b
    [C], on one device, images float32 or bfloat16 and the weights
    float32."""
    if images.dim() != 4 or images.shape[3] != 1:
        raise ValueError(
            f"edge tower: images must be [B, H, W, 1], got {tuple(images.shape)}"
        )
    B, H, W, _ = images.shape
    if conv_w.dim() != 4 or tuple(conv_w.shape[:3]) != (K, K, 1):
        raise ValueError(
            f"edge tower: conv_w must be [5, 5, 1, C], got {tuple(conv_w.shape)}"
        )
    C = conv_w.shape[3]
    if tuple(conv_b.shape) != (C,):
        raise ValueError(f"edge tower: conv_b must be [{C}], got {tuple(conv_b.shape)}")
    if B < 1 or C < 1:
        raise ValueError("edge tower: needs at least one image and one filter")
    if H % 2 or W % 2:
        raise ValueError(f"edge tower: H and W must be even, got {H}x{W}")
    if images.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"edge tower takes float32 or bfloat16 images, got {images.dtype}")
    for name, t in (("images", images), ("conv_w", conv_w), ("conv_b", conv_b)):
        if name != "images" and t.dtype != torch.float32:
            raise ValueError(f"edge tower takes float32 conv_w and conv_b, {name} is {t.dtype}")
        if t.device != images.device:
            raise ValueError("edge tower inputs must be on one device")
    return B, H, W, C


def fwd_tiles(h: int, w: int) -> Tuple[int, int, int]:
    """(Rp, Cw, S) of the forward kernel: tiles of Rp pooled rows (at most
    TILE_ROWS) by Cw pooled columns (a multiple of FWD_CHUNK, at most
    FWD_TILE_COLS, the chunks shared evenly), S tiles an image."""
    hp, wp = h // 2, w // 2
    rp = min(TILE_ROWS, hp)
    chunks = -(-wp // FWD_CHUNK)
    nc = -(-chunks // (FWD_TILE_COLS // FWD_CHUNK))
    cw = FWD_CHUNK * -(-chunks // nc)
    return rp, cw, -(-hp // rp) * -(-wp // cw)


def fwd_tiles_bf16(h: int, w: int) -> Tuple[int, int, int]:
    """(Rp, Cw, S) of the bf16 forward kernel: tiles of Rp pooled rows (at
    most TILE_ROWS) by Cw pooled columns (a multiple of FWD_CHUNK, at most
    FWD_BF16_TILE_COLS, the chunks shared evenly), S tiles an image."""
    hp, wp = h // 2, w // 2
    chunks = -(-wp // FWD_CHUNK)
    nc = -(-chunks // (FWD_BF16_TILE_COLS // FWD_CHUNK))
    cw = FWD_CHUNK * -(-chunks // nc)
    rp = min(TILE_ROWS, hp)
    return rp, cw, -(-hp // rp) * nc


def bwd_tiles(h: int, w: int) -> Tuple[int, int, int]:
    """(Rp, Cw, S) of the backward kernel: tiles of Rp pooled rows (a
    multiple of 4, at most TILE_ROWS) by Cw pooled columns (at most
    BWD_TILE_COLS, the columns shared evenly), S tiles an image."""
    hp, wp = h // 2, w // 2
    rp = min(TILE_ROWS, -(-hp // 4) * 4)
    nc = -(-wp // BWD_TILE_COLS)
    cw = -(-wp // nc)
    return rp, cw, -(-hp // rp) * -(-wp // cw)


def _pooled(images, conv_w, conv_b) -> torch.Tensor:
    """[B, C, ceil(H/2), ceil(W/2)]: SAME conv (padding 2), + b, ReLU, SAME
    2x2 max-pool (``ceil_mode`` pads odd sizes at the end, where -inf never
    wins), in the images' dtype: f32 in full f32, bf16 with ``conv_w`` and
    ``conv_b`` cast to bf16 (f32 sums inside the conv, a bf16 output)."""
    x = images.permute(0, 3, 1, 2)  # [B, 1, H, W]
    if images.dtype == torch.float32:
        y = conv2d_f32(x, conv_w.permute(3, 2, 0, 1), padding=2)  # [B, C, H, W]
    else:
        y = F.conv2d(x, conv_w.to(images.dtype).permute(3, 2, 0, 1), padding=2)
    y = torch.relu(y + conv_b.to(images.dtype)[None, :, None, None])
    return F.max_pool2d(y, 2, 2, ceil_mode=True)


def edge_tower_gap_plain(images, conv_w, conv_b) -> torch.Tensor:
    """Plain PyTorch tower, ``edge_tower_gap_xla``'s counterpart: SAME conv
    (padding 2), + b, ReLU, SAME 2x2 max-pool in the images' dtype (f32, or
    bf16 with the weights cast), the mean over H, W in f32.  Any H, W."""
    return _pooled(images, conv_w, conv_b).to(torch.float32).mean(dim=(2, 3))


def edge_tower_gap_plain_backward(images, conv_w, conv_b, dout):
    """(dconv_w [5, 5, 1, C], dconv_b [C]) of the plain tower for upstream
    gradient ``dout`` [B, C]."""
    with torch.enable_grad():
        w = conv_w.detach().requires_grad_(True)
        b = conv_b.detach().requires_grad_(True)
        out = edge_tower_gap_plain(images.detach(), w, b)
        dw, db = torch.autograd.grad(out, (w, b), dout)
    return dw, db


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to the nearest bf16 value (even on ties), in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def edge_tower_gap_bf16_plain(images, conv_w, conv_b) -> torch.Tensor:
    """[B, C] f32: the bf16 kernels' forward in plain PyTorch, JAX's
    ``edge_tower_gap`` on bf16 images: the f32 tower over the images' bf16
    values and ``conv_w`` rounded to bf16 (every product exact), the f32
    bias, ReLU, pool and mean.  Any H, W."""
    return edge_tower_gap_plain(images.to(torch.float32), _round_bf16(conv_w), conv_b)


def edge_tower_gap_bf16_plain_backward(images, conv_w, conv_b, dout):
    """(dconv_w [5, 5, 1, C], dconv_b [C]) f32 of the bf16 kernels for
    upstream gradient ``dout`` [B, C]: the pooled gradient g = dout * (1 /
    ((H/2)(W/2))) (the f32 reciprocal, as the JAX kernel's Sel product)
    routed by the f32 tower's first-max rule over the forward's operands; dW
    from g rounded to bf16 (JAX's ``dze.astype(bf16)``) times the bf16
    pixels, summed in f32, db from the f32 g; straight through the weights'
    rounding."""
    H, W = images.shape[1:3]
    n = ((H + 1) // 2) * ((W + 1) // 2)
    g = dout.to(torch.float32) * (torch.ones((), device=dout.device) / n)
    with torch.enable_grad():
        w = _round_bf16(conv_w.detach()).requires_grad_(True)
        b = conv_b.detach().requires_grad_(True)
        pooled = _pooled(images.detach().to(torch.float32), w, b).sum(dim=(2, 3))
        (dw,) = torch.autograd.grad(pooled, w, _round_bf16(g), retain_graph=True)
        (db,) = torch.autograd.grad(pooled, b, g)
    return dw, db


class _Bf16PlainTower(torch.autograd.Function):
    """``edge_tower_gap_bf16_plain`` with its backward (the CPU route of bf16
    images).  The images get no gradient."""

    @staticmethod
    def forward(ctx, images, conv_w, conv_b):
        ctx.save_for_backward(images, conv_w, conv_b)
        return edge_tower_gap_bf16_plain(images, conv_w, conv_b)

    @staticmethod
    def backward(ctx, dout):
        dw, db = edge_tower_gap_bf16_plain_backward(*ctx.saved_tensors, dout)
        return None, dw, db


def split_bf16x3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's split of f32 ``x`` into three bf16 pieces
    (returned as f32): hi = x rounded to nearest onto bf16, mid = x - hi
    rounded, lo = x - hi - mid rounded.  Each difference is exact in f32
    and lo holds the last one exactly, so x == hi + mid + lo wherever the
    pieces stay normal (``mma.cuh::split3_bf16x2``)."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def split_worst_case(B: int, H: int, W: int, C: int, seed: int = 0, device="cpu"):
    """(images [B, H, W, 1], conv_w [5, 5, 1, C], conv_b [C]) f32 on which
    the forward's split drops about the most it can: every pixel and weight
    is (1 + k 2^-7 + 2^-8 - 2^-17 - 2^-23) 2^e, k in {0, 1}, whose bf16
    rounding hi drops just under half a bf16 ulp and whose mid drops just
    under half of its own, so |mid| ~ 2^-8 and |lo| ~ 2^-17 of the value
    (``counts.py::band_worst_case``'s values); all positive, so every term
    of a conv has one sign; pixels 2^e with e in [-3, 0], weights in [-7,
    -4], bias 0.  Made from ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def values(shape, lo, hi):
        k = torch.randint(0, 2, shape, generator=g, device=device).double()
        e = torch.randint(lo, hi + 1, shape, generator=g, device=device).double()
        return ((1 + k * 2.0**-7 + 2.0**-8 - 2.0**-17 - 2.0**-23) * 2.0**e).float()

    images = values((B, H, W, 1), -3, 0)
    conv_w = values((K, K, 1, C), -7, -4)
    return images, conv_w, torch.zeros(C, device=device)


def _trunc_f32(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _windows(t: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, C, H*W] -> [B, C, H/2, W/2, 4]: the four conv pixels of each pool
    window."""
    B, C = t.shape[:2]
    return t.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(
        B, C, H // 2, W // 2, 4)


def edge_tower_gap_split_forward(images, conv_w, conv_b) -> torch.Tensor:
    """[B, C] f32: the forward kernel's arithmetic in plain PyTorch.  Both
    operands split into their exact three bf16 pieces (``split_bf16x3``);
    the six products whose piece orders sum to at most 2, each exact; hi x hi
    summed into one f32 accumulator and the five cross products (w_mid x_hi,
    w_lo x_hi, w_hi x_mid, w_mid x_mid, w_hi x_lo) into another, in the
    kernel's order of k16 steps, every addition truncated toward zero (the
    model of the tensor cores' accumulation that ``counts.cu`` assumes);
    z = the two accumulators added in f32, then relu(max of each 2x2
    window + b) and the mean (in float64, rounded once).  Even H, W."""
    B, H, W, C = check_geometry(images, conv_w, conv_b)
    cols = F.unfold(images.permute(0, 3, 1, 2), K, padding=2)  # [B, 25, H*W]
    xs = [p.double() for p in split_bf16x3(cols)]
    ws = [p.double() for p in split_bf16x3(conv_w.reshape(K * K, C))]

    def accumulate(pairs):
        acc = torch.zeros(B, C, H * W, dtype=torch.float32)
        for step in (range(16), range(16, K * K)):  # the two k16 steps of a piece
            for wi, xi in pairs:
                for j in step:
                    prod = ws[wi][j][None, :, None] * xs[xi][:, j][:, None, :]  # exact
                    acc = _trunc_f32(acc.double() + prod)
        return acc

    hh = accumulate([(0, 0)])
    cross = accumulate([(1, 0), (2, 0), (0, 1), (1, 1), (0, 2)])
    z = _windows(hh + cross, H, W).amax(dim=-1)
    pooled = torch.relu(z + conv_b[None, :, None, None])
    return pooled.double().mean(dim=(2, 3)).float()


def edge_tower_fwd_error_bound(images, conv_w, conv_b) -> torch.Tensor:
    """[B, C] float64: the bound on |forward kernel - exact tower| that
    ``csrc/edge_tower.cu`` derives.  For a conv output with A = sum_j
    |w_j x_j| and A0 the same over the taps of the first k16 step (j < 16):
      e_z = 2^-23 (1.01 (16 A0 + 9 A) + 3.01 A) + 2^-24 |b|
    (hi x hi summed with every addition truncated, the dropped pieces, the
    cross products' sum, the two f32 adds of the epilogue); a pooled value
    errs by at most the largest e_z of its window (max and ReLU are
    1-Lipschitz); the mean adds L 2^-24 mean|pooled| + 2^-24 |out| for the
    L f32 additions of the kernel's longest summation chain (4 windows an N
    tile over a tile's N tiles, two shuffles, the tiles of an image)."""
    B, H, W, C = check_geometry(images, conv_w, conv_b)
    cols = F.unfold(images.permute(0, 3, 1, 2).double().abs(), K, padding=2)
    wa = conv_w.reshape(K * K, C).double().abs()
    terms = wa[None, :, :, None] * cols[:, :, None, :]  # [B, 25, C, H*W]
    a = terms.sum(dim=1)
    a0 = terms[:, :16].sum(dim=1)
    ez = 2.0**-23 * (1.01 * (16 * a0 + 9 * a) + 3.01 * a)
    bias = conv_b.double()[None, :, None, None]
    epool = _windows(ez, H, W).amax(dim=-1) + 2.0**-24 * bias.abs()
    z = F.conv2d(images.permute(0, 3, 1, 2).double(), conv_w.double().permute(3, 2, 0, 1),
                 padding=2)
    pooled = torch.relu(_windows(z.reshape(B, C, H * W), H, W).amax(dim=-1) + bias)
    rp, cw, tiles = fwd_tiles(H, W)
    chain = 4 * rp * (cw // FWD_CHUNK) + 2 + tiles
    out = pooled.mean(dim=(2, 3))  # >= 0
    return epool.mean(dim=(2, 3)) + (chain + 1) * 2.0**-24 * out


def _winner_masks(z: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] f32 0/1: the winning conv pixel of each 2x2 window of
    the pre-bias conv values z [B, C, H, W] whose pre-activation is > 0, by
    the kernels' tie rule (the even column on z, the top row on ReLU(z +
    b))."""
    even = z[..., 0::2] >= z[..., 1::2]  # the even column wins ties
    zh = torch.where(even, z[..., 0::2], z[..., 1::2])
    bias = conv_b[None, :, None, None]
    pre_t, pre_b = zh[:, :, 0::2] + bias, zh[:, :, 1::2] + bias
    top = torch.relu(pre_t) >= torch.relu(pre_b)  # the top row wins ties
    live = torch.where(top, pre_t, pre_b) > 0
    m = torch.zeros_like(z)
    for dy, row in ((0, top), (1, ~top)):
        win_even = even[:, :, dy::2]
        m[:, :, dy::2, 0::2] = (live & row & win_even).float()
        m[:, :, dy::2, 1::2] = (live & row & ~win_even).float()
    return m


def edge_tower_gap_factored_backward(images, conv_w, conv_b, dout):
    """(dconv_w [5, 5, 1, C], dconv_b [C]) as the backward kernel factors
    them, in plain PyTorch: the 0/1 mask M_b[c, p] of the winning conv
    pixels with pre > 0 (the kernel's tie rule on the plain conv's values),
    the tap sums T_b[c, j] = sum_p M_b[c, p] X_b[p, j] over the image's
    5x5 windows (``unfold``) and a column of ones, each as three products
    with the bf16 pieces of X, then dW, db = sum_b g[b, c] T_b[c, :] with
    g = dout / ((H/2)(W/2)).  Even H, W."""
    B, H, W, C = check_geometry(images, conv_w, conv_b)
    x = images.permute(0, 3, 1, 2)  # [B, 1, H, W]
    with fp32_math():
        z = F.conv2d(x, conv_w.permute(3, 2, 0, 1), padding=2)  # [B, C, H, W], pre-bias
    m = _winner_masks(z, conv_b)
    cols = F.unfold(x, K, padding=2)  # [B, 25, H*W], tap ky*5+kx
    cols = torch.cat([cols, torch.ones_like(cols[:, :1])], dim=1)  # [B, 26, H*W]
    m = m.reshape(B, C, H * W)
    taps = sum(torch.bmm(m, piece.transpose(1, 2)) for piece in split_bf16x3(cols))
    g = dout / float((H // 2) * (W // 2))
    dwb = torch.einsum("bc,bcj->jc", g, taps)
    return dwb[: K * K].reshape(K, K, 1, C), dwb[K * K]


def edge_tower_gap_bf16_mask_backward(images, conv_w, conv_b, dout):
    """(dconv_w [5, 5, 1, C], dconv_b [C]) f32 of bf16 ``images`` as the
    bf16 backward kernel factors them, in plain PyTorch: the conv as an
    im2col product of the images' bf16 values and ``conv_w`` rounded to
    bf16, in f32; the 0/1 mask M_b[c, p] of the winning pixels with pre > 0
    by the tie rule on those values; the tap sums T_b = M_b [X_b | 1] (X_b
    [H*W, 25] the image's 5x5 windows, ``unfold``, and a ones column); dW =
    sum_b gh_b T_b[:, :25] with gh = g rounded to bf16, db = sum_b g_b
    T_b[:, 25], g = dout * (1 / ((H/2)(W/2))).  Even H, W."""
    B, H, W, C = check_geometry(images, conv_w, conv_b)
    cols = F.unfold(images.permute(0, 3, 1, 2).to(torch.float32), K, padding=2)  # [B, 25, H*W]
    with fp32_math():
        z = torch.einsum("jc,bjp->bcp", _round_bf16(conv_w.reshape(K * K, C)), cols)
    m = _winner_masks(z.reshape(B, C, H, W), conv_b).reshape(B, C, H * W)
    cols = torch.cat([cols, torch.ones_like(cols[:, :1])], dim=1)  # [B, 26, H*W]
    with fp32_math():
        taps = torch.bmm(m, cols.transpose(1, 2))  # [B, C, 26]
    g = dout.to(torch.float32) * (torch.ones((), device=dout.device) / ((H // 2) * (W // 2)))
    dw = torch.einsum("bc,bcj->jc", _round_bf16(g), taps[:, :, : K * K])
    db = torch.einsum("bc,bc->c", g, taps[:, :, K * K])
    return dw.reshape(K, K, 1, C), db


def type_entries(lib: ctypes.CDLL, suffixes=("", "_bf16")) -> ctypes.CDLL:
    """Sets the argument and return types of the entry points of ``lib``, a
    build of ``csrc/edge_tower.cu``, for each dtype ``suffixes`` names;
    returns ``lib``."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    for suffix in suffixes:
        fwd = getattr(lib, f"fvx_edge_tower_fwd{suffix}")
        bwd = getattr(lib, f"fvx_edge_tower_bwd{suffix}")
        blocks = getattr(lib, f"fvx_edge_tower_bwd_blocks{suffix}")
        fns = [fwd, bwd, blocks]
        if suffix:  # the bf16 forward takes its grid, from its own blocks entry
            fwd.argtypes = [ptr] * 5 + [i64] * 7 + [ptr]
            fwd_blocks = getattr(lib, f"fvx_edge_tower_fwd_blocks{suffix}")
            fwd_blocks.argtypes = [i64] * 2 + [ctypes.POINTER(i64)]
            fns.append(fwd_blocks)
        else:
            fwd.argtypes = [ptr] * 5 + [i64] * 6 + [ptr]
        bwd.argtypes = [ptr] * 5 + [i64, ptr] + [i64] * 6 + [ptr]
        blocks.argtypes = [i64] * 3 + [ctypes.POINTER(i64)]
        for fn in fns:
            fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    from fashionvisualexpl_tpu_torch.ops.cuda_build import load_library

    lib = load_library("edge_tower")
    if not getattr(lib, "_fvx_typed", False):
        type_entries(lib)
        lib._fvx_typed = True
    return lib


def _entry(name: str):
    """The typed entry point ``name`` of the built library, looked up once."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(_library(), name)
    return fn


_entries: dict = {}
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(fn, index: int, *args) -> int:
    """fn(*args, stream) on card ``index``'s current stream, entering its
    device only when it is not the current one."""
    if index == torch.cuda.current_device():
        return fn(*args, _stream(index))
    with torch.cuda.device(index):
        return fn(*args, _stream(index))


def _suffix(images) -> str:
    """The entry points' suffix for the images' dtype."""
    return "_bf16" if images.dtype == torch.bfloat16 else ""


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: int, entry: str, *args: int) -> int:
    """Blocks of a kernel that the card ``device`` holds at once (its grid),
    by its blocks ``entry`` (``fvx_edge_tower_{bwd,fwd}_blocks*``) for the
    kernel's ``args`` (C and the tiles' pooled rows and columns; the bf16
    forward's, the tiles only)."""
    resident = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        rc = _entry(entry)(*args, ctypes.byref(resident))
    if rc != 0:
        raise RuntimeError(f"edge tower kernel setup ({entry}) failed: cudaError {rc}")
    return resident.value


def _coprime_grid(n_items: int, resident: int, tiles: int) -> int:
    """A persistent grid of at most ``resident`` blocks over ``n_items``
    items, coprime with the ``tiles`` items of an image when it is smaller,
    so that each block walks items of every size (the last row and column
    of tiles are ragged)."""
    n_blocks = min(n_items, resident)
    if n_blocks < n_items:
        while math.gcd(n_blocks, tiles) > 1:
            n_blocks -= 1
    return n_blocks


def _kernel_inputs(images, conv_w, conv_b):
    B, H, W, C = check_geometry(images, conv_w, conv_b)
    if images.device.type != "cuda":
        raise ValueError(
            f"the CUDA edge tower takes CUDA tensors, got {images.device}: "
            "edge_tower_gap_plain computes it elsewhere"
        )
    for name, t in (("images", images), ("conv_w", conv_w), ("conv_b", conv_b)):
        if not t.is_contiguous():
            raise ValueError(f"edge tower kernel: {name} must be contiguous")
    return B, H, W, C


def edge_tower_fwd(images, conv_w, conv_b) -> torch.Tensor:
    """[B, C] f32 tower output by the forward kernel of the images' dtype
    (CUDA tensors only): f32 images over ``fwd_tiles``, one block an item;
    bf16 ones over ``fwd_tiles_bf16`` on a persistent grid (no scratch when
    one tile covers an image)."""
    B, H, W, C = _kernel_inputs(images, conv_w, conv_b)
    dev = images.device
    out = torch.empty(B, C, dtype=torch.float32, device=dev)
    if images.dtype == torch.bfloat16:
        if images.data_ptr() % 4:  # the kernel copies 4-byte words: a view on an odd bf16
            images = images.clone()
        rp, cw, tiles = fwd_tiles_bf16(H, W)
        n_blocks = _coprime_grid(B * tiles, _resident_blocks(
            dev.index, "fvx_edge_tower_fwd_blocks_bf16", rp, cw), tiles)
        partial = torch.empty(B * tiles * C if tiles > 1 else 0, dtype=torch.float32, device=dev)
        args = (partial.data_ptr(), out.data_ptr(), n_blocks)
    else:
        rp, cw, tiles = fwd_tiles(H, W)
        partial = torch.empty(B * tiles * C, dtype=torch.float32, device=dev)
        args = (partial.data_ptr(), out.data_ptr())
    rc = _launch(_entry(f"fvx_edge_tower_fwd{_suffix(images)}"), dev.index,
                 images.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), *args,
                 B, H, W, C, rp, cw)
    if rc != 0:
        raise RuntimeError(f"edge tower forward kernel launch failed: cudaError {rc}")
    if images.dtype == torch.bfloat16:
        edge_tower_fwd.launches_bf16 += 1
    else:
        edge_tower_fwd.launches += 1
    return out


def edge_tower_bwd(images, conv_w, conv_b, dout):
    """(dconv_w [5, 5, 1, C], dconv_b [C]) f32 by the backward kernel of the
    images' dtype for upstream gradient ``dout`` [B, C] f32 (CUDA tensors
    only): f32 images over ``bwd_tiles``, bf16 ones over the forward's
    ``fwd_tiles``."""
    B, H, W, C = _kernel_inputs(images, conv_w, conv_b)
    if tuple(dout.shape) != (B, C) or dout.dtype != torch.float32 \
            or dout.device != images.device:
        raise ValueError(
            f"edge tower backward: dout must be [{B}, {C}] float32 on "
            f"{images.device}, got {dout.dtype}{tuple(dout.shape)} on {dout.device}"
        )
    if not dout.is_contiguous():
        raise ValueError("edge tower kernel: dout must be contiguous")
    dev = images.device
    suffix = _suffix(images)
    rp, cw, tiles = fwd_tiles(H, W) if suffix else bwd_tiles(H, W)
    resident = _resident_blocks(dev.index, f"fvx_edge_tower_bwd_blocks{suffix}", C, rp, cw)
    n_blocks = _coprime_grid(B * tiles, resident, tiles) if suffix else min(B * tiles, resident)
    partial = torch.empty(n_blocks * (K * K + 1) * C, dtype=torch.float32, device=dev)
    dwb = torch.empty(K * K + 1, C, dtype=torch.float32, device=dev)
    rc = _launch(_entry(f"fvx_edge_tower_bwd{suffix}"), dev.index,
                 images.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), dout.data_ptr(),
                 partial.data_ptr(), n_blocks, dwb.data_ptr(), B, H, W, C, rp, cw)
    if rc != 0:
        raise RuntimeError(f"edge tower backward kernel launch failed: cudaError {rc}")
    if images.dtype == torch.bfloat16:
        edge_tower_bwd.launches_bf16 += 1
    else:
        edge_tower_bwd.launches += 1
    return dwb[: K * K].view(K, K, 1, C), dwb[K * K]


edge_tower_fwd.launches = edge_tower_fwd.launches_bf16 = 0
edge_tower_bwd.launches = edge_tower_bwd.launches_bf16 = 0


class EdgeTowerGap(torch.autograd.Function):
    """Forward kernel; backward kernel from the saved inputs (it recomputes
    the forward).  The images get no gradient."""

    @staticmethod
    def forward(ctx, images, conv_w, conv_b):
        ctx.save_for_backward(images, conv_w, conv_b)
        return edge_tower_fwd(images, conv_w, conv_b)

    @staticmethod
    def backward(ctx, dout):
        images, conv_w, conv_b = ctx.saved_tensors
        dw, db = edge_tower_bwd(images, conv_w, conv_b, dout.contiguous())
        return None, dw, db


def edge_tower_gap(images, conv_w, conv_b) -> torch.Tensor:
    """GAP(MaxPool2x2(ReLU(Conv5x5_SAME(images) + b))) -> [B, C] f32.

    images [B, H, W, 1] (H, W even) float32 or bfloat16; conv_w [5, 5, 1,
    C] and conv_b [C] float32.  Differentiable in conv_w and conv_b only.
    CUDA tensors go through the kernels of the images' dtype; CPU tensors
    through the plain version (bf16: ``edge_tower_gap_bf16_plain``)."""
    check_geometry(images, conv_w, conv_b)
    if images.device.type == "cpu":
        if images.dtype == torch.bfloat16:
            return _Bf16PlainTower.apply(images.detach(), conv_w, conv_b)
        return edge_tower_gap_plain(images.detach(), conv_w, conv_b)
    return EdgeTowerGap.apply(images, conv_w, conv_b)
