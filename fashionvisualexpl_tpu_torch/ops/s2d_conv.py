"""Space-to-depth re-expression of the single-channel 5x5 edge conv (port of
``fashionvisualexpl_tpu/ops/s2d_conv.py``), as plain PyTorch.

AttentiveFashion's edges tower is Conv2D(F, 5x5, SAME, relu) -> MaxPool(2x2,
s2, SAME) -> GAP over a single-channel [B, H, W, 1] edge map.  On a 2x2
space-to-depth layout the same function is one SAME 3x3 conv:

- input  [B, H, W, 1]  ->  X [B, H/2, W/2, 4]        (c = (ri, rj))
- kernel [5, 5, 1, F]  ->  W' [3, 3, 4, 4F]          (o = (di, dj, f))
- output channel (di, dj, f) at packed pixel (p, q) is the original conv's
  output at full-resolution pixel (2p+di, 2q+dj); each output channel
  reads 25 of the 36 packed taps, the rest are structural zeros;
- the pool's 2x2 windows are exactly the (di, dj) groups, so pooling is a
  max over 4 channels.

The same taps and the same adds as the direct conv; it needs even H, W.
The kernel re-pack is a gather, so gradients flow to ``conv_W`` and
``conv_b`` through the same map.  In the JAX package this is an XLA
re-expression, not a Pallas kernel, and here it stays a plain op with no
kernel: ``AttentiveFashion(edge_tower="s2d")`` runs it in the images' dtype,
as JAX does: on float32 images its conv in full f32
(``core/precision.py::conv2d_f32``); on bfloat16 images the packed kernel,
the conv (cuDNN's bf16 conv on the card), the bias, ReLU and pool in bf16,
the mean in f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fashionvisualexpl_tpu_torch.core.precision import conv2d_f32


def _s2d_kernel_index_map(kh: int = 5, kw: int = 5, s: int = 2) -> np.ndarray:
    """[kh', kw', s*s, s*s] int map into the flattened [kh*kw] kernel
    (kh*kw is the missing-tap sentinel: a zero row).

    Entry [dp, dq, c=(ri,rj), o=(di,dj)] names the original kernel tap
    (u, v) that connects packed input channel (ri, rj) at packed offset
    (dp-1, dq-1) to full-res output offset (di, dj):
        u = s*(dp-1) + ri + (kh//2) - di,  v likewise.
    """
    khp = (kh // 2 + s - 1) // s * 2 + 1  # 3 for kh=5, s=2
    kwp = (kw // 2 + s - 1) // s * 2 + 1
    idx = np.full((khp, kwp, s * s, s * s), kh * kw, np.int64)
    for dp in range(khp):
        for dq in range(kwp):
            for ri in range(s):
                for rj in range(s):
                    for di in range(s):
                        for dj in range(s):
                            u = s * (dp - khp // 2) + ri + kh // 2 - di
                            v = s * (dq - kwp // 2) + rj + kw // 2 - dj
                            if 0 <= u < kh and 0 <= v < kw:
                                idx[dp, dq, ri * s + rj, di * s + dj] = u * kw + v
    return idx


def pack_kernel_s2d(conv_W: torch.Tensor, s: int = 2) -> torch.Tensor:
    """[kh, kw, 1, F] -> [kh', kw', s^2, s^2 * F] packed kernel (a gather,
    differentiable; dead taps read a structural zero row)."""
    kh, kw, cin, n_f = conv_W.shape
    if cin != 1:
        raise ValueError("space-to-depth repack assumes a 1-channel input")
    idx = torch.from_numpy(_s2d_kernel_index_map(kh, kw, s)).to(conv_W.device)
    flat = torch.cat([conv_W.reshape(kh * kw, n_f),
                      conv_W.new_zeros((1, n_f))])  # [kh*kw + 1, F]
    w = flat[idx]  # [kh', kw', s2, s2, F]
    return w.reshape(idx.shape[0], idx.shape[1], s * s, s * s * n_f)


def space_to_depth(x: torch.Tensor, s: int = 2) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/s, W/s, s^2 C] (c-order: (ri, rj))."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // s, s, W // s, s, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // s, W // s, s * s * C)


def edge_tower_s2d_gap(images: torch.Tensor, conv_W: torch.Tensor,
                       conv_b: torch.Tensor) -> torch.Tensor:
    """conv(5x5, SAME) -> +b -> relu -> maxpool(2x2, s2, SAME) -> GAP on the
    2x2 space-to-depth layout: images [B, H, W, 1] (H, W even) -> [B, F]
    float32.  The conv, bias, ReLU and max run in the images' dtype
    (``conv_W`` and ``conv_b`` cast to it), the mean in f32."""
    B, H, W, _ = images.shape
    if H % 2 or W % 2:
        raise ValueError("space-to-depth tower requires even H, W")
    n_f = conv_W.shape[-1]
    cd = images.dtype
    x = F.pad(space_to_depth(images, 2).permute(0, 3, 1, 2), (1, 1, 1, 1))  # [B, 4, ., .]
    w = pack_kernel_s2d(conv_W.to(cd), 2).permute(3, 2, 0, 1)  # [4F, 4, 3, 3]
    # [B, 4F, H/2, W/2], channel o = (di, dj, f)
    y = conv2d_f32(x, w) if cd == torch.float32 else F.conv2d(x, w)
    y = torch.relu(y + conv_b.to(cd).repeat(4)[:, None, None])
    # the pool: a max over the (di, dj) group of 4
    y = y.reshape(B, 4, n_f, H // 2, W // 2).amax(dim=1)
    return torch.mean(y.to(torch.float32), dim=(2, 3))  # [B, F]
