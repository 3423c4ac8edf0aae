"""AlexNet-style trainable CNN encoder (port of
``fashionvisualexpl_tpu/models/cnn.py``; reference
src/recommender/models/cnn.py:10-66): 5 conv blocks and 3 FC layers to a
k-dim embedding, CompVBPR's edge-image tower.

conv(64, 11x11, stride 4) -> pool -> conv(256, 5x5) -> pool -> 3x
conv(256, 3x3) -> pool -> FC 4096 -> dropout -> FC 4096 -> dropout -> FC k,
ReLU after every conv and the first two FCs.  As in the JAX package:

- the parameters keep JAX's names and layouts (``conv1_W`` [11, 11, Cin,
  64] HWIO ... ``fc8_b`` [k]), so ``models/convert.py`` copies them as
  they are;
- the convs are TF/XLA SAME: out = ceil(n / stride), the padding split with
  the extra pixel after (the 11x11 stride-4 conv pads 3 before and 4 after
  at 224 and at 32), zeros padded explicitly;
- the 2x2 stride-2 SAME max pools pad odd sizes with -inf at the end;
- the images are NHWC [B, H, W, C]; the convs run channels-first and the
  last pool's output is flattened in NHWC order before fc6;
- dropout (rate 0.5) after fc6 and fc7 in train mode only: ``rng`` is a
  ``torch.Generator`` or the keep-masks (fc6's [B, 4096], then fc7's),
  kept with probability 1 - rate and divided by the keep rate.

The convs and FCs run in full f32 on the card (``core/precision.py``:
``conv2d_f32`` / ``linear_f32``, TF32 off forward and backward).  With
``compute_dtype="bfloat16"`` (JAX's ``CNN.apply``) every parameter and the
images are cast to bf16, the convs, FCs, biases, pools and dropout run in
bf16 (cuDNN's and cuBLAS's bf16 routes on the card) and the output is cast
back to f32; the parameters stay f32.  It has no kernel of its own: in
JAX it is ``lax.conv_general_dilated`` and matmuls, not Pallas.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.core.precision import (
    cast_compute,
    cast_f32,
    conv2d_f32,
    linear_f32,
    resolve_compute_dtype,
)
from fashionvisualexpl_tpu_torch.models.base import (
    Dropout,
    MaskDraw,
    dropout,
    glorot_uniform,
    keep_masks,
)

# (name, kernel, out channels, stride), then the FC widths before fc8
CONVS = (("conv1", 11, 64, 4), ("conv2", 5, 256, 1), ("conv3", 3, 256, 1),
         ("conv4", 3, 256, 1), ("conv5", 3, 256, 1))
FC_HIDDEN = 4096
POOL_AFTER = ("conv1", "conv2", "conv5")


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """TF/XLA SAME padding (before, after) of a k-wide window at ``stride``
    over n pixels: out = ceil(n / stride), the odd pixel after."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME conv of x [B, Cin, H, W] with W in HWIO [kh, kw, Cin, Cout], plus
    b: in full f32 for f32 operands, else in their dtype."""
    kh, kw = W.shape[:2]
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    conv = conv2d_f32 if x.dtype == torch.float32 else F.conv2d
    return conv(x, W.permute(3, 2, 0, 1), stride=stride) + b[:, None, None]


def linear(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ W + b: in full f32 for f32 operands, else in their dtype."""
    return linear_f32(x, W, b) if x.dtype == torch.float32 else x @ W + b


def maxpool_same(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 SAME max pool of [B, C, H, W]: odd H or W padded with
    -inf at the end."""
    h, w = x.shape[2:]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


class CNN(nn.Module):
    """See the module docstring.  Parameters float32 on ``device`` (``None``
    = the CUDA card; raises without one), drawn from ``generator``
    (``None``: a fresh one seeded with 0) in the JAX init's order."""

    def __init__(
        self,
        k: int,
        in_channels: int = 3,
        input_hw: Tuple[int, int] = (224, 224),
        dropout_rate: float = 0.5,
        compute_dtype: str = "float32",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.k = k
        self.in_channels = in_channels
        self.input_hw = tuple(input_hw)
        self.dropout_rate = dropout_rate
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        # spatial size after the stride-4 conv and three 2x2 SAME pools
        h, w = input_hw
        h, w = -(-h // 4), -(-w // 4)
        for _ in POOL_AFTER:
            h, w = -(-h // 2), -(-w // 2)
        self.flat_dim = h * w * 256
        dev = resolve_device(device)

        def empty(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        cin = in_channels
        for name, kk, cout, _ in CONVS:
            setattr(self, f"{name}_W", empty(kk, kk, cin, cout))
            setattr(self, f"{name}_b", empty(cout))
            cin = cout
        for name, fan_in, fan_out in (("fc6", self.flat_dim, FC_HIDDEN),
                                      ("fc7", FC_HIDDEN, FC_HIDDEN), ("fc8", FC_HIDDEN, k)):
            setattr(self, f"{name}_W", empty(fan_in, fan_out))
            setattr(self, f"{name}_b", empty(fan_out))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """GlorotUniform weights in the JAX init's order (conv1_W ...
        conv5_W, fc6_W, fc7_W, fc8_W); zero biases."""
        for name, p in self.named_parameters():
            if name.endswith("_b"):
                p.zero_()
        for name in [c[0] for c in CONVS] + ["fc6", "fc7", "fc8"]:
            p = getattr(self, f"{name}_W")
            p.copy_(glorot_uniform(tuple(p.shape), generator, p.device))

    def dropout_draw(self, rng: Dropout) -> Optional[MaskDraw]:
        """The keep-mask draw of ``rng`` (None: eval mode); one draw serves
        several ``encode_drawn`` calls, the masks handed out in order."""
        return keep_masks(rng, 1.0 - self.dropout_rate) if self.dropout_rate > 0 else None

    def encode(self, images: torch.Tensor, rng: Dropout = None,
               params: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """images [B, H, W, C] -> [B, k] float32 (JAX's ``CNN.apply``);
        ``rng`` enables train-mode dropout; ``params`` (the parameter names
        without a prefix) take the place of the module's own."""
        return self.encode_drawn(images, self.dropout_draw(rng), params)

    def encode_drawn(self, images: torch.Tensor, draw: Optional[MaskDraw],
                     params: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """``encode`` with the dropout masks taken from ``draw``."""
        cd = self.compute_dtype
        p = dict(self.named_parameters()) if params is None else params
        p = {k: cast_compute(v, cd) for k, v in p.items()}
        x = cast_compute(images, cd).permute(0, 3, 1, 2)
        for name, _, _, stride in CONVS:
            x = torch.relu(conv_same(x, p[f"{name}_W"], p[f"{name}_b"], stride))
            if name in POOL_AFTER:
                x = maxpool_same(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order, as JAX's
        for name in ("fc6", "fc7"):
            x = dropout(torch.relu(linear(x, p[f"{name}_W"], p[f"{name}_b"])),
                        self.dropout_rate, draw)
        return cast_f32(linear(x, p["fc8_W"], p["fc8_b"]))
