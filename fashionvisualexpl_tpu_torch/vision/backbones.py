"""CNN backbones (port of ``fashionvisualexpl_tpu/vision/backbones.py``):
bottleneck ResNet (50/152) and VGG19 for the feature-extraction path.

The reference wraps Keras pretrained ResNet50/VGG19/ResNet152
(src/vision/CnnFeatureExtractor.py:12-19).  Here, as in the JAX package,
the backbones are the package's own modules (torchvision is not a
dependency), randomly initialised unless torchvision-layout weights are
loaded (``load_torch_resnet50_state_dict`` / ``..._resnet152_...`` /
``load_torch_vgg19_state_dict``, file loader ``load_state_dict_file``).

- Images are NHWC [B, H, W, 3] in and the outputs NHWC too ([B, 2048],
  [B, H', W', 2048], [B, h, w, 512]); inside, the modules run NCHW
  (contiguous: cuDNN's f32 convs at 224x224 ran 15-20% slower in the
  channels-last layout an NHWC view carries through), and the conv
  weights are kept in torch's OIHW layout (torchvision
  weights load as they are; ``models/convert.py`` transposes the JAX
  package's HWIO).  The parameter and buffer names are the JAX params'
  flattened names (``stem_W``, ``s0b0.bn1.scale``, ``c0_0_W``, ``fc1_W``).
- Convs pad symmetrically by k // 2 (torch's padding, not XLA SAME, which
  differs at stride 2); the ResNet stem's 3x3 stride-2 max pool pads with
  -inf; VGG19's 2x2 pools are SAME (ceil mode: an odd size keeps its last
  row / column), so ``feat_hw`` rounds up.
- VGG19 flattens ``block5_pool`` in HWC order, as the JAX package does:
  ``fc1_W`` is [h * w * 512, 4096] with HWC rows.
- Batch norm in eval mode uses the running statistics; ``train=True`` the
  batch's mean and biased variance; eps 1e-5.
- Every conv and matmul runs in full f32 (``core/precision.py::fp32_math``:
  no TF32).  In JAX these are XLA convs and matmuls, not Pallas, so the
  port has no kernel of its own here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.core.precision import fp32_math
from fashionvisualexpl_tpu_torch.models.base import glorot_uniform

RESNET50_BLOCKS = (3, 4, 6, 3)
RESNET152_BLOCKS = (3, 8, 36, 3)
STAGE_CHANNELS = (256, 512, 1024, 2048)

VGG19_CFG = (
    (64, 64), (128, 128), (256, 256, 256, 256),
    (512, 512, 512, 512), (512, 512, 512, 512),
)
VGG19_LAYERS = tuple(f"block{s + 1}_pool" for s in range(5)) + ("fc1", "fc2", "predictions")

StateDict = Mapping[str, Union[np.ndarray, torch.Tensor]]


def _generator(generator: Optional[torch.Generator], dev: torch.device) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device=dev).manual_seed(0)


def _conv_param(shape_hwio, generator, dev) -> nn.Parameter:
    """GlorotUniform over the JAX shape [kh, kw, in, out], kept OIHW."""
    w = glorot_uniform(tuple(shape_hwio), generator, dev)
    return nn.Parameter(w.permute(3, 2, 0, 1).contiguous())


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Conv with symmetric torch-style padding k // 2."""
    return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)


class BatchNorm(nn.Module):
    """``scale`` and ``bias`` parameters, ``mean`` and ``var`` buffers."""

    def __init__(self, c: int, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:  # the batch's statistics as JAX forms them; running ones untouched
            mean = x.mean(dim=(0, 2, 3), keepdim=True)
            var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
            c = (-1, 1, 1)
            return ((x - mean) * torch.rsqrt(var + 1e-5) * self.scale.view(c)
                    + self.bias.view(c))
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0, 1e-5)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stage's stride) -> 1x1, projection on the first
    block of a stage (torchvision's v1.5: the stride on the 3x3)."""

    def __init__(self, in_c: int, out_c: int, stride: int, project: bool,
                 generator: torch.Generator, dev: torch.device):
        super().__init__()
        mid = out_c // 4
        self.stride = stride
        self.W1 = _conv_param((1, 1, in_c, mid), generator, dev)
        self.bn1 = BatchNorm(mid, dev)
        self.W2 = _conv_param((3, 3, mid, mid), generator, dev)
        self.bn2 = BatchNorm(mid, dev)
        self.W3 = _conv_param((1, 1, mid, out_c), generator, dev)
        self.bn3 = BatchNorm(out_c, dev)
        if project:
            self.Wd = _conv_param((1, 1, in_c, out_c), generator, dev)
            self.bnd = BatchNorm(out_c, dev)

    def forward(self, y: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = torch.relu(self.bn1(_conv(y, self.W1), train))
        h = torch.relu(self.bn2(_conv(h, self.W2, self.stride), train))
        h = self.bn3(_conv(h, self.W3), train)
        if hasattr(self, "Wd"):
            y = self.bnd(_conv(y, self.Wd, self.stride), train)
        return torch.relu(y + h)


class ResNet(nn.Module):
    """Bottleneck ResNet (50/152).  ``apply`` returns the pooled [B, 2048]
    features (the reference's ``avg_pool`` output layer), or logits with the
    fc head; ``spatial_features`` the last stage's [B, H', W', 2048] map.
    Parameters float32 on ``device`` (``None`` = the CUDA card; raises
    without one), drawn from ``generator`` (``None``: a fresh one seeded
    with 0) in the JAX init's order."""

    def __init__(self, blocks: Tuple[int, ...] = RESNET50_BLOCKS, num_classes: int = 1000,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = tuple(blocks)
        self.num_classes = num_classes
        self.stage_channels = STAGE_CHANNELS
        dev = resolve_device(device)
        g = _generator(generator, dev)
        self.stem_W = _conv_param((7, 7, 3, 64), g, dev)
        self.stem_bn = BatchNorm(64, dev)
        in_c = 64
        for s, (n_blocks, out_c) in enumerate(zip(self.blocks, STAGE_CHANNELS)):
            for b in range(n_blocks):
                stride = 2 if (b == 0 and s > 0) else 1
                self.add_module(f"s{s}b{b}", Bottleneck(in_c, out_c, stride, b == 0, g, dev))
                in_c = out_c
        self.fc_W = nn.Parameter(glorot_uniform((2048, num_classes), g, dev))
        self.fc_b = nn.Parameter(torch.zeros(num_classes, device=dev))

    @property
    def device(self) -> torch.device:
        return self.stem_W.device

    def _trunk(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """NHWC images -> the last stage's NCHW map."""
        y = _conv(x.permute(0, 3, 1, 2).contiguous(), self.stem_W, 2)
        y = torch.relu(self.stem_bn(y, train))
        y = F.max_pool2d(y, 3, stride=2, padding=1)  # -inf pads, VALID 3x3 / 2
        for s, n_blocks in enumerate(self.blocks):
            for b in range(n_blocks):
                y = getattr(self, f"s{s}b{b}")(y, train)
        return y

    def apply(self, x: torch.Tensor, train: bool = False, with_head: bool = False) -> torch.Tensor:
        with fp32_math():
            pooled = self._trunk(x, train).mean(dim=(2, 3))  # [B, 2048]: 'avg_pool'
            if with_head:
                return pooled @ self.fc_W + self.fc_b
            return pooled

    def spatial_features(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Final-stage spatial map [B, H', W', 2048] (ACF's per-item maps)."""
        with fp32_math():
            return self._trunk(x, train).permute(0, 2, 3, 1).contiguous()


class VGG19(nn.Module):
    """VGG19 with the fc1 / fc2 heads; the reference extracts ``fc2``
    (4096-d, train_rec.py:41-43).  ``apply(output_layer=)`` takes any of
    ``VGG19_LAYERS`` (another name gives the predictions, as in JAX).
    Device and generator as ``ResNet``'s."""

    def __init__(self, num_classes: int = 1000, input_hw: Tuple[int, int] = (224, 224),
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        h, w = input_hw
        for _ in range(5):
            h, w = -(-h // 2), -(-w // 2)
        self.feat_hw = (h, w)  # block5_pool spatial dims (7x7 at 224)
        self.flat_dim = h * w * 512
        dev = resolve_device(device)
        g = _generator(generator, dev)
        in_c = 3
        for s, stage in enumerate(VGG19_CFG):
            for b, c in enumerate(stage):
                setattr(self, f"c{s}_{b}_W", _conv_param((3, 3, in_c, c), g, dev))
                setattr(self, f"c{s}_{b}_b", nn.Parameter(torch.zeros(c, device=dev)))
                in_c = c
        for name, fan_in, fan_out in (("fc1", self.flat_dim, 4096), ("fc2", 4096, 4096),
                                      ("fc3", 4096, num_classes)):
            setattr(self, f"{name}_W", nn.Parameter(glorot_uniform((fan_in, fan_out), g, dev)))
            setattr(self, f"{name}_b", nn.Parameter(torch.zeros(fan_out, device=dev)))

    @property
    def device(self) -> torch.device:
        return self.fc1_W.device

    def apply(self, x: torch.Tensor, output_layer: str = "fc2") -> torch.Tensor:
        with fp32_math():
            y = x.permute(0, 3, 1, 2).contiguous()
            for s, stage in enumerate(VGG19_CFG):
                for b in range(len(stage)):
                    y = torch.relu(F.conv2d(y, getattr(self, f"c{s}_{b}_W"),
                                            getattr(self, f"c{s}_{b}_b"), padding=1))
                y = F.max_pool2d(y, 2, 2, ceil_mode=True)  # SAME: odd sizes round up
                if output_layer == f"block{s + 1}_pool":
                    return y.permute(0, 2, 3, 1).contiguous()
            y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)  # HWC flatten, as JAX's
            fc1 = torch.relu(y @ self.fc1_W + self.fc1_b)
            if output_layer == "fc1":
                return fc1
            fc2 = torch.relu(fc1 @ self.fc2_W + self.fc2_b)
            if output_layer == "fc2":
                return fc2
            return fc2 @ self.fc3_W + self.fc3_b  # 'predictions'


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.require(np.asarray(v, np.float32), requirements=["C", "W"]))


def _assign(target: torch.Tensor, value, name: str) -> None:
    value = _tensor(value)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} != the port's "
                         f"{tuple(target.shape)}")
    target.copy_(value)


@torch.no_grad()
def load_torch_resnet_state_dict(model: ResNet, state_dict: StateDict) -> ResNet:
    """Copy a torchvision resnet50/101/152 state dict into ``model`` (in
    place; returned) — the block layout comes from ``model.blocks``, so one
    converter covers every bottleneck depth.  Conv weights are OIHW on both
    sides; ``fc.weight`` is transposed to ``fc_W`` [2048, classes]."""

    def bn(mod: BatchNorm, prefix: str):
        for mine, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            _assign(getattr(mod, mine), state_dict[f"{prefix}.{theirs}"], f"{prefix}.{theirs}")

    _assign(model.stem_W, state_dict["conv1.weight"], "conv1.weight")
    bn(model.stem_bn, "bn1")
    _assign(model.fc_W, _tensor(state_dict["fc.weight"]).T, "fc.weight")
    _assign(model.fc_b, state_dict["fc.bias"], "fc.bias")
    for s, n_blocks in enumerate(model.blocks):
        for b in range(n_blocks):
            t, blk = f"layer{s + 1}.{b}", getattr(model, f"s{s}b{b}")
            for i in (1, 2, 3):
                _assign(getattr(blk, f"W{i}"), state_dict[f"{t}.conv{i}.weight"],
                        f"{t}.conv{i}.weight")
                bn(getattr(blk, f"bn{i}"), f"{t}.bn{i}")
            if f"{t}.downsample.0.weight" in state_dict:
                _assign(blk.Wd, state_dict[f"{t}.downsample.0.weight"],
                        f"{t}.downsample.0.weight")
                bn(blk.bnd, f"{t}.downsample.1")
    return model


def _check_resnet_depth(model: ResNet, state_dict, blocks, name: str) -> None:
    if model.blocks != blocks:
        raise ValueError(
            f"{name} importer called on a ResNet with blocks={model.blocks}; "
            f"expected {blocks}"
        )
    # layer3 is the depth-discriminating stage (6 vs 36 blocks)
    last = f"layer3.{blocks[2] - 1}.conv3.weight"
    if last not in state_dict or f"layer3.{blocks[2]}.conv3.weight" in state_dict:
        raise KeyError(
            f"state dict is not a torchvision {name} (block-count mismatch "
            f"at {last})"
        )


def load_torch_resnet50_state_dict(model: ResNet, state_dict: StateDict) -> ResNet:
    """torchvision resnet50 -> ``model`` (see load_torch_resnet_state_dict)."""
    _check_resnet_depth(model, state_dict, RESNET50_BLOCKS, "resnet50")
    return load_torch_resnet_state_dict(model, state_dict)


def load_torch_resnet152_state_dict(model: ResNet, state_dict: StateDict) -> ResNet:
    """torchvision resnet152 -> ``model`` (see load_torch_resnet_state_dict)."""
    _check_resnet_depth(model, state_dict, RESNET152_BLOCKS, "resnet152")
    return load_torch_resnet_state_dict(model, state_dict)


# torchvision vgg19 conv layer indices inside the `features` Sequential
# (ReLU/MaxPool occupy the gaps): 16 convs across the 5 stages of VGG19_CFG
_VGG19_TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)


@torch.no_grad()
def load_torch_vgg19_state_dict(model: VGG19, state_dict: StateDict) -> VGG19:
    """Copy a torchvision vgg19 state dict into ``model`` (in place;
    returned).  The first classifier Linear's input axis is permuted from
    torch's CHW flatten order to this module's HWC flatten;
    classifier.{0,3,6} play fc1 / fc2 / predictions.  Requires
    ``model.flat_dim`` to match the state dict's classifier input (25088
    <=> 224x224 inputs)."""
    k = 0
    for s, stage in enumerate(VGG19_CFG):
        for b in range(len(stage)):
            idx = _VGG19_TORCH_CONV_IDX[k]
            _assign(getattr(model, f"c{s}_{b}_W"), state_dict[f"features.{idx}.weight"],
                    f"features.{idx}.weight")
            _assign(getattr(model, f"c{s}_{b}_b"), state_dict[f"features.{idx}.bias"],
                    f"features.{idx}.bias")
            k += 1
    fc1 = _tensor(state_dict["classifier.0.weight"])  # [4096, 512*h*w]
    if fc1.shape[1] != model.flat_dim:
        raise ValueError(
            f"classifier.0 expects flat dim {fc1.shape[1]}, model has "
            f"{model.flat_dim} (construct VGG19(input_hw=...) to match; "
            f"torchvision's 25088 corresponds to 224x224 inputs)"
        )
    h, w = model.feat_hw
    # CHW -> HWC flatten permutation, then [in, out] orientation
    fc1 = fc1.reshape(4096, 512, h, w).permute(0, 2, 3, 1).reshape(4096, model.flat_dim).T
    _assign(model.fc1_W, fc1, "classifier.0.weight")
    _assign(model.fc1_b, state_dict["classifier.0.bias"], "classifier.0.bias")
    for mine, idx in (("fc2", 3), ("fc3", 6)):
        _assign(getattr(model, f"{mine}_W"), _tensor(state_dict[f"classifier.{idx}.weight"]).T,
                f"classifier.{idx}.weight")
        _assign(getattr(model, f"{mine}_b"), state_dict[f"classifier.{idx}.bias"],
                f"classifier.{idx}.bias")
    return model


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """Load a state dict shipped as .npz, or .pt / .pth (``torch.load``,
    weights only), into a name -> ndarray dict."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}
