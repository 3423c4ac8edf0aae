"""Feature extractors (port of ``fashionvisualexpl_tpu/vision/extractors.py``).

- CnnFeatureExtractor: batched CNN classification / feature extraction on
  the card (reference src/vision/CnnFeatureExtractor.py:6-35, which runs
  image by image through Keras; here whole batches run through one
  backbone forward).
- LowFeatureExtractor: edge maps + dominant colors (reference
  src/vision/LowFeatureExtractor.py:37-80): host OpenCV / sklearn, an
  offline path by design.
- color_histogram: masked 8x8x8 RGB histogram (reference
  src/extract_features.py:10-39).
- extract_texture_grams: Gram-matrix texture features, formed in torch on
  the maps' device, resized on the host.

cv2 and sklearn are imported only inside the functions that use them: the
CNN path needs neither.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.device import DeviceLike, resolve_device
from fashionvisualexpl_tpu_torch.core.precision import fp32_math
from fashionvisualexpl_tpu_torch.vision.backbones import (
    RESNET50_BLOCKS,
    RESNET152_BLOCKS,
    VGG19,
    ResNet,
    load_state_dict_file,
    load_torch_resnet50_state_dict,
    load_torch_resnet152_state_dict,
    load_torch_vgg19_state_dict,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess(images_uint8: np.ndarray) -> np.ndarray:
    """[B, H, W, 3] uint8 -> normalized float32 (torchvision convention)."""
    x = images_uint8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


class CnnFeatureExtractor:
    """Batched classify / extract over a backbone on ``device`` (``None`` =
    the CUDA card; raises without one; ``"cpu"`` runs on the host).

    ``model_name`` in {ResNet50, ResNet152, VGG19} (the reference's
    registry, CnnFeatureExtractor.py:12-19).  The weights are, in order of
    precedence: ``torch_weights`` (a torchvision state dict file, .npz or
    .pt / .pth), ``params`` (the JAX package's param tree as numpy, carried
    across by ``models/convert.py``), or a random init drawn from
    ``generator`` (``None``: seeded with 0)."""

    def __init__(
        self,
        output_layer: str = "avg_pool",
        model_name: str = "ResNet50",
        imagenet: Optional[Dict[int, str]] = None,
        params=None,
        generator: Optional[torch.Generator] = None,
        torch_weights: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.model_name = model_name
        self.output_layer = output_layer
        self.imagenet = imagenet or {}
        if model_name not in ("ResNet50", "ResNet152", "VGG19"):
            raise NotImplementedError(
                "This feature extractor has not been added yet!"
            )
        self.device = resolve_device(device)
        if params is not None and torch_weights is None:
            from fashionvisualexpl_tpu_torch.models.convert import resnet_from_jax, vgg19_from_jax

            if model_name == "VGG19":
                self.net = vgg19_from_jax(params, device=self.device)
            else:
                blocks = RESNET50_BLOCKS if model_name == "ResNet50" else RESNET152_BLOCKS
                self.net = resnet_from_jax(params, blocks, device=self.device)
        elif model_name == "VGG19":
            self.net = VGG19(device=self.device, generator=generator)
        else:
            blocks = RESNET50_BLOCKS if model_name == "ResNet50" else RESNET152_BLOCKS
            self.net = ResNet(blocks, device=self.device, generator=generator)
        if torch_weights is not None:
            # pretrained torchvision state dict: the semantic-feature path
            # (the reference uses Keras imagenet weights)
            loader = {
                "ResNet50": load_torch_resnet50_state_dict,
                "ResNet152": load_torch_resnet152_state_dict,
                "VGG19": load_torch_vgg19_state_dict,
            }[model_name]
            loader(self.net, load_state_dict_file(torch_weights))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.net, ResNet):
            return self.net.apply(x, with_head=True)
        return self.net.apply(x, output_layer="predictions")

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.net, ResNet):
            if self.output_layer in ("avg_pool", "pool"):
                return self.net.apply(x)
            return self.net.spatial_features(x)  # spatial map output
        return self.net.apply(x, output_layer=self.output_layer)

    def _as_input(self, images) -> torch.Tensor:
        """uint8 images normalize on entry; float input is taken as already
        preprocessed (the offline CLI preprocesses in batches)."""
        images = np.asarray(images)
        if images.dtype == np.uint8:
            images = preprocess(images)
        return torch.from_numpy(np.require(images, np.float32, ["C"])).to(self.device)

    @torch.inference_mode()
    def classify(self, images: np.ndarray, filenames: Iterable[str]):
        """Imagenet classification records (CnnFeatureExtractor.py:21-28);
        ``Prob`` from an f32 softmax of the row."""
        logits = self._logits(self._as_input(images)).float()
        cls = logits.argmax(dim=1)
        prob = torch.softmax(logits, dim=1).gather(1, cls[:, None])[:, 0]
        out = []
        for c, p, fname in zip(cls.tolist(), prob.tolist(), filenames):
            out.append(
                {
                    "ImageID": os.path.splitext(fname)[0],
                    "ClassStr": self.imagenet.get(c, str(c)),
                    "ClassNum": c,
                    "Prob": p,
                }
            )
        return out

    @torch.inference_mode()
    def extract_feature(self, images: np.ndarray) -> np.ndarray:
        return self._features(self._as_input(images)).cpu().numpy()


class LowFeatureExtractor:
    """Edge map + dominant colors (LowFeatureExtractor.py:41-80 semantics)."""

    def __init__(self, num_colors: int):
        self.num_colors = num_colors

    def edge_map(self, image_bgr: np.ndarray):
        """Canny + 8-neighbor Laplacian, inverted (:44-50); also returns the
        raw (non-inverted) edge response used for the contour mask."""
        import cv2

        gray = cv2.cvtColor(image_bgr, cv2.COLOR_BGR2GRAY)
        ie1 = cv2.Canny(gray, 255 / 3, 255)
        f = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]])
        ie2 = cv2.filter2D(gray, -1, f)
        ie = ie1 + ie2
        return np.clip(255 - ie, 0, 255), ie

    def foreground_mask(self, image_bgr: np.ndarray, edges: np.ndarray):
        """Largest-contour fill mask — zeros mark foreground (:51-61)."""
        import cv2

        contours, _ = cv2.findContours(
            edges, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE
        )
        if not contours:
            # blank/uniform image: treat the whole frame as foreground
            # (the reference crashes here — sorted([])[0])
            return np.zeros_like(image_bgr)
        info = [(c, cv2.isContourConvex(c), cv2.contourArea(c)) for c in contours]
        max_contour = sorted(info, key=lambda t: t[2], reverse=True)[0]
        mask = np.copy(image_bgr)
        cv2.fillPoly(mask, pts=[max_contour[0]], color=(0, 0, 0))
        return mask

    def extract_color_edges(self, sample):
        """(inverted edge map, flattened dominant colors) — matching
        LowFeatureExtractor.extract_color_edges (:41-80)."""
        import cv2
        from sklearn.cluster import KMeans

        image, _filename = sample
        ie_end, ie = self.edge_map(image)
        mask = self.foreground_mask(image, ie)

        rgb = cv2.cvtColor(image, cv2.COLOR_BGR2RGB) / np.float32(255)
        fg = rgb[(mask == 0).all(axis=2)]
        clt = KMeans(n_clusters=self.num_colors, random_state=1234, n_init=10)
        clt.fit(fg)
        dominant = (clt.cluster_centers_ * 255).astype("uint8")
        return ie_end, dominant.flatten()


def color_histogram(image_bgr: np.ndarray) -> np.ndarray:
    """Foreground-masked 8x8x8 RGB histogram, 512-d int32
    (extract_features.py:10-39)."""
    import cv2

    lf = LowFeatureExtractor(num_colors=1)
    _, ie = lf.edge_map(image_bgr)
    mask = lf.foreground_mask(image_bgr, ie)
    rgb = cv2.cvtColor(image_bgr, cv2.COLOR_BGR2RGB)
    temp = (mask == 0).all(axis=2).astype(np.uint8)
    hist = cv2.calcHist(
        [rgb], [0, 1, 2], temp, [8, 8, 8], [0, 255, 0, 255, 0, 255]
    )
    return np.asarray(hist, dtype=np.int32).flatten()


def extract_texture_grams(spatial_maps, resize_gram=(32, 32)) -> np.ndarray:
    """Gram-matrix texture features (reference src/vision/
    OLD_CnnFeatureExtractor.py:40-61, feeding its CompVBPR texture family):
    for each layer's map [B, H_l, W_l, C_l] (numpy, or a tensor on any
    device), G = F F^T / numel over channel vectors, formed in torch on the
    map's device (f32, no TF32); then resized on the host with cv2 bicubic
    to a fixed grid and flattened; layers concatenate to
    [B, n_layers * prod(resize_gram)]."""
    import cv2

    out = []
    for fmap in spatial_maps:
        f = torch.as_tensor(fmap, dtype=torch.float32)
        B, H, W, C = f.shape
        f = f.reshape(B, H * W, C)
        with fp32_math():
            gram = (torch.einsum("bsc,bsd->bcd", f, f) / float(H * W * C)).cpu().numpy()
        resized = np.stack([
            cv2.resize(g, dsize=resize_gram, interpolation=cv2.INTER_CUBIC)
            for g in gram
        ])
        out.append(resized.reshape(B, -1))
    return np.concatenate(out, axis=1)
