"""Visual feature loading (port of ``fashionvisualexpl_tpu/data/features.py``;
reference src/dataset/visual_loader_mixin.py).

Loads precomputed feature artifacts from the reference's on-disk layout and
applies its max-abs normalization (visual_loader_mixin.py:22-31,51-69).
Features are float32 numpy arrays; models keep them as non-trainable
buffers on their device.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from fashionvisualexpl_tpu_torch.core.config import Paths


def maxabs_normalize(x: np.ndarray) -> np.ndarray:
    """x / max(|x|) — the reference's normalization (mixin:30, :53, :68)."""
    denom = np.max(np.abs(x))
    if denom == 0:
        return x.astype(np.float32)
    return (x / denom).astype(np.float32)


def load_cnn_features(
    paths: Paths, dataset: str, cnn_model: str, output_layer: str
) -> np.ndarray:
    """[num_items, dim] frozen CNN feature matrix (mixin:22-31)."""
    return maxabs_normalize(
        np.load(paths.cnn_features(dataset, cnn_model, output_layer))
    )


def load_color_histograms(paths: Paths, dataset: str) -> np.ndarray:
    """[num_items, 512] masked RGB histogram matrix (mixin:51-54)."""
    return maxabs_normalize(np.load(paths.hist_color_features(dataset)))


def load_class_onehot(paths: Paths, dataset: str) -> np.ndarray:
    """[num_items, num_classes] one-hot class matrix — NOT normalized, matching
    process_class_visual_features (mixin:56-58)."""
    return np.load(paths.class_features(dataset)).astype(np.float32)


def load_edge_features(
    paths: Paths, dataset: str, cnn_model: str, output_layer: str
) -> np.ndarray:
    """[num_items, dim] edge feature matrix (mixin:60-69)."""
    return maxabs_normalize(
        np.load(paths.edge_features(dataset, cnn_model, output_layer))
    )


def load_texture_features(paths: Paths, dataset: str, cnn_model: str) -> np.ndarray:
    """[num_items, dim] Gram-matrix texture feature matrix, maxabs-normalized
    (OLD_visual_loader_mixin.py:35-42, the loader CompVBPR depends on)."""
    return maxabs_normalize(np.load(paths.texture_features(dataset, cnn_model)))


def feature_dim_probe(path_dir: str, item: int = 0) -> Tuple[int, ...]:
    """Per-item feature shape probe (mixin:33-49)."""
    return np.load(os.path.join(path_dir, f"{item}.npy")).shape


def synthetic_features(
    num_items: int, dim: int, seed: int = 0, normalize: bool = True
) -> np.ndarray:
    """Random non-negative feature matrix for tests and benchmarks (stands in
    for post-ReLU CNN features); the same draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(num_items, dim)).astype(np.float32)
    f = np.abs(f)
    return maxabs_normalize(f) if normalize else f
