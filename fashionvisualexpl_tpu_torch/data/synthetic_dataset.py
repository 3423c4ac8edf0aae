"""Materialize a synthetic dataset in the reference's on-disk layout (port
of ``fashionvisualexpl_tpu/data/synthetic_dataset.py``: the same draws from
the same seed, so the tree on disk is byte-equal to the JAX package's).

Produces everything DataLoader + VisualLoader expect (reference
src/config/configs.py paths): split TSVs, the stats info file, the frozen CNN
feature matrix, color histograms (+ per-item dir), class one-hots (+ per-item
dir), edge tiffs, and per-item spatial CNN features — so end-to-end CLI runs
and tests exercise the real loading paths.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from fashionvisualexpl_tpu_torch.core.config import Paths
from fashionvisualexpl_tpu_torch.data.interactions import Interactions, synthetic_interactions


def write_reference_layout(
    paths: Paths,
    dataset: str,
    data: Interactions,
    cnn_dim: int = 64,
    cnn_model: str = "vgg19",
    output_layer: str = "fc2",
    num_classes: int = 7,
    edge_hw: Tuple[int, int] = (32, 32),
    spatial: Tuple[int, int] = (4, 8),
    seed: int = 0,
    with_images: bool = True,
) -> None:
    from PIL import Image

    rng = np.random.default_rng(seed)
    I = data.num_items
    ddir = paths.data_dir(dataset)
    os.makedirs(ddir, exist_ok=True)

    # stats file: reference get_length reads lines 2 and 3 (dataset.py:41-50)
    with open(paths.dataset_info(dataset), "w") as f:
        f.write(
            "dataset stats\n"
            "----\n"
            f"users: {data.num_users}\n"
            f"items: {data.num_items}\n"
        )

    def write_split(path, lists):
        with open(path, "w") as f:
            for u, row in enumerate(lists):
                for i in row:
                    f.write(f"{u}\t{i}\t0\t1.0\n")

    write_split(paths.training_set(dataset), data.training_list)
    write_split(paths.test_set(dataset), data.test_list)
    if data.has_validation:
        write_split(paths.validation_set(dataset), data.validation_list)

    # frozen CNN features (visual_loader_mixin.py:22-31)
    os.makedirs(paths.original(dataset), exist_ok=True)
    feats = np.abs(rng.normal(size=(I, cnn_dim))).astype(np.float32)
    np.save(paths.cnn_features(dataset, cnn_model, output_layer), feats)
    # edge feature matrix (GradFashion path, mixin:60-69)
    np.save(
        paths.edge_features(dataset, cnn_model, output_layer),
        np.abs(rng.normal(size=(I, cnn_dim // 2))).astype(np.float32),
    )
    # Gram-matrix texture features (CompVBPR path, OLD mixin:35-42)
    np.save(
        paths.texture_features(dataset, cnn_model),
        np.abs(rng.normal(size=(I, cnn_dim // 4))).astype(np.float32),
    )

    fdir = paths.features_dir(dataset)
    os.makedirs(fdir, exist_ok=True)
    hists = rng.integers(0, 100, size=(I, 512)).astype(np.int32)
    np.save(paths.hist_color_features(dataset), hists)
    classes = np.eye(num_classes, dtype=np.float32)[
        rng.integers(0, num_classes, I)
    ]
    np.save(paths.class_features(dataset), classes)

    # per-item artifact dirs (dataset.py:160-208 readers)
    hdir = paths.hist_color_features_dir(dataset)
    cdir = paths.class_features_dir(dataset)
    os.makedirs(hdir, exist_ok=True)
    os.makedirs(cdir, exist_ok=True)
    for i in range(I):
        np.save(os.path.join(hdir, f"{i}.npy"), hists[i])
        np.save(os.path.join(cdir, f"{i}.npy"), classes[i])

    if with_images:
        edir = paths.edges_dir(dataset)
        os.makedirs(edir, exist_ok=True)
        for i in range(I):
            img = (rng.random(edge_hw) * 255).astype(np.uint8)
            Image.fromarray(img, mode="L").save(os.path.join(edir, f"{i}.tiff"))

        sdir = paths.cnn_features_split_dir(dataset, cnn_model, output_layer)
        os.makedirs(sdir, exist_ok=True)
        S, C = spatial
        for i in range(I):
            np.save(
                os.path.join(sdir, f"{i}.npy"),
                rng.normal(size=(S, C)).astype(np.float32),
            )


def make_synthetic_dataset_on_disk(
    root: str,
    dataset: str = "synthetic",
    num_users: int = 30,
    num_items: int = 40,
    interactions_per_user: int = 8,
    seed: int = 0,
    **kw,
) -> Tuple[Paths, Interactions]:
    paths = Paths(root=root, results_root=os.path.join(root, "results"))
    data = synthetic_interactions(
        num_users, num_items, interactions_per_user=interactions_per_user,
        seed=seed,
    )
    write_reference_layout(paths, dataset, data, seed=seed, **kw)
    return paths, data
