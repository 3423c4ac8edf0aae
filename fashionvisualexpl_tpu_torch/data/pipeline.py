"""Host-side artifact stacking (port of ``fashionvisualexpl_tpu/data/pipeline.py``).

The reference streams per-item artifacts through tf.py_function inside
tf.data (src/dataset/dataset.py:124-157, :160-208).  Here modality inputs
are dense arrays loaded once: the edge tiffs become one [I, H, W, 1] stack,
the per-item spatial CNN maps one [I, S, C] stack.

Not ported yet: ``build_edge_stack_npy`` and ``HostPrefetcher`` (the
streamed trainer, ROADMAP: The streamed trainer).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def load_edge_image_stack(
    edges_dir: str, num_items: int, hw: Tuple[int, int] = (224, 224)
) -> np.ndarray:
    """Stack per-item edge tiffs ({edges_dir}/{item}.tiff, L-mode, /255 —
    reference dataset.py:176-204) into [I, H, W, 1] float32."""
    from PIL import Image

    out = np.zeros((num_items, hw[0], hw[1], 1), dtype=np.float32)
    for i in range(num_items):
        path = os.path.join(edges_dir, f"{i}.tiff")
        im = Image.open(path).convert("L").resize((hw[1], hw[0]))
        out[i, :, :, 0] = np.asarray(im, dtype=np.float32) / 255.0
    return out


def load_spatial_feature_stack(split_dir: str, num_items: int) -> np.ndarray:
    """Stack per-item spatial CNN features ({split_dir}/{item}.npy, reference
    ACF.py:140-150) into [I, S, C] float32: each file [H, W, C] (H x W
    flattened to S) or [S, C] once squeezed; any other rank raises."""
    first = np.load(os.path.join(split_dir, "0.npy"))
    sq = np.squeeze(first)
    if sq.ndim == 3:  # [H, W, C] -> [H*W, C]
        S, C = sq.shape[0] * sq.shape[1], sq.shape[2]
    elif sq.ndim == 2:
        S, C = sq.shape
    else:
        raise ValueError(f"unexpected spatial feature shape {first.shape}")
    out = np.zeros((num_items, S, C), dtype=np.float32)
    for i in range(num_items):
        arr = np.squeeze(np.load(os.path.join(split_dir, f"{i}.npy")))
        out[i] = arr.reshape(S, C)
    return out
