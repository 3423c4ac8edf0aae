"""Offline feature-extraction CLI (port of
``fashionvisualexpl_tpu/cli/extract_features.py``).

Writes the artifact set the training stack reads (the union of reference
src/classify_extract.py, src/extract_features.py and its OLD script): the
classes CSV, the CNN feature matrix and its per-item split, the per-item
colors, the edge tiffs, the color histograms (matrix and per item) and the
class one-hots (matrix and per item):

  python -m fashionvisualexpl_tpu_torch.cli.extract_features --dataset amazon_baby \\
      --cnn_model ResNet50 --output_layer avg_pool --batch 64 [--device cpu]

The same flags as the JAX CLI, plus ``--device`` (default the CUDA card,
which the CNN pass needs unless ``--device cpu`` is given).  Each batch is
decoded and resized on the host, preprocessed on the host, then run through
the backbone twice on the device: ``extract_feature``, then ``classify``.
Edge / color extraction is host OpenCV + sklearn (``--skip_low`` skips it;
the CNN pass needs neither).  No pandas: the classes CSV is written and
read back as pandas does (``utils/frames.py``: a numeric class name reads
back as a number), and the one-hots follow sklearn's ``LabelBinarizer``
(``label_binarize``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run offline feature extraction.")
    p.add_argument("--dataset", nargs="?", default="amazon_baby")
    p.add_argument("--cnn_model", nargs="?", default="ResNet50")
    p.add_argument("--output_layer", nargs="?", default="avg_pool")
    p.add_argument("--num_colors", type=int, default=3)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--resize", type=int, default=224)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--skip_cnn", action="store_true")
    p.add_argument("--skip_low", action="store_true")
    p.add_argument("--torch_weights", type=str, default=None,
                   help="pretrained torchvision state dict (.npz or "
                        ".pt/.pth) for --cnn_model; omitting it runs "
                        "random-init (shape/speed only, not semantic "
                        "features)")
    p.add_argument("--device", type=str, default=None,
                   help="where the CNN pass computes: default the CUDA card "
                        "(raises without one); 'cpu' runs on the host")
    return p.parse_args(argv)


def label_binarize(y: np.ndarray) -> np.ndarray:
    """``LabelBinarizer().fit_transform(y)`` then the JAX CLI's fix-up
    (extract_features.py:127-133), in numpy: classes in sorted order, one
    int64 column per class; with two classes sklearn's single 0/1 column
    (the second class) and with one class its single zero column, each
    then mapped through ``eye(2)``."""
    classes, idx = np.unique(y, return_inverse=True)
    idx = idx.reshape(-1)
    if len(classes) >= 3:
        return np.eye(len(classes), dtype=np.int64)[idx]
    col = idx if len(classes) == 2 else np.zeros_like(idx)
    return np.eye(2, dtype=np.int64)[col]


def extract(argv=None):
    """Run the extraction; returns the host and device seconds by phase
    (``StepTimer.summary()``), also printed."""
    args = parse_args(argv)

    from fashionvisualexpl_tpu_torch.core.config import Paths
    from fashionvisualexpl_tpu_torch.utils import frames
    from fashionvisualexpl_tpu_torch.utils.io import ensure_dir
    from fashionvisualexpl_tpu_torch.utils.profiling import StepTimer
    from fashionvisualexpl_tpu_torch.vision.dataset import ImageFolderDataset
    from fashionvisualexpl_tpu_torch.vision.extractors import (
        CnnFeatureExtractor,
        LowFeatureExtractor,
        color_histogram,
        preprocess,
    )

    paths = Paths(root=args.data_root)
    ds = args.dataset
    data = ImageFolderDataset(
        paths.images(ds), resize=(args.resize, args.resize)
    )
    n = len(data)
    print(f"Extracting features for {n} images")
    start = time.time()
    timer = StepTimer()

    if not args.skip_cnn:
        cnn = CnnFeatureExtractor(
            output_layer=args.output_layer, model_name=args.cnn_model,
            torch_weights=args.torch_weights, device=args.device,
        )
        feats: List[np.ndarray] = []
        records = []
        split_dir = ensure_dir(
            paths.cnn_features_split_dir(ds, args.cnn_model, args.output_layer)
        )
        timer.lap("setup")
        for imgs, names in data.batches(args.batch):
            timer.lap("decode")  # read, RGB, bicubic resize
            x = preprocess(imgs)
            timer.lap("preprocess")
            f = cnn.extract_feature(x)
            timer.lap("extract_feature")
            feats.append(f.reshape(f.shape[0], -1))
            for row, name in zip(f, names):
                np.save(
                    os.path.join(split_dir, f"{os.path.splitext(name)[0]}.npy"),
                    row,
                )
            timer.lap("write")
            records.extend(cnn.classify(x, names))
            timer.lap("classify")
        ensure_dir(paths.original(ds))
        np.save(
            paths.cnn_features(ds, args.cnn_model, args.output_layer),
            np.concatenate(feats, axis=0),
        )
        frames.write_csv(frames.from_rows(records), paths.classes_csv(ds, args.cnn_model))
        timer.lap("write")
        print(f"CNN features done in {time.time() - start:.1f}s")

    if not args.skip_low:
        import cv2
        from PIL import Image

        low = LowFeatureExtractor(args.num_colors)
        colors_dir = ensure_dir(paths.colors_dir(ds))
        edges_dir = ensure_dir(paths.edges_dir(ds))
        hist_dir = ensure_dir(paths.hist_color_features_dir(ds))
        ensure_dir(paths.features_dir(ds))
        hists = np.zeros((n, 512), dtype=np.int32)
        for i in range(n):
            rgb, name = data[i]
            bgr = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
            item = os.path.splitext(name)[0]
            edge_map, colors = low.extract_color_edges((bgr, name))
            Image.fromarray(edge_map.astype(np.uint8), mode="L").save(
                os.path.join(edges_dir, f"{item}.tiff")
            )
            np.save(os.path.join(colors_dir, f"{item}.npy"), colors)
            h = color_histogram(bgr)
            hists[i] = h
            np.save(os.path.join(hist_dir, f"{item}.npy"), h)
        np.save(paths.hist_color_features(ds), hists)
        timer.lap("low")
        print(f"Low-level features done in {time.time() - start:.1f}s")

    # class one-hots from the classification CSV (extract_features.py:42-49)
    classes_csv = paths.classes_csv(ds, args.cnn_model)
    if os.path.exists(classes_csv):
        onehot = label_binarize(frames.read_csv(classes_csv)["ClassStr"])
        np.save(paths.class_features(ds), onehot)
        oh_dir = ensure_dir(paths.class_features_dir(ds))
        for i, name in enumerate(data.filenames):
            np.save(
                os.path.join(oh_dir, f"{os.path.splitext(name)[0]}.npy"),
                onehot[i],
            )
        timer.lap("onehot")
        print(f"There are {onehot.shape[1]} different classes")

    summary = timer.summary()
    print(f"Total extraction time: {time.time() - start:.1f}s")
    print("time by phase (s): " + ", ".join(
        f"{k} {v['total_s']:.3f}" for k, v in summary.items()))
    return summary


if __name__ == "__main__":
    extract()
