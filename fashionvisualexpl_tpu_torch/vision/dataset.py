"""Image-folder dataset (port of ``fashionvisualexpl_tpu/vision/dataset.py``;
reference src/vision/Dataset.py:8-43): files sorted by integer filename,
RGB-converted, optionally resized (PIL bicubic), batched for the extractor.
Host code; PIL is imported where an image is read."""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


class ImageFolderDataset:
    def __init__(self, directory: str, resize: Optional[Tuple[int, int]] = None):
        self.directory = directory
        # only integer-stem image files: stray entries (.DS_Store, partial
        # downloads) would crash the int sort and the whole extraction run
        names = [
            f for f in os.listdir(directory)
            if f.split(".")[0].lstrip("-").isdigit()
        ]
        self.filenames = sorted(names, key=lambda x: int(x.split(".")[0]))
        self.resize = resize

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, idx: int):
        from PIL import Image

        path = os.path.join(self.directory, self.filenames[idx])
        sample = Image.open(path)
        if sample.mode != "RGB":
            sample = sample.convert(mode="RGB")
        if self.resize is not None:
            sample = sample.resize(self.resize, resample=Image.BICUBIC)
        return np.array(sample), self.filenames[idx]

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, list]]:
        """Fixed-shape image batches (requires resize set); the reference
        feeds images one by one (classify_extract.py:79)."""
        if self.resize is None:
            raise ValueError("batching requires a fixed resize")
        for start in range(0, len(self), batch_size):
            names = self.filenames[start : start + batch_size]
            imgs = np.stack([self[start + j][0] for j in range(len(names))])
            yield imgs, names
