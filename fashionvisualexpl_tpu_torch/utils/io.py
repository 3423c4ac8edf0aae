"""IO utilities (port of ``fashionvisualexpl_tpu/utils/io.py``; reference
src/utils/read.py, src/utils/write.py).  Host-side only: a copy, since the
port imports nothing of the JAX package.

The reference parses its imagenet class list with `eval(f.read())`
(read.py:35); here it is parsed with `ast.literal_eval` — same file format,
no arbitrary code execution.
"""

from __future__ import annotations

import ast
import json
import os
import pickle
from typing import Any, Dict, List

import numpy as np


def read_np(filename: str) -> np.ndarray:
    return np.load(filename)


def save_np(npy: np.ndarray, filename: str) -> None:
    np.save(filename, npy)


def save_obj(obj: Any, name: str) -> None:
    """Pickle `obj` to `name + '.pkl'` (reference write.py:14-22)."""
    with open(name + ".pkl", "wb") as f:
        pickle.dump(obj, f)


def load_obj(name: str) -> Any:
    with open(name, "rb") as f:
        return pickle.load(f)


def read_imagenet_classes_txt(filename: str) -> Dict[int, str]:
    """Parse the {idx: label} imagenet class file (reference read.py:28-37)."""
    with open(filename) as f:
        return ast.literal_eval(f.read())


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


class JsonlLogger:
    """Structured per-epoch/step metric records.

    The reference logs by `print` to stdout and later scrapes the text
    (src/logs_to_excel.py:26-63); here metrics are also emitted as JSONL so
    downstream tools need no format-sensitive scraping.
    """

    def __init__(self, path: str):
        ensure_dir(os.path.dirname(path) or ".")
        self.path = path
        self._f = open(path, "a")

    def log(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
