"""Host-side artifact stacking (port of ``fashionvisualexpl_tpu/data/pipeline.py``).

The reference streams per-item artifacts through tf.py_function inside
tf.data (src/dataset/dataset.py:124-157, :160-208).  Here modality inputs
are dense arrays loaded once: the edge tiffs become one [I, H, W, 1] stack,
the per-item spatial CNN maps one [I, S, C] stack.  For catalogs whose edge
stack outgrows host RAM or the card, ``build_edge_stack_npy`` writes it as
one ``.npy`` file, an image at a time, for a read-only memmap, and
``HostPrefetcher`` keeps per-batch host gathers in flight beside the
device's work (the streamed trainer, ``train/streamed.py``).  The gathers
land in a ``StagingRing``'s pinned host buffers (``take_rows``: the native
threaded gather where it takes the source), from which the copies to the
card run asynchronously; a buffer is refilled only after its copy ended.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.data.native import gather_rows_native


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


def build_edge_stack_npy(
    edges_dir: str, out_path: str, num_items: int, hw: Tuple[int, int] = (224, 224)
) -> None:
    """Write the per-item edge tiffs as one float32 [I, H, W, 1] ``.npy``
    stack (the values of ``load_edge_image_stack``) through an
    ``open_memmap``, one image in host RAM at a time; read it back with
    ``np.load(out_path, mmap_mode="r")``."""
    from numpy.lib.format import open_memmap
    from PIL import Image

    out = open_memmap(out_path, mode="w+", dtype=np.float32,
                      shape=(num_items, hw[0], hw[1], 1))
    for i in range(num_items):
        path = os.path.join(edges_dir, f"{i}.tiff")
        im = Image.open(path).convert("L").resize((hw[1], hw[0]))
        out[i, :, :, 0] = np.asarray(im, dtype=np.float32) / 255.0
    out.flush()
    del out


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


class HostPrefetcher:
    """Background-thread prefetch of per-batch host gathers.

    ``gather_fn(ids)`` makes one batch from each element of ``id_iter``; a
    worker thread keeps up to ``depth`` gathered batches queued, so the
    host's gather overlaps the device's work.  Iterating yields ``(ids,
    gather_fn(ids))`` in order.  A worker error is re-raised on the
    consumer's side (as ``RuntimeError`` from it); once exhausted, the
    iterator stays exhausted."""

    def __init__(self, id_iter: Iterator, gather_fn: Callable, depth: int = 2):
        self._iter = id_iter
        self._gather = gather_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error = None
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for ids in self._iter:
                self._q.put((ids, self._gather(ids)))
        except BaseException as exc:  # re-raised on the consumer's side
            self._error = exc
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            self._q.put(self._done)  # a later __next__ ends too, never blocks
            if self._error is not None:
                raise RuntimeError("HostPrefetcher worker failed") from self._error
            raise StopIteration
        return item


def take_rows(src: np.ndarray, ids: np.ndarray, out: np.ndarray) -> np.ndarray:
    """``out[:] = src[ids]`` as float32: through the native threaded gather
    (``data/native.py::gather_rows_native``) for a C-contiguous float32
    ``src`` (array or memmap) when the library is available, else numpy's
    ``src[ids]``.  Ids outside [0, len(src)) raise ``IndexError`` on
    both routes."""
    if src.dtype == np.float32 and gather_rows_native(src, ids, out=out) is not None:
        return out
    out[...] = src[np.asarray(ids)]
    return out


class StagingRing:
    """``n`` host staging slots for copies to ``device``, handed out in
    turn.  A slot is a dict of float32 tensors of the given ``shapes``,
    pinned when ``device`` is CUDA, with numpy views (``views[i]``) to fill
    them.  ``acquire`` returns the next slot once its previous holder has
    released it and the copy that read it has finished (a CUDA event);
    ``to_device`` copies a slot out (asynchronously from pinned memory,
    always into new tensors), records that event and releases the slot.
    One thread may acquire while another copies out: a slot in use is
    never handed out, and nothing overwrites a batch in flight."""

    def __init__(self, n: int, shapes: Dict[str, Tuple[int, ...]], device):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self.slots = [{k: torch.empty(shape, dtype=torch.float32, pin_memory=pin)
                       for k, shape in shapes.items()} for _ in range(n)]
        self.views = [{k: t.numpy() for k, t in slot.items()} for slot in self.slots]
        self._events = [None] * n
        self._free = [True] * n
        self._next = 0
        self._cond = threading.Condition()

    def acquire(self) -> int:
        with self._cond:
            i = self._next
            self._next = (i + 1) % len(self.slots)
            self._cond.wait_for(lambda: self._free[i])
            self._free[i] = False
            event = self._events[i]
        if event is not None:
            event.synchronize()
        return i

    def to_device(self, i: int) -> Dict[str, torch.Tensor]:
        out = {k: t.to(self.device, non_blocking=True, copy=True)
               for k, t in self.slots[i].items()}
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._events[i] = event
        with self._cond:
            self._free[i] = True
            self._cond.notify_all()
        return out
