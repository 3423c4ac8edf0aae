"""Streamed-feature trainer (port of ``fashionvisualexpl_tpu/train/streamed.py``)
for catalogs whose modality inputs outgrow the card.

The resident trainer (``train/trainer.py``) holds every modality tensor on
the device.  At catalog scale the edge stack does not fit (an item's
224x224 float32 edge map is ~200 KB), so this trainer keeps the inputs on
the host (arrays or read-only ``np.memmap`` files), samples the triples on
the device, and streams each batch's rows to the card:

- a ``HostPrefetcher`` thread gathers ``prefetch_depth`` batches ahead,
  through the native threaded row gather (``data/native.py``) where it
  takes the source, into the pinned buffers of a ``StagingRing``;
- the step copies its batch from pinned memory with ``non_blocking=True``
  and releases the buffer; the ring refills it only after that copy has
  finished (a CUDA event), so no batch in flight is overwritten;
- the step is autograd of ``model.loss_streamed`` and TF-parity Adam, as
  ``Trainer.run_steps`` runs ``model.loss``; the losses stay on the device
  and are summed once per epoch.

Seeds follow the JAX package's structure in the port's terms: the init
from ``cfg.seed``; epoch e's sampler seed ``fold_in(cfg.seed + 1, e)``;
step s's dropout generator ``fold_in(epoch seed, 1000 + s)``.
``fit_streamed`` has ``fit``'s surface (evaluation cadence, ties to the
later epoch, JSONL records, checkpoints and resume).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.core.train_state import TrainState, apply_gradients
from fashionvisualexpl_tpu_torch.data.interactions import Interactions
from fashionvisualexpl_tpu_torch.data.pipeline import HostPrefetcher, StagingRing, take_rows
from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
from fashionvisualexpl_tpu_torch.models.base import Dropout
from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fold_in, run_fit

# step s of an epoch draws its dropout from fold_in(epoch seed, STEP_SEED_BASE + s)
STEP_SEED_BASE = 1000


class ArrayFeatureStore:
    """Per-item modality inputs on the host: ``color`` [I, dim_c], ``edges``
    [I, H, W, 1], ``cls`` [I, num_classes], arrays or read-only memmaps.

    ``gather(pos, neg, out=None)`` returns the ``feats`` dict that
    ``loss_streamed`` reads (``col_pos``, ``img_pos``, ``cls_pos``,
    ``col_neg``, ``img_neg``, ``cls_neg``).  Each modality's positive and
    negative rows are gathered by one call into one buffer [2B, ...] (the
    positives first), in ``out`` (``{"col", "img", "cls"}``, e.g. the numpy
    views of a ``StagingRing`` slot, of the ``shapes(B)``) or in new
    arrays, and the dict holds views of its halves (``split``): three
    gathers a batch, since each native call has a fixed cost of thread
    starts.  Rows go through the native threaded gather for C-contiguous
    float32 sources when the library is available, else through
    ``src[ids]`` (``data/pipeline.py::take_rows``)."""

    def __init__(self, color: np.ndarray, edges: np.ndarray, cls: np.ndarray):
        self.color, self.edges, self.cls = color, edges, cls

    @classmethod
    def from_memmap(cls, color_path: str, edges_path: str, cls_path: str):
        return cls(np.load(color_path, mmap_mode="r"), np.load(edges_path, mmap_mode="r"),
                   np.load(cls_path, mmap_mode="r"))

    def _sources(self):
        return (("col", self.color), ("img", self.edges), ("cls", self.cls))

    def shapes(self, batch: int) -> Dict[str, tuple]:
        """The shape of each modality's buffer for ``batch`` triples."""
        return {key: (2 * batch,) + src.shape[1:] for key, src in self._sources()}

    @staticmethod
    def split(bufs):
        """The ``feats`` dict of views of ``bufs``' halves (numpy arrays or
        tensors, e.g. a slot copied to the device)."""
        return {f"{key}_{side}": half for key, buf in bufs.items()
                for side, half in zip(("pos", "neg"), (buf[:len(buf) // 2], buf[len(buf) // 2:]))}

    def gather(self, pos: np.ndarray, neg: np.ndarray,
               out: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
        if len(pos) != len(neg):
            raise ValueError(f"{len(pos)} positives, {len(neg)} negatives")
        if out is None:
            out = {k: np.empty(shape, np.float32) for k, shape in self.shapes(len(pos)).items()}
        ids = np.concatenate([np.asarray(pos, np.int32), np.asarray(neg, np.int32)])
        for key, src in self._sources():
            take_rows(src, ids, out[key])
        return self.split(out)


def _step_rngs(step_key, steps: int, device):
    """One dropout source per step: for an int ``step_key`` a generator on
    ``device`` seeded with ``fold_in(step_key, s)`` (as
    ``Trainer.run_steps``), else the entries of ``step_key`` as given."""
    if isinstance(step_key, int):
        return (torch.Generator(device=device).manual_seed(fold_in(step_key, s))
                for s in range(steps))
    return step_key


class StreamedTrainer(Trainer):
    """``Trainer`` whose steps read their modality inputs from ``store``
    (an ``ArrayFeatureStore``) through a host prefetcher of
    ``prefetch_depth`` batches; the model must implement
    ``loss_streamed`` (AttentiveFashion does).  ``run_epoch`` samples the
    epoch's triples from ``key`` and gives step s the dropout generator
    ``fold_in(key, 1000 + s)``."""

    def __init__(self, model, data: Interactions, cfg: TrainConfig, store,
                 prefetch_depth: int = 2, tx=None):
        if cfg.train_path != "generic":
            raise ValueError("the streamed trainer has its own step; train_path must be "
                             f"'generic', got {cfg.train_path!r}")
        super().__init__(model, data, cfg, tx)
        self.store = store
        self.prefetch_depth = prefetch_depth
        self._ring: Optional[StagingRing] = None

    def _staging(self, store, batch: int) -> StagingRing:
        """The pinned staging ring for ``store``'s rows at ``batch``: the
        prefetcher's ``depth`` queued batches, the one it gathers and the
        one being copied to the device."""
        shapes = store.shapes(batch)
        ring = self._ring
        if ring is None or {k: tuple(t.shape) for k, t in ring.slots[0].items()} != shapes:
            ring = self._ring = StagingRing(self.prefetch_depth + 2, shapes, self.device)
        return ring

    def run_streamed_steps(self, state: TrainState, triples, store,
                           step_key: Union[int, Iterable[Dropout]]):
        """The optimizer steps over ``triples`` ([steps, batch] each) with
        the rows of ``store``; returns (state, summed loss as a 0-d device
        tensor).  ``step_key``: an int (step s draws dropout from
        ``fold_in(step_key, s)``, as ``Trainer.run_steps``) or one dropout
        source per step (a generator, or the keep-masks ``loss_streamed``
        consumes)."""
        users, pos, neg = (t.to(self.device).long() for t in triples)
        pos_h, neg_h = pos.cpu().numpy(), neg.cpu().numpy()
        steps = users.shape[0]
        ring = self._staging(store, users.shape[1])

        def gather(s):
            i = ring.acquire()
            store.gather(pos_h[s], neg_h[s], out=ring.views[i])
            return i

        reg = self.cfg.reg
        names = list(state.params)
        leaves = [state.params[k] for k in names]
        losses = torch.empty(steps, dtype=torch.float32, device=self.device)
        batches = HostPrefetcher(iter(range(steps)), gather, depth=self.prefetch_depth)
        for (s, i), rng in zip(batches, _step_rngs(step_key, steps, self.device)):
            feats = store.split(ring.to_device(i))
            with torch.enable_grad():
                loss = self.model.loss_streamed(users[s], pos[s], neg[s], feats, reg,
                                                rng=rng)
                grads = torch.autograd.grad(loss, leaves)
            state = apply_gradients(state, dict(zip(names, grads)), self.tx)
            losses[s] = loss.detach()
        return state, torch.sum(losses)

    def run_epoch(self, state: TrainState, frozen, key: int):
        del frozen  # the inputs come from the store
        triples = sample_triplets(
            key, self._train_pairs, self._padded_pos, self._pos_counts,
            self.data.num_items, self.steps_per_epoch, self.cfg.batch_size,
            with_replacement=self.cfg.sampling_scheme, device=self.device)
        rngs = (torch.Generator(device=self.device).manual_seed(
            fold_in(key, STEP_SEED_BASE + s)) for s in range(self.steps_per_epoch))
        return self.run_streamed_steps(state, triples, self.store, rngs)


def fit_streamed(
    model,
    data: Interactions,
    cfg: TrainConfig,
    store,
    evaluator=None,
    prefetch_depth: int = 2,
    log: Optional[Callable[[Dict], None]] = None,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
):
    """``fit`` with host-streamed modality inputs: the parameters drawn
    from ``cfg.seed``, epoch e's triples from ``fold_in(cfg.seed + 1, e)``;
    returns (state, frozen, results, extra) as ``fit`` does (``frozen`` is
    empty for a ``host_features`` model).  The evaluator encodes the items
    through the model's own path (host blocks for ``host_features``)."""
    trainer = StreamedTrainer(model, data, cfg, store, prefetch_depth=prefetch_depth)
    return run_fit(trainer, cfg.seed, cfg.seed + 1, evaluator=evaluator, log=log,
                   ckpt_dir=ckpt_dir, resume=resume)
