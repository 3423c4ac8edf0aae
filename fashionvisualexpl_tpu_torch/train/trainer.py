"""Shared training engine (port of ``fashionvisualexpl_tpu/train/trainer.py``).

One trainer for every model.  An epoch samples its BPR triples on the
device (``data/sampler.py``), then runs the optimizer steps: autograd of
``model.loss`` over the model's parameters, then TF-parity Adam
(``core/train_state.py``).  The JAX package runs an epoch as one jitted
``lax.scan``; here it is a Python loop of eager steps whose losses stay on
the device and are summed once per epoch.

``fit`` keeps the JAX package's run structure: the seed splits into an init
draw and an epoch draw, each epoch's sampler seed is derived from (epoch
draw, epoch), best-params tracking takes the later epoch on a tie, and
``log`` gets one JSONL-ready record per epoch.  Seeds are ints (the port's
keys); they feed ``torch.Generator``s on the model's device.

Not ported yet: ``train_path="packed"`` (ROADMAP item 4), the ``mesh``
paths (item 13) and checkpoints (``ckpt_dir`` / ``resume``, item 5); each
raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.core.device import resolve_device
from fashionvisualexpl_tpu_torch.core.train_state import (
    TrainState,
    apply_gradients,
    create_train_state,
    tf_parity_adam,
)
from fashionvisualexpl_tpu_torch.data.interactions import Interactions
from fashionvisualexpl_tpu_torch.data.sampler import (
    derived_pairs_ok,
    sample_triplets,
)


def split_seed(seed: int) -> Tuple[int, int]:
    """Two independent 63-bit seeds from one (``jax.random.split``'s role)."""
    a, b = np.random.SeedSequence(seed).generate_state(2, np.uint64)
    return int(a >> np.uint64(1)), int(b >> np.uint64(1))


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed derived from (seed, data) (``jax.random.fold_in``'s role)."""
    (a,) = np.random.SeedSequence(seed, spawn_key=(data,)).generate_state(1, np.uint64)
    return int(a >> np.uint64(1))


@dataclass
class EpochResult:
    epoch: int
    loss: float
    train_time_s: float
    eval_time_s: float = 0.0
    metrics: Optional[Dict[str, float]] = None


class Trainer:
    """Generic trainer over ``model`` (an ``nn.Module`` with ``loss(users,
    pos, neg, reg)``).  The device is the model's; the sampler tables move
    there once, here."""

    def __init__(self, model, data: Interactions, cfg: TrainConfig, tx=None):
        self.model = model
        self.data = data
        self.cfg = cfg
        self.tx = tx if tx is not None else tf_parity_adam(cfg.lr)
        self.steps_per_epoch = data.steps_per_epoch(cfg.batch_size)
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} > {data.num_train} interactions"
            )
        if cfg.mesh.num_devices > 1:
            raise NotImplementedError(
                "multi-device training is not ported yet (ROADMAP item 13)"
            )
        if cfg.train_path == "packed":
            raise NotImplementedError(
                "train_path='packed' is not ported yet (ROADMAP item 4)"
            )
        if cfg.train_path != "generic":
            raise ValueError(f"unknown train_path {cfg.train_path!r}")
        self.device = resolve_device(model.device)

        # device-resident sampler tables.  When the pair list is exactly the
        # row-major flattening of padded_pos (uniform counts, sorted stored
        # order), it is not shipped: the sampler re-derives the pairs from
        # padded_pos and gives the same triples.
        def to_dev(arr):
            return torch.as_tensor(np.asarray(arr, np.int32), device=self.device)

        if derived_pairs_ok(data.train_pairs, data.padded_pos):
            self._train_pairs = None
        else:
            self._train_pairs = to_dev(data.train_pairs)
        self._padded_pos = to_dev(data.padded_pos)
        self._pos_counts = to_dev(data.pos_counts)
        self._epoch_fn = self._build_epoch_fn()

    def _build_epoch_fn(self) -> Callable:
        cfg = self.cfg
        steps, batch = self.steps_per_epoch, cfg.batch_size
        num_items = self.data.num_items

        def epoch_fn(state: TrainState, frozen, key: int,
                     train_pairs, padded_pos, pos_counts):
            sample_key, _step_key = split_seed(key)  # step keys: dropout models
            triples = sample_triplets(
                sample_key, train_pairs, padded_pos, pos_counts,
                num_items, steps, batch,
                with_replacement=cfg.sampling_scheme, device=self.device,
            )
            return self.run_steps(state, frozen, triples)

        return epoch_fn

    def run_steps(self, state: TrainState, frozen, triples):
        """The optimizer steps over one epoch's triples ([steps, batch]
        each); returns (state, summed loss as a 0-d device tensor)."""
        del frozen  # BPRMF has none
        users, pos, neg = (t.long() for t in triples)
        reg = self.cfg.reg
        names = list(state.params)
        leaves = [state.params[k] for k in names]
        losses = torch.empty(users.shape[0], dtype=torch.float32,
                             device=self.device)
        for s in range(users.shape[0]):
            with torch.enable_grad():
                loss = self.model.loss(users[s], pos[s], neg[s], reg)
                grads = torch.autograd.grad(loss, leaves)
            state = apply_gradients(state, dict(zip(names, grads)), self.tx)
            losses[s] = loss.detach()
        return state, torch.sum(losses)

    def init_state(self, seed: Optional[int] = None):
        """(TrainState, frozen).  With a ``seed`` the model's parameters are
        drawn anew from it (JAX's ``model.init(rng)``); without one they are
        kept as they are (e.g. carried over by ``models/convert.py``)."""
        if seed is not None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model.reset_parameters(gen)
        params = dict(self.model.named_parameters())
        frozen = dict(self.model.named_buffers())
        return create_train_state(params, self.tx), frozen

    def run_epoch(self, state: TrainState, frozen, key: int):
        """Run one full epoch (sampling + all optimizer steps) on device."""
        return self._epoch_fn(
            state, frozen, key,
            self._train_pairs, self._padded_pos, self._pos_counts,
        )


def fit(
    model,
    data: Interactions,
    cfg: TrainConfig,
    evaluator=None,
    seed: Optional[int] = None,
    log: Optional[Callable[[Dict[str, Any]], None]] = None,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
) -> Tuple[TrainState, Any, Dict[int, Dict[str, float]], Dict[str, Any]]:
    """Full training run with per-epoch eval and best-model tracking.

    Returns (final_state, frozen, results dict keyed by epoch with the
    evaluator's metric records, extra) where extra holds the epoch
    ``history``, ``best_params`` and ``best_epoch``.  Best-model selection
    follows the reference (BPRMF.py:150-156): argmax of the validation
    ``best_metric``, ties resolved to the LATEST epoch.  ``evaluator`` is
    duck-typed: ``evaluate(params, frozen) -> metrics`` and
    ``print_epoch(epoch, epochs, mean_loss, record)``."""
    if ckpt_dir is not None or resume:
        raise NotImplementedError(
            "checkpoints (ckpt_dir / resume) are not ported yet (ROADMAP item 5)"
        )
    trainer = Trainer(model, data, cfg)
    seed = cfg.seed if seed is None else seed
    init_seed, epoch_seed = split_seed(seed)
    state, frozen = trainer.init_state(init_seed)

    results: Dict[int, Dict[str, float]] = {}
    history: List[EpochResult] = []
    # a copy: the steps update state.params in place
    best_params = {k: v.detach().clone() for k, v in state.params.items()}
    best_epoch = 0
    best_value = -float("inf")
    metric_key = cfg.best_metric + "_v"

    for epoch in range(1, cfg.epochs + 1):
        t0 = time.time()
        state, loss = trainer.run_epoch(state, frozen, fold_in(epoch_seed, epoch))
        loss = float(loss)
        train_time = time.time() - t0

        rec = EpochResult(epoch=epoch, loss=loss, train_time_s=train_time)
        if evaluator is not None and epoch % cfg.eval_every == 0:
            t1 = time.time()
            metrics = evaluator.evaluate(state.params, frozen)
            rec.eval_time_s = time.time() - t1
            rec.metrics = metrics
            results[epoch] = metrics
            evaluator.print_epoch(
                epoch, cfg.epochs, loss / trainer.steps_per_epoch, rec
            )
            if metrics.get(metric_key, -float("inf")) >= best_value:
                best_value = metrics[metric_key]
                best_epoch = epoch
                best_params = {k: v.detach().clone()
                               for k, v in state.params.items()}
        history.append(rec)
        if log is not None:
            log(
                {
                    "epoch": epoch,
                    "loss": loss,
                    "train_time_s": train_time,
                    "eval_time_s": rec.eval_time_s,
                    **(rec.metrics or {}),
                }
            )

    return state, frozen, results, {
        "history": history,
        "best_params": best_params,
        "best_epoch": best_epoch,
    }
