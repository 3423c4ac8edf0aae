"""Shared training engine (port of ``fashionvisualexpl_tpu/train/trainer.py``).

One trainer for every model.  An epoch samples its BPR triples on the
device (``data/sampler.py``), then runs the optimizer steps: autograd of
``model.loss`` over the model's parameters (dotted names for nested groups,
e.g. ``"color_enc.W1"``), then TF-parity Adam (``core/train_state.py``).
The JAX package runs an epoch as one jitted ``lax.scan``; here it is a
Python loop of eager steps whose losses stay on the device and are summed
once per epoch.  Step s of an epoch draws its dropout from a generator
seeded with ``fold_in(step_key, s)``, the role of JAX's ``split(step_key,
steps)``; models without stochastic layers ignore it.

``train_path="packed"`` runs the packed LazyAdam engine
(``train/packed_generic.py``) instead: the same epoch sampling and per-step
dropout generators, the state a ``GenericPackedTrainState`` whose
``.params`` materialises the standard mapping for ``fit``.

``fit`` keeps the JAX package's run structure: the seed splits into an init
draw and an epoch draw, each epoch's sampler seed is derived from (epoch
draw, epoch), best-params tracking takes the later epoch on a tie, and
``log`` gets one JSONL-ready record per epoch.  Seeds are ints (the port's
keys); they feed ``torch.Generator``s on the model's device.

With ``ckpt_dir``, ``fit`` checkpoints the train state every ``cfg.verbose``
epochs and at epoch 1 and the best params at the end
(``core/checkpoint.py``); ``resume=True`` restores the latest checkpoint
and continues from the next epoch.

With ``cfg.mesh`` larger than one device the trainer is one rank of a
(data, model) mesh (``core/mesh.py``; every rank of the
``torch.distributed`` group builds it alike): ``init_state`` draws the
whole init, then keeps this rank's row shards (the model's own parameters
and buffers hold them, ``parallel/spmd.py::load_tensors``); the generic
path steps through ``parallel/spmd.py``, the packed one through
``parallel/fast_spmd.py`` (frozen tables read by id, float8 moments
refused).  ``fit`` over a mesh gathers the rows whole for evaluation (the
primary evaluates, every rank gets its metrics, so all pick the same best
epoch), writes checkpoints, logs and the best params from the primary in
the single-device layout (a mesh-trained run restores on one device;
``resume`` shards what it restores), and ends with the model and the
returned state whole, in the single-device layout, on every rank.
"""

from __future__ import annotations

import contextlib
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
    pos, neg, reg, rng=None)``).  The device is the model's; the sampler
    tables move there once, here."""

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
        if cfg.train_path not in ("generic", "packed"):
            raise ValueError(f"unknown train_path {cfg.train_path!r}")
        self.device = resolve_device(model.device)
        # multi-device: tables row-sharded over `model`, batch over `data`
        self.mesh = None
        if cfg.mesh.num_devices > 1:
            from fashionvisualexpl_tpu_torch.core.mesh import make_mesh

            self.mesh = make_mesh(data=cfg.mesh.data, model=cfg.mesh.model,
                                  device=self.device)
            if cfg.batch_size % cfg.mesh.data:
                raise ValueError(f"batch {cfg.batch_size} not divisible by data axis "
                                 f"{cfg.mesh.data}")
        self._rows: Dict[str, int] = {}  # whole row counts of the sharded tables
        self._packed_step = None  # the packed engine's step when it is on
        if cfg.train_path == "packed":
            self._packed_step = self._build_packed_step()

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
        self._spmd_step = None
        if self.mesh is not None and self._packed_step is None:
            from fashionvisualexpl_tpu_torch.parallel.spmd import make_spmd_train_step

            self._spmd_step = make_spmd_train_step(model, self.mesh, self.tx, cfg.reg)
        self._epoch_fn = self._build_epoch_fn()

    def _build_epoch_fn(self) -> Callable:
        cfg = self.cfg
        steps, batch = self.steps_per_epoch, cfg.batch_size
        num_items = self.data.num_items

        def epoch_fn(state: TrainState, frozen, key: int,
                     train_pairs, padded_pos, pos_counts):
            sample_key, step_key = split_seed(key)
            triples = sample_triplets(
                sample_key, train_pairs, padded_pos, pos_counts,
                num_items, steps, batch,
                with_replacement=cfg.sampling_scheme, device=self.device,
            )
            return self.run_steps(state, frozen, triples, step_key)

        return epoch_fn

    def _build_packed_step(self) -> Callable:
        """The packed engine's step for this model and config."""
        from fashionvisualexpl_tpu_torch.train.packed_generic import (
            make_generic_packed_step,
        )

        model, cfg = self.model, self.cfg
        try:
            model.packed_spec()
        except NotImplementedError as e:
            raise NotImplementedError(
                f"train_path='packed' requires packed_spec/packed_loss; "
                f"{model.name} does not implement them"
            ) from e
        if self.mesh is not None:
            from fashionvisualexpl_tpu_torch.parallel.fast_spmd import (
                make_generic_packed_spmd_step,
            )

            return make_generic_packed_spmd_step(
                model, self.mesh, cfg.lr, cfg.reg, moment_dtype=cfg.moment_dtype,
                lazy_catchup=cfg.lazy_catchup)
        return make_generic_packed_step(
            model, cfg.lr, cfg.reg, fused_frozen=cfg.fused_frozen,
            moment_dtype=cfg.moment_dtype, lazy_catchup=cfg.lazy_catchup,
        )

    def run_steps(self, state: TrainState, frozen, triples, step_key: int):
        """The optimizer steps over one epoch's triples ([steps, batch]
        each); returns (state, summed loss as a 0-d device tensor).  Step
        s passes ``model.loss`` (or ``packed_loss``) a generator on the
        device seeded with ``fold_in(step_key, s)``."""
        if self._packed_step is not None:
            from fashionvisualexpl_tpu_torch.train.packed_generic import run_packed_steps

            inner, loss = run_packed_steps(self._packed_step, state.inner, frozen,
                                           triples, step_key)
            return state.with_inner(inner), loss
        if self._spmd_step is not None:  # no dropout key, as in the JAX package
            from fashionvisualexpl_tpu_torch.parallel.spmd import run_spmd_steps

            return run_spmd_steps(self._spmd_step, state, frozen, triples)
        del frozen  # the model reads its own buffers
        users, pos, neg = (t.long() for t in triples)
        reg = self.cfg.reg
        names = list(state.params)
        leaves = [state.params[k] for k in names]
        losses = torch.empty(users.shape[0], dtype=torch.float32,
                             device=self.device)
        for s in range(users.shape[0]):
            rng = torch.Generator(device=self.device).manual_seed(fold_in(step_key, s))
            with torch.enable_grad():
                loss = self.model.loss(users[s], pos[s], neg[s], reg, rng=rng)
                grads = torch.autograd.grad(loss, leaves)
            state = apply_gradients(state, dict(zip(names, grads)), self.tx)
            losses[s] = loss.detach()
        return state, torch.sum(losses)

    def init_state(self, seed: Optional[int] = None):
        """(TrainState, frozen).  With a ``seed`` the model's parameters are
        drawn anew from it (JAX's ``model.init(rng)``); without one they are
        kept as they are (e.g. carried over by ``models/convert.py``).  On
        the packed path the state is a ``GenericPackedTrainState`` packed
        from copies of them (``cfg.moment_dtype``, ``cfg.row_align``; the
        model's frozen buffers in the item rows when ``cfg.fused_frozen``)."""
        if seed is not None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model.reset_parameters(gen)
        params = dict(self.model.named_parameters())
        frozen = dict(self.model.named_buffers())
        if self.mesh is not None:
            return self._init_sharded(params, frozen)
        if self._packed_step is not None:
            from fashionvisualexpl_tpu_torch.train.packed_generic import (
                GenericPackedTrainState,
                pack_generic_state,
            )

            # the frozen columns ride the item rows iff the step reads them
            packed = pack_generic_state(self.model, params,
                                        frozen=frozen if self.cfg.fused_frozen else None,
                                        moment_dtype=self.cfg.moment_dtype,
                                        row_align=self.cfg.row_align)
            return GenericPackedTrainState(packed, self.model.packed_spec(),
                                           self.cfg.moment_dtype), frozen
        return create_train_state(params, self.tx), frozen

    # --- the mesh paths: this rank's shards and the whole tables ---

    def _sharded(self, name: str) -> bool:
        return name in self._rows

    def _init_sharded(self, params, frozen):
        """Pack (the packed path) from the whole tables, then keep this
        rank's shards: the model's params and buffers hold them."""
        from fashionvisualexpl_tpu_torch.parallel.spmd import load_tensors, shard_params

        packed = None
        if self._packed_step is not None:
            from fashionvisualexpl_tpu_torch.parallel.fast_spmd import (
                shard_generic_packed_state,
            )
            from fashionvisualexpl_tpu_torch.train.packed_generic import (
                GenericPackedTrainState,
                pack_generic_state,
            )

            whole = pack_generic_state(self.model, params, moment_dtype=self.cfg.moment_dtype,
                                       row_align=self.cfg.row_align)
            packed = GenericPackedTrainState(shard_generic_packed_state(whole, self.mesh),
                                             self.model.packed_spec(), self.cfg.moment_dtype)
        sharded = set(self.model.row_sharded_params())
        self._rows = {k: int(v.shape[0]) for k, v in {**params, **frozen}.items()
                      if k in sharded}
        sp, sf = shard_params(self.model, params, frozen, self.mesh)
        load_tensors(self.model, {**sp, **sf})
        frozen = dict(self.model.named_buffers())
        if packed is not None:
            return packed, frozen
        return create_train_state(dict(self.model.named_parameters()), self.tx), frozen

    def _whole(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole tables from this rank's shards (a collective over
        ``model``); replicated entries copied."""
        from fashionvisualexpl_tpu_torch.parallel.spmd import unshard_rows

        return {k: unshard_rows(v.detach(), self.mesh, self._rows[k]) if self._sharded(k)
                else v.detach().clone() for k, v in tensors.items()}

    def gather_state(self, state):
        """The whole state in the single-device layout (a collective)."""
        if self._packed_step is not None:
            from fashionvisualexpl_tpu_torch.parallel.fast_spmd import (
                unshard_generic_packed_state,
            )

            return state.with_inner(unshard_generic_packed_state(
                state.inner, self.mesh, self.data.num_users, self.data.num_items))
        opt = state.opt_state
        return TrainState(state.step.clone(), self._whole(state.params),
                          type(opt)(opt.count.clone(), self._whole(opt.mu),
                                    self._whole(opt.nu)))

    def gather_params(self, state) -> Dict[str, torch.Tensor]:
        """The whole params mapping (a collective)."""
        if self._packed_step is not None:
            return self.gather_state(state).params
        return self._whole(state.params)

    def shard_state(self, whole):
        """This rank's state from a whole one (no collective); the model
        takes the params' shards."""
        from fashionvisualexpl_tpu_torch.parallel.spmd import load_tensors, row_shard

        if self._packed_step is not None:
            from fashionvisualexpl_tpu_torch.parallel.fast_spmd import (
                shard_generic_packed_state,
            )

            return whole.with_inner(shard_generic_packed_state(whole.inner, self.mesh))

        def cut(tree):
            return {k: row_shard(v, self.mesh) if self._sharded(k)
                    else v.detach().to(self.device, copy=True) for k, v in tree.items()}

        load_tensors(self.model, cut(whole.params))
        opt = whole.opt_state
        return TrainState(whole.step.to(self.device, copy=True),
                          dict(self.model.named_parameters()),
                          type(opt)(opt.count.to(self.device, copy=True), cut(opt.mu),
                                    cut(opt.nu)))

    @contextlib.contextmanager
    def whole_model(self, params: Dict[str, torch.Tensor]):
        """The model holding the whole ``params`` and its whole buffers (a
        collective gathers them) for the duration; its shards after."""
        from fashionvisualexpl_tpu_torch.parallel.spmd import load_tensors

        shards = {**{k: v.data for k, v in self.model.named_parameters()},
                  **dict(self.model.named_buffers())}
        load_tensors(self.model, {**params, **self._whole(dict(self.model.named_buffers()))})
        try:
            yield self.model
        finally:
            load_tensors(self.model, shards)

    def finish(self, state):
        """(state, frozen) in the single-device layout, the model holding
        the whole tables from here on (a collective)."""
        from fashionvisualexpl_tpu_torch.parallel.spmd import load_tensors

        whole = self.gather_state(state)
        load_tensors(self.model, {**whole.params, **self._whole(dict(self.model.named_buffers()))})
        self._rows = {}
        if self._packed_step is not None:
            return whole, dict(self.model.named_buffers())
        return (whole._replace(params=dict(self.model.named_parameters())),
                dict(self.model.named_buffers()))

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
    ``print_epoch(epoch, epochs, mean_loss, record)``.

    With ``ckpt_dir``, the train state is checkpointed every ``cfg.verbose``
    epochs and at epoch 1 (reference BPRMF.py:158-160 cadence; verbose <= 0
    disables) and the best params at the end; ``resume=True`` restores the
    latest checkpoint and continues from the next epoch.  The epoch seeds
    depend only on (seed, epoch), so a resumed run continues exactly as the
    uninterrupted one would."""
    init_seed, epoch_seed = split_seed(cfg.seed if seed is None else seed)
    return run_fit(Trainer(model, data, cfg), init_seed, epoch_seed, evaluator=evaluator,
                   log=log, ckpt_dir=ckpt_dir, resume=resume)


def run_fit(
    trainer,
    init_seed: int,
    epoch_seed: int,
    evaluator=None,
    log: Optional[Callable[[Dict[str, Any]], None]] = None,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
) -> Tuple[TrainState, Any, Dict[int, Dict[str, float]], Dict[str, Any]]:
    """``fit``'s run structure over ``trainer`` (a ``Trainer``, or the
    streamed trainer of ``train/streamed.py``): the state from
    ``trainer.init_state(init_seed)``, epoch e run by
    ``trainer.run_epoch(state, frozen, fold_in(epoch_seed, e))``; the
    evaluation cadence, best params, checkpoints and log records as
    ``fit`` documents them."""
    cfg = trainer.cfg
    mesh = getattr(trainer, "mesh", None)
    primary = mesh is None or mesh.is_primary
    state, frozen = trainer.init_state(init_seed)

    def whole_params():  # over a mesh a collective: every rank calls it
        if mesh is None:
            return {k: v.detach().clone() for k, v in state.params.items()}
        return trainer.gather_params(state)

    ckpt = None
    start_epoch = 1
    if ckpt_dir is not None:
        from fashionvisualexpl_tpu_torch.core.checkpoint import CheckpointManager

        ckpt = CheckpointManager(ckpt_dir)
        if resume and ckpt.latest_step() is not None:
            if mesh is None:
                state = ckpt.restore(state)  # in place (generic: the model's own params)
            else:  # the single-device layout, then this rank's shards
                state = trainer.shard_state(ckpt.restore(trainer.gather_state(state)))
            start_epoch = int(ckpt.latest_step()) + 1

    results: Dict[int, Dict[str, float]] = {}
    history: List[EpochResult] = []
    # a copy: the steps update state.params in place
    best_params = whole_params()
    best_epoch = 0
    best_value = -float("inf")
    metric_key = cfg.best_metric + "_v"

    for epoch in range(start_epoch, cfg.epochs + 1):
        t0 = time.time()
        state, loss = trainer.run_epoch(state, frozen, fold_in(epoch_seed, epoch))
        loss = float(loss)
        train_time = time.time() - t0

        rec = EpochResult(epoch=epoch, loss=loss, train_time_s=train_time)
        if evaluator is not None and epoch % cfg.eval_every == 0:
            t1 = time.time()
            if mesh is None:
                params, metrics = state.params, evaluator.evaluate(state.params, frozen)
            else:  # the primary evaluates the whole tables; all get its metrics
                from fashionvisualexpl_tpu_torch.core.mesh import broadcast_object

                params, metrics = whole_params(), None
                with trainer.whole_model(params) as m:
                    if primary:
                        metrics = evaluator.evaluate(params, dict(m.named_buffers()))
                metrics = broadcast_object(metrics, mesh)
            rec.eval_time_s = time.time() - t1
            rec.metrics = metrics
            results[epoch] = metrics
            if primary:
                evaluator.print_epoch(
                    epoch, cfg.epochs, loss / trainer.steps_per_epoch, rec
                )
            if metrics.get(metric_key, -float("inf")) >= best_value:
                best_value = metrics[metric_key]
                best_epoch = epoch
                best_params = {k: v.detach().clone() for k, v in params.items()}
        history.append(rec)
        if ckpt is not None and cfg.verbose > 0 and (
            epoch % cfg.verbose == 0 or epoch == 1
        ):
            if mesh is None:
                ckpt.save(epoch, state)
            else:
                whole = trainer.gather_state(state)
                if primary:
                    ckpt.save(epoch, whole)
        if log is not None and primary:
            log(
                {
                    "epoch": epoch,
                    "loss": loss,
                    "train_time_s": train_time,
                    "eval_time_s": rec.eval_time_s,
                    **(rec.metrics or {}),
                }
            )

    if ckpt is not None:
        if primary:
            ckpt.save_best(best_params)
        ckpt.close()
    if mesh is not None:
        state, frozen = trainer.finish(state)

    return state, frozen, results, {
        "history": history,
        "best_params": best_params,
        "best_epoch": best_epoch,
    }
