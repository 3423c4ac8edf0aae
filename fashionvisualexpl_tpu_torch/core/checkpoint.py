"""Checkpoint save/restore (port of ``fashionvisualexpl_tpu/core/checkpoint.py``).

The reference writes `tf.train.Checkpoint`s per epoch and for the best model
(src/recommender/models/BPRMF.py:53,158-160,177-179) but has NO restore path.
Here the full train state (params, Adam moments, step) checkpoints with
``torch.save``, with periodic saves, best-params tracking and real resume.

Layout: ``{directory}/{step}/state.pt`` (periodic, the newest
``max_to_keep`` kept) and ``{directory}/best-state/params.pt`` (the best
validation params).  A file holds a flat mapping from path strings
("params/Gu", "opt_state/mu/Gu", "step", ...) to CPU tensors, read back
with ``torch.load(weights_only=True)``.  This is not the JAX package's
format: the port cannot read Orbax checkpoints, nor the JAX package read
these.

``restore(template)`` copies the saved values INTO the template's tensors
(in place, keeping their devices) and returns the template: the generic
trainer's state holds the model's own parameters, so a restored state is
the model's state too.  The packed engine's ``GenericPackedTrainState``
saves its step, packed user and item rows and dense (p, m, v), bit for
bit, and its ``moment_dtype`` as a string leaf, which a restore must find
equal to the template's (a row_align-padded layout cannot be read under
another moment layout).  The specialized engines' ``PackedTrainState``
(``train/packed.py``) saves its packed state (rows, tau arrays, dense
(p, m, v)) bit for bit and its ``kind`` likewise.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Union

import torch

STATE_FILE = "state.pt"
BEST_DIR = "best-state"
BEST_FILE = "params.pt"


Leaf = Union[torch.Tensor, str]


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Leaf]:
    """Path -> tensor (or string) over nested NamedTuples, dicts, lists and
    tuples; an object with ``_fields`` (a NamedTuple, or a state naming what
    it checkpoints) by those fields."""
    if isinstance(tree, (torch.Tensor, str)):
        return {prefix: tree}
    if hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {prefix!r}")
    out: Dict[str, Leaf] = {}
    for key, sub in items:
        out.update(_flatten(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _save(tree: Any, path: str) -> None:
    flat = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in _flatten(tree).items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(flat, tmp)
    os.replace(tmp, path)  # a crash never leaves a half-written checkpoint


@torch.no_grad()
def _restore_into(template: Any, path: str) -> Any:
    saved = torch.load(path, map_location="cpu", weights_only=True)
    flat = _flatten(template)
    if set(saved) != set(flat):
        raise ValueError(
            f"checkpoint {path} holds {sorted(saved)}, the template "
            f"{sorted(flat)}"
        )
    for key, dst in flat.items():
        src = saved[key]
        if isinstance(dst, str) or isinstance(src, str):
            if src != dst:
                raise ValueError(f"checkpoint {path}: {key} is {src!r}, the template {dst!r}")
            continue
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(
                f"checkpoint {path}: {key} is {src.dtype}{tuple(src.shape)}, "
                f"the template {dst.dtype}{tuple(dst.shape)}"
            )
        dst.copy_(src)
    return template


class CheckpointManager:
    """Periodic train-state checkpoints plus the best params, under one
    directory (see the module docstring for the layout)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._best_dir = os.path.join(self.directory, BEST_DIR)

    def _steps(self):
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit()
            and os.path.exists(os.path.join(self.directory, name, STATE_FILE))
        )

    def save(self, step: int, state: Any) -> None:
        d = os.path.join(self.directory, str(int(step)))
        os.makedirs(d, exist_ok=True)
        _save(state, os.path.join(d, STATE_FILE))
        for old in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore into ``template`` (same structure, shapes and dtypes),
        from ``step`` or the latest one."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return _restore_into(
            template, os.path.join(self.directory, str(int(step)), STATE_FILE)
        )

    def save_best(self, params: Any) -> None:
        os.makedirs(self._best_dir, exist_ok=True)
        _save(params, os.path.join(self._best_dir, BEST_FILE))

    def restore_best(self, template_params: Any) -> Any:
        """The best params, copied into ``template_params`` (e.g.
        ``dict(model.named_parameters())``), which is returned."""
        return _restore_into(template_params, os.path.join(self._best_dir, BEST_FILE))

    def close(self) -> None:
        """Nothing is held open (saves are synchronous); kept for the JAX
        package's interface."""
