"""Port checkpoints (``core/checkpoint.py``) and ``fit(ckpt_dir, resume)``.

The port's own format (``torch.save``), so nothing is compared with the
JAX package's Orbax files; the JAX package's resume contract
(``tests/test_checkpoint.py``) is what is held: save and restore round-trip
bit for bit, and a run interrupted after an epoch and resumed ends bit for
bit where the uninterrupted run ends."""

import os

import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu_torch.core.checkpoint import CheckpointManager
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fit


def _setup(epochs=3, **kw):
    data = synthetic_interactions(30, 40, interactions_per_user=8, seed=1)
    model = BPRMF(30, 40, embed_k=8, device="cpu")
    cfg = TrainConfig(batch_size=16, epochs=epochs, lr=0.05, reg=0.001, seed=5, **kw)
    return model, data, cfg


def _flat(state):
    out = {"step": state.step, "count": state.opt_state.count}
    for name in state.params:
        out[f"p/{name}"] = state.params[name]
        out[f"m/{name}"] = state.opt_state.mu[name]
        out[f"v/{name}"] = state.opt_state.nu[name]
    return {k: v.detach().clone() for k, v in out.items()}


def test_save_restore_round_trip_bit_for_bit(tmp_path):
    model, data, cfg = _setup()
    trainer = Trainer(model, data, cfg)
    state, frozen = trainer.init_state(3)
    state, _ = trainer.run_epoch(state, frozen, 7)
    saved = _flat(state)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    mgr.save(1, state)
    state, _ = trainer.run_epoch(state, frozen, 8)  # move away from the save
    assert not torch.equal(state.params["Gu"], saved["p/Gu"])
    restored = mgr.restore(state)
    assert mgr.latest_step() == 1
    for k, v in _flat(restored).items():
        assert torch.equal(v, saved[k]) and v.dtype == saved[k].dtype, k
    # in place: the model's own parameters hold the restored values
    for name, p in model.named_parameters():
        assert restored.params[name] is p and torch.equal(p.detach(), saved[f"p/{name}"])


def test_max_to_keep_and_template_checks(tmp_path):
    model, data, cfg = _setup()
    state, _ = Trainer(model, data, cfg).init_state(0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, state)
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]
    assert mgr.latest_step() == 5
    with pytest.raises(ValueError, match="template"):
        mgr.restore({"Gu": torch.zeros(2)})
    small = BPRMF(30, 40, embed_k=4, device="cpu")
    with pytest.raises(ValueError, match="template"):
        mgr.restore(Trainer(small, data, cfg).init_state(0)[0])


def test_save_best_and_restore_best(tmp_path):
    model, data, cfg = _setup()
    best = {k: v.detach().clone() + 1.0 for k, v in model.named_parameters()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_best(best)
    other = BPRMF(30, 40, embed_k=8, device="cpu",
                  generator=torch.Generator().manual_seed(9))
    params = mgr.restore_best(dict(other.named_parameters()))
    for k, v in other.named_parameters():
        assert params[k] is v and torch.equal(v.detach(), best[k])
    mgr.save_best({k: v * 2 for k, v in best.items()})  # overwrites
    params = mgr.restore_best(dict(other.named_parameters()))
    assert torch.equal(params["Bi"].detach(), best["Bi"] * 2)


class _Rising:
    """Duck-typed evaluator whose validation metric rises every epoch."""

    def __init__(self):
        self.n = 0

    def evaluate(self, params, frozen):
        self.n += 1
        return {"ndcg_v": float(self.n)}

    def print_epoch(self, *a):
        pass


@pytest.mark.parametrize("verbose", [1, 2])
def test_fit_resume_equals_uninterrupted(verbose, tmp_path):
    model, data, cfg = _setup(epochs=4, verbose=verbose)
    full, _, _, full_extra = fit(model, data, cfg, evaluator=_Rising(),
                                 ckpt_dir=str(tmp_path / "full"))
    full = _flat(full)
    # interrupted after epoch 2 (a checkpoint there for verbose 1 and 2)
    model2, _, cfg2 = _setup(epochs=2, verbose=verbose)
    fit(model2, data, cfg2, ckpt_dir=str(tmp_path / "cut"))
    assert CheckpointManager(str(tmp_path / "cut")).latest_step() == 2
    model3, _, _ = _setup()
    logs = []
    resumed, _, results, extra = fit(model3, data, cfg, evaluator=_Rising(),
                                     ckpt_dir=str(tmp_path / "cut"), resume=True,
                                     log=logs.append)
    assert [r["epoch"] for r in logs] == [3, 4] and sorted(results) == [3, 4]
    for k, v in _flat(resumed).items():
        assert torch.equal(v, full[k]), k
    # the best params (epoch 4 both times) went to best-state
    for name in ("Gu", "Gi", "Bi"):
        assert torch.equal(extra["best_params"][name], full_extra["best_params"][name])
    best = CheckpointManager(str(tmp_path / "cut")).restore_best(
        {k: torch.zeros_like(v) for k, v in full_extra["best_params"].items()})
    for k, v in best.items():
        assert torch.equal(v, full_extra["best_params"][k])
    steps = sorted(int(s) for s in os.listdir(tmp_path / "full") if s.isdigit())
    assert steps == ([2, 3, 4] if verbose == 1 else [1, 2, 4])
    # without resume the same directory trains from the start
    model4, _, _ = _setup()
    again, _, _, _ = fit(model4, data, cfg, ckpt_dir=str(tmp_path / "cut"))
    for k, v in _flat(again).items():
        np.testing.assert_array_equal(v.numpy(), full[k].numpy(), err_msg=k)
