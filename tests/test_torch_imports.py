"""The PyTorch port stands alone: no jax, no JAX package, and its entry
points refuse to fall back to the CPU silently."""

import os
import subprocess
import sys

import pytest
import torch

from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.serve import RecServer
from fashionvisualexpl_tpu_torch.train.fast import make_fast_epoch_fn
from fashionvisualexpl_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the test process itself has jax loaded (tests/conftest.py), so the check
# runs in a fresh interpreter
_CHECK = """
import importlib, pkgutil, sys
import fashionvisualexpl_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "fashionvisualexpl_tpu" or m.startswith("fashionvisualexpl_tpu.")
)
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 22  # every submodule of both slices was imported


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_bprmf_without_device_raises_when_no_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BPRMF(4, 6, embed_k=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BPRMF(4, 6, embed_k=2, device="cuda")


def test_recserver_without_device_raises_when_no_cuda(no_cuda):
    data = synthetic_interactions(6, 12, interactions_per_user=4, seed=0)
    model = BPRMF(6, 12, embed_k=4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecServer(model, data, k=3)
    srv = RecServer(model, data, k=3, device="cpu")
    assert srv.device.type == "cpu"


def test_training_entry_points_raise_when_no_cuda(no_cuda):
    data = synthetic_interactions(6, 12, interactions_per_user=4, seed=0)
    tabs = [torch.as_tensor(a) for a in (data.train_pairs, data.padded_pos,
                                         data.pos_counts)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_triplets(0, *tabs, 12, 2, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_fast_epoch_fn(None, 0.01, 0.0, 12, 2, 4, pallas_bpr=True,
                           fused_adam=True)
    cfg = TrainConfig(batch_size=4, epochs=1)

    class OnCard(torch.nn.Module):  # a model whose parameters claim the card
        device = torch.device("cuda")

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(OnCard(), data, cfg)
    # device="cpu" (the model's own, for the Trainer) runs
    sample_triplets(0, *tabs, 12, 2, 4, device="cpu")
    make_fast_epoch_fn(None, 0.01, 0.0, 12, 2, 4, device="cpu")
    trainer = Trainer(BPRMF(6, 12, embed_k=2, device="cpu"), data, cfg)
    assert trainer.device.type == "cpu"
