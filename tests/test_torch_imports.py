"""The PyTorch port stands alone: no jax, no JAX package and no pandas (the
card's machine has none; neither in the package nor in ``chip_smoke.py``),
no cv2, sklearn or PIL at module import (the vision stack imports them
where an image is read or a low-level feature made), and its entry points
refuse to fall back to the CPU silently."""

import ast
import os
import subprocess
import sys

import numpy as np
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
    if m.split(".")[0] in ("jax", "jaxlib", "fashionvisualexpl_tpu", "pandas")
)
host_only = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "sklearn", "PIL"))
print(len(names), bad, host_only)
sys.exit(1 if bad or host_only else 0)
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
    assert n_modules >= 69  # every submodule of the slices so far was imported


def _is_jax(name):
    return name.split(".")[0] in ("jax", "jaxlib", "fashionvisualexpl_tpu", "pandas")


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """Every import statement of chip_smoke.py, also those inside its
    phases, names neither (nor pandas); importing it loads neither."""
    path = os.path.join(REPO, "chip_smoke.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert any(n.startswith("fashionvisualexpl_tpu_torch") for n in names)
    assert not [n for n in names if _is_jax(n)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    check = ("import sys, chip_smoke; "
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'fashionvisualexpl_tpu', 'pandas')]; print(bad); "
             "sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", check], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_bprmf_without_device_raises_when_no_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BPRMF(4, 6, embed_k=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BPRMF(4, 6, embed_k=2, device="cuda")


def test_attentive_fashion_without_device_raises_when_no_cuda(no_cuda):
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion

    inputs = (np.ones((6, 4), np.float32), np.ones((6, 8, 8, 1), np.float32),
              np.eye(6, dtype=np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AttentiveFashion(4, 6, *inputs, embed_k=2, attention_layers=(2, 1))
    model = AttentiveFashion(4, 6, *inputs, embed_k=2, attention_layers=(2, 1),
                             device="cpu")
    assert model.tower_route == "plain"  # edge_tower="auto" off the card


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


def test_packed_engine_and_row_kernels_raise_when_no_cuda(no_cuda):
    from fashionvisualexpl_tpu_torch.ops.gather import bench_gather
    from fashionvisualexpl_tpu_torch.ops.row_scatter import bench_scatter
    from fashionvisualexpl_tpu_torch.train.packed_generic import (
        make_generic_packed_epoch_fn,
    )

    model = BPRMF(6, 12, embed_k=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_generic_packed_epoch_fn(model, 0.01, 0.0, 12, 2, 4)
    for bench in (bench_gather, bench_scatter):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench(table_rows=8, dim=4, batch=4, reps=1)
    make_generic_packed_epoch_fn(model, 0.01, 0.0, 12, 2, 4, device="cpu")
    cfg = TrainConfig(batch_size=4, epochs=1, train_path="packed")
    data = synthetic_interactions(6, 12, interactions_per_user=4, seed=0)
    assert Trainer(model, data, cfg).device.type == "cpu"


# the lazy top-level surface, in a fresh interpreter without jax
_SURFACE_CHECK = """
import importlib, sys
import fashionvisualexpl_tpu_torch as fvx
loaded = sorted(m for m in sys.modules if m.startswith("fashionvisualexpl_tpu_torch."))
assert not loaded, loaded  # importing the package loads none of its modules
ported = {
    "TrainConfig": "core.config", "Paths": "core.config", "MeshConfig": "core.config",
    "Interactions": "data.interactions", "synthetic_interactions": "data.interactions",
    "BPRMF": "models.bprmf", "AttentiveFashion": "models.attentive_fashion", "ACF": "models.acf",
    "VBPR": "models.vbpr", "GradFashion": "models.grad_fashion",
    "Trainer": "train.trainer", "fit": "train.trainer", "Evaluator": "eval.evaluator",
    "FactoredEvaluator": "eval.factored", "CheckpointManager": "core.checkpoint",
    "CompVBPR": "models.comp_vbpr",
}
for name, mod in ported.items():
    obj = getattr(fvx, name)
    assert obj is getattr(importlib.import_module("fashionvisualexpl_tpu_torch." + mod), name)
    assert obj.__module__ == "fashionvisualexpl_tpu_torch." + mod, (name, obj.__module__)
assert fvx.TrainConfig().batch_size == 256 and callable(fvx.fit)
try:
    fvx.not_a_thing
except AttributeError:
    pass
else:
    raise AssertionError("not_a_thing resolved")
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "fashionvisualexpl_tpu")]
assert not bad, bad
print("ok")
"""


def test_lazy_api_surface():
    """Mirrors tests/test_api_surface.py::test_lazy_api_surface for the port."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _SURFACE_CHECK], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr
