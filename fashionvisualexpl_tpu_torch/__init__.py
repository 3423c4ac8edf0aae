"""fashionvisualexpl_tpu_torch — the PyTorch/CUDA port of fashionvisualexpl_tpu.

A second package beside the JAX one, ported slice by slice; each module
mirrors the path of its JAX counterpart.  It imports ``torch`` and never
``jax`` or ``fashionvisualexpl_tpu``.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"`` (``core/device.py``).

Ported: serving (``serve/engine.py::RecServer``), BPRMF, VBPR, GradFashion,
AttentiveFashion, CompVBPR and ACF with the generic ``Trainer`` / ``fit``, the fast
BPRMF and VBPR steps and the packed LazyAdam engine (frozen feature columns
fused into the item rows, ACF's extra item rows), dense and streaming evaluation with the dumps,
GradFashion's explanations (``explain/grads.py``), checkpoints and the
``train_rec`` / ``serve_rec`` / ``get_explanations`` CLI, on one device and
over a mesh; the vision stack (ResNet-50/152 and VGG19 backbones, the
extractors, ``extract_features``) and the offline tools (the dataset
writer, profiling, ``split_dataset``, ``build_amazon``, ``logs_to_table``).  Every Pallas
kernel of the JAX package has a hand-written CUDA C++ counterpart under
``ops/csrc/``.  The top-level names below resolve lazily, as in the JAX
package.
"""

__version__ = "0.1.0"

_SURFACE = {
    "TrainConfig": "fashionvisualexpl_tpu_torch.core.config",
    "Paths": "fashionvisualexpl_tpu_torch.core.config",
    "MeshConfig": "fashionvisualexpl_tpu_torch.core.config",
    "Interactions": "fashionvisualexpl_tpu_torch.data.interactions",
    "synthetic_interactions": "fashionvisualexpl_tpu_torch.data.interactions",
    "BPRMF": "fashionvisualexpl_tpu_torch.models.bprmf",
    "VBPR": "fashionvisualexpl_tpu_torch.models.vbpr",
    "GradFashion": "fashionvisualexpl_tpu_torch.models.grad_fashion",
    "AttentiveFashion": "fashionvisualexpl_tpu_torch.models.attentive_fashion",
    "ACF": "fashionvisualexpl_tpu_torch.models.acf",
    "CompVBPR": "fashionvisualexpl_tpu_torch.models.comp_vbpr",
    "Trainer": "fashionvisualexpl_tpu_torch.train.trainer",
    "fit": "fashionvisualexpl_tpu_torch.train.trainer",
    "Evaluator": "fashionvisualexpl_tpu_torch.eval.evaluator",
    "FactoredEvaluator": "fashionvisualexpl_tpu_torch.eval.factored",
    "CheckpointManager": "fashionvisualexpl_tpu_torch.core.checkpoint",
}


def __getattr__(name):
    """Lazy top-level API (keeps ``import fashionvisualexpl_tpu_torch``
    light: no module of the package loads until a name is asked for)."""
    if name in _SURFACE:
        import importlib

        return getattr(importlib.import_module(_SURFACE[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
