"""fashionvisualexpl_tpu_torch — the PyTorch/CUDA port of fashionvisualexpl_tpu.

A second package beside the JAX one, ported slice by slice; each module
mirrors the path of its JAX counterpart.  It imports ``torch`` and never
``jax`` or ``fashionvisualexpl_tpu``.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"`` (``core/device.py``).

Ported so far: the serving slice — host data (``data/interactions.py``),
BPRMF (``models/bprmf.py``), the fused scoring + segment-max CUDA kernel
(``ops/segmax.py``, ``ops/csrc/segmax.cu``) and ``serve/engine.py::RecServer``.
"""

__version__ = "0.1.0"
