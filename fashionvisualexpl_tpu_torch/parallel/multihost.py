"""Process-group bootstrap (port of ``fashionvisualexpl_tpu/parallel/multihost.py``).

The JAX package forms its process group with ``jax.distributed.initialize``
from ``JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID``.  The
port's launcher is ``torchrun``, whose variables take their place:
``MASTER_ADDR`` and ``MASTER_PORT`` (the coordinator), ``WORLD_SIZE`` (the
number of processes) and ``RANK`` (this process), with ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` placing the ranks of one host on its cards.  Call
``initialize_from_env()`` once at process start, then ``global_mesh``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def default_backend() -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``
    (ranks sharing one card, or no card)."""
    local = _int_env("LOCAL_WORLD_SIZE") or 1
    if torch.cuda.is_available() and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> bool:
    """Form the process group from the arguments or torchrun's variables.
    ``coordinator_address`` is ``host:port`` or an init-method URL
    (``tcp://...``, ``file://...``).  Sets this rank's card
    (``LOCAL_RANK`` modulo the cards present) before the group forms.
    Returns True when a multi-process group was formed (or already
    exists), False when running single-process (nothing to do).  Every
    collective of the group fails after ``timeout_s`` seconds."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process group needs a coordinator address and "
                         "this process's id (MASTER_ADDR / RANK under torchrun)")
    if torch.cuda.is_available():
        torch.cuda.set_device((_int_env("LOCAL_RANK") or 0) % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend or default_backend(), init_method=url, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def is_primary() -> bool:
    """True on the process that should write checkpoints and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(data: int = -1, model: int = 1, device=None):
    """The mesh over every process of the group; ``data * model`` must be
    the world size."""
    from fashionvisualexpl_tpu_torch.core.mesh import make_mesh

    return make_mesh(data=data, model=model, device=device)
