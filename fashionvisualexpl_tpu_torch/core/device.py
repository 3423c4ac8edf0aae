"""Where the port's entry points run.

The port runs on the CUDA card unless the caller asks for the CPU.  This is
the one place that rule lives: ``resolve_device(None)`` is ``cuda`` when a
card is present and raises when it is not — an entry point never carries on
silently on the CPU.  Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given,
    except that an explicit CUDA device also needs CUDA to be present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU"
        )
    return dev
