"""Device selection for the port's entry points.

Every entry point runs on ``"cuda"`` unless its caller names another
device. Asking for CUDA where there is none raises: the port never moves
to the CPU on its own.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev
