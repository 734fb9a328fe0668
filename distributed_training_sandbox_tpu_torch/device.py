"""Device choice for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU.
Without a card they raise: a serving run that silently fell back to the
CPU would report CPU numbers under a GPU's name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; anything else is taken as given.  A CUDA
    device with no card present raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
