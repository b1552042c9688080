"""Device resolution: the card unless the caller asks for the CPU.

Every entry point of the port takes a ``device`` argument and resolves it
here. ``None`` means the CUDA card; on a machine without one that raises
instead of quietly running the model on the CPU. The CPU is used only when a
caller names it (the tests do).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a CUDA device); anything else is
    taken as given, after checking that a requested CUDA device exists."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev

