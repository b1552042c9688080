"""Device resolution: the card unless the caller asks for the CPU.

Every entry point of the port takes a ``device`` argument and resolves it
here. ``None`` means the CUDA card; on a machine without one that raises
instead of quietly running the model on the CPU. The CPU is used only when a
caller names it (the tests do).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

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


_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def constant(values: Sequence[float], dtype: torch.dtype, device: Union[str, torch.device]) -> torch.Tensor:
    """A 1-D tensor of Python numbers on ``device``, made once per (values,
    dtype, device) and shared after; callers must not write to it. A step
    captured as a CUDA graph makes its constants at its warm-up, so the
    capture and every replay read them with no host copy and no launch."""
    key = (tuple(values), dtype, str(torch.device(device)))
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype).to(device)
    return t
