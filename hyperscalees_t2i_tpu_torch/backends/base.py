"""The generator-backend protocol as the serving path uses it.

Port of the part of ``hyperscalees_t2i_tpu/backends/base.py`` that
``generate_p`` needs. The JAX protocol threads frozen arrays through a pure,
jitted ``generate_p(frozen, theta, ids, key)``; eager PyTorch has no
compiled program to keep constants out of, so the backend holds its frozen
modules itself and ``generate_p`` takes a *lane-stacked* adapter batch
instead: ``n`` adapters, each with its own ``b`` prompts and its own seed.
"""

from __future__ import annotations

from typing import Any, List, Optional, Protocol, Sequence, runtime_checkable

import torch

Adapter = Any


@runtime_checkable
class GeneratorBackend(Protocol):
    name: str
    device: torch.device

    def init_theta(self, generator: torch.Generator) -> Adapter:
        """A fresh adapter tree (identity at init)."""
        ...

    @property
    def lora_scale(self) -> float:
        ...

    @property
    def num_items(self) -> int:
        """Size of the prompt catalog."""
        ...

    @property
    def texts(self) -> List[str]:
        ...

    def generate_p(
        self,
        stacked_theta: Optional[Adapter],
        flat_ids: torch.Tensor,
        seeds: Sequence[int],
        noise: Optional[torch.Tensor] = None,
        guidance_scale: Optional[float] = None,
    ) -> torch.Tensor:
        """``flat_ids [n, b]`` catalog indices, one adapter and one seed per
        lane → images ``[n, b, H, W, 3]`` in [0, 1]. Image ``j`` of lane
        ``i`` draws its noise from ``(seeds[i], j)`` only."""
        ...
