"""The generator-backend protocol, and the epoch's prompt plan.

Port of ``hyperscalees_t2i_tpu/backends/base.py``. The JAX protocol threads
frozen arrays through a pure, jitted ``generate_p(frozen, theta, ids,
key)``; eager PyTorch has no
compiled program to keep constants out of, so the backend holds its frozen
modules itself and ``generate_p`` takes a *lane-stacked* adapter batch
instead: ``n`` adapters, each with its own ``b`` prompts and its own key.
``make_frozen`` has no counterpart: the backend's modules hold the frozen
weights as buffers, and the reward suite holds the towers the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Protocol, Sequence, runtime_checkable

import torch

Adapter = Any


@dataclasses.dataclass(frozen=True)
class StepInfo:
    """One epoch's sampling plan: the ``m`` sampled catalog indices, their
    grouped repeats (``repeats`` copies of ``unique_ids`` in order) and the
    prompt texts."""

    unique_ids: List[int]
    flat_ids: List[int]
    repeats: int
    texts: List[str]


def default_step_info(seed: int, total: int, num_unique: int, repeats: int,
                      texts: Optional[List[str]] = None) -> StepInfo:
    """The sampling every backend shares: ``min(num_unique, total)`` unique
    indices from ``seed`` (numpy ``RandomState``, the JAX package's draw),
    repeated ``repeats`` times."""
    from ..es.sampling import repeat_batches, sample_indices_unique

    unique = sample_indices_unique(seed, total, min(num_unique, total))
    flat = repeat_batches(unique, repeats)
    t = [texts[i] for i in unique] if texts else [str(i) for i in unique]
    return StepInfo(unique_ids=unique, flat_ids=flat, repeats=repeats, texts=t)


@runtime_checkable
class GeneratorBackend(Protocol):
    name: str
    device: torch.device

    def init_theta(self, key: torch.Tensor) -> Adapter:
        """A fresh adapter tree (identity at init) from a ``utils.threefry``
        key, the JAX package's draws."""
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

    def step_info(self, seed: int, num_unique: int, repeats: int) -> StepInfo:
        ...

    @property
    def noise_shape(self) -> Sequence[int]:
        """Shape of one image's generation noise."""
        ...

    def sample_gen_noise(self, key: torch.Tensor, item_index: Sequence[int]) -> torch.Tensor:
        """Generation noise ``[..., len(item_index), *noise_shape]`` on the
        key's device (a batch of keys ``[..., 2]`` draws each key's),
        image ``i`` from the key folded with ``item_index[i]`` as the JAX
        package's generator folds it. An ES epoch draws its global item
        indices once and every member shares the noise."""
        ...

    def generate_p(
        self,
        stacked_theta: Optional[Adapter],
        flat_ids: torch.Tensor,
        keys: Optional[torch.Tensor],
        noise: Optional[torch.Tensor] = None,
        guidance_scale: Optional[float] = None,
    ) -> torch.Tensor:
        """``flat_ids [n, b]`` catalog indices, one adapter and one key
        (``keys [n, 2]``) per lane → images ``[n, b, H, W, 3]`` in [0, 1].
        Image ``j`` of lane ``i`` draws its noise from
        ``sample_gen_noise(keys[i], [j])`` only, unless ``noise [n, b,
        *noise_shape]`` is given."""
        ...


def lane_keys(keys: Optional[torch.Tensor], n: int, device: torch.device) -> torch.Tensor:
    """``keys [n, 2]`` on ``device``; raises unless there is one key a lane."""
    if keys is None or tuple(keys.shape) != (n, 2):
        raise ValueError(f"{n} lanes need keys [{n}, 2] or explicit noise, got "
                         f"{None if keys is None else tuple(keys.shape)}")
    return keys.to(device)
