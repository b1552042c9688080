"""Deterministic prompt sampling and seed plumbing (port of
``hyperscalees_t2i_tpu/es/sampling.py``).

Common random numbers: every member of an epoch shares one generation key,
and the prompt subset, generation noise and ES noise all derive from
``(base seed, epoch)``: :func:`epoch_key` folds the epoch into the base
seed's key as the JAX package does, and the trainer splits it into its
noise and generation keys. The prompt subsets are numpy ``RandomState``
draws and match the JAX package's exactly.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from ..device import DeviceLike
from ..utils import threefry


def sample_indices_unique(seed: int, total: int, k: int) -> List[int]:
    """``k`` unique indices from ``range(total)``: all of them, in order,
    when ``k >= total``; else a seeded choice without replacement."""
    if total <= 0:
        raise ValueError("total must be >= 1")
    if k <= 0:
        raise ValueError("k must be >= 1")
    rng = np.random.RandomState(int(seed))
    if k >= total:
        return list(range(total))
    return rng.choice(np.arange(total, dtype=np.int64), size=k, replace=False).tolist()


def repeat_batches(ids_unique: List[int], repeats: int) -> List[int]:
    """[a, b] × 3 → [a, b, a, b, a, b] (grouped repeats)."""
    if repeats <= 0:
        raise ValueError("repeats must be >= 1")
    return [i for _ in range(repeats) for i in ids_unique]


def mix_seed(base: int, a: int, b: int) -> int:
    """Deterministic 32-bit seed mixer (the reference's constants)."""
    x = (int(base) ^ 0x9E3779B9) & 0xFFFFFFFF
    x = (x + (int(a) * 0x85EBCA6B)) & 0xFFFFFFFF
    x = (x ^ (x >> 13)) & 0xFFFFFFFF
    x = (x + (int(b) * 0xC2B2AE35)) & 0xFFFFFFFF
    x = (x ^ (x >> 16)) & 0xFFFFFFFF
    return int(x)


def epoch_key(base_seed: int, epoch: int, device: DeviceLike = None) -> torch.Tensor:
    """The key of one epoch, ``fold_in(prng_key(base), epoch)`` on
    ``device`` (``None``: the card; the JAX package's ``epoch_key``)."""
    return threefry.fold_in(threefry.prng_key(base_seed, device), int(epoch))


def parse_int_list(s: str) -> Union[str, List[int]]:
    """``"1,2,3"`` → ``[1, 2, 3]``; ``""``/``"all"`` → ``"all"``."""
    s = (s or "").strip()
    if s.lower() == "all" or s == "":
        return "all"
    return [int(x.strip()) for x in s.split(",") if x.strip() != ""]
