"""Continuous batching: a bounded FIFO queue and geometry-keyed coalescing
(port of ``hyperscalees_t2i_tpu/serve/batcher.py`` without the overload
fields).

Take the oldest pending request, then every queued request with the same
geometry key (prompt count + guidance) in arrival order until the adapter
axis is full; requests with another key keep their place for a later batch.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

_ids = itertools.count()


class QueueFullError(RuntimeError):
    """Backpressure refusal: the queue is at ``max_depth``."""


@dataclasses.dataclass
class ServeRequest:
    """One request: ``len(prompt_ids)`` images with ``adapter_id``'s LoRA
    under ``seed``; ``guidance`` is part of the geometry key."""

    adapter_id: str
    prompt_ids: Tuple[int, ...]
    seed: int
    guidance: Optional[float] = None
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def geometry_key(self) -> Tuple[int, Optional[float]]:
        return (len(self.prompt_ids), self.guidance)


@dataclasses.dataclass
class ServeResult:
    """One finished request. ``error`` is set (and ``images`` is None) when
    the request alone was refused, e.g. its adapter was evicted."""

    request: ServeRequest
    images: Optional[np.ndarray]  # [B, H, W, C]
    latency_s: float
    batch_size: int  # requests in the dispatched batch
    batch_occupancy: float  # batch_size / adapter_batch
    adapter_version: str = ""
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


class RequestQueue:
    """Bounded FIFO with geometry-keyed batch extraction."""

    def __init__(self, max_depth: int = 1024):
        self.max_depth = int(max_depth)
        self._q: Deque[ServeRequest] = deque()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, req: ServeRequest) -> ServeRequest:
        if self.max_depth > 0 and len(self._q) >= self.max_depth:
            raise QueueFullError(
                f"serve queue full ({len(self._q)} >= max_depth={self.max_depth}) — backpressure"
            )
        self._q.append(req)
        return req

    def take_batch(self, max_n: int) -> List[ServeRequest]:
        """Up to ``max_n`` requests sharing the oldest request's geometry key,
        in arrival order; the others keep their queue positions."""
        if not self._q or max_n < 1:
            return []
        key = self._q[0].geometry_key
        batch: List[ServeRequest] = []
        keep: Deque[ServeRequest] = deque()
        while self._q:
            req = self._q.popleft()
            if len(batch) < max_n and req.geometry_key == key:
                batch.append(req)
            else:
                keep.append(req)
        self._q = keep
        return batch
