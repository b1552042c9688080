"""Resident LoRA adapters, content-versioned, evicted least-recently-used by
bytes (port of ``hyperscalees_t2i_tpu/serve/adapter_store.py``; residency
leases and checkpoint loading come later).

Adapters are kept on the host as CPU tensors; a dispatch stacks the batch's
adapters and moves them to the card.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch

from ..utils.pytree import tree_leaves, tree_map, tree_structure

Adapter = Any


def adapter_bytes(tree: Adapter) -> int:
    """Bytes of an adapter tree (sum over leaves)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def adapter_digest(tree: Adapter) -> str:
    """Content sha256 (16 hex chars) over the leaves in sorted-key order:
    dtype name, shape tuple and raw bytes of each. The same bytes give the
    same digest as the JAX package's ``adapter_digest``."""
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        t = leaf.detach().to("cpu").contiguous()
        h.update(str(t.dtype).replace("torch.", "").encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def validate_adapter_tree(adapter_id: str, theta: Adapter, template: Optional[Adapter]) -> None:
    """Raise unless ``theta`` matches ``template`` in structure and in every
    leaf's shape and dtype."""
    if template is None:
        return
    if tree_structure(theta) != tree_structure(template):
        raise ValueError(
            f"adapter {adapter_id!r}: tree structure does not match the engine's "
            "template (different LoRA targets or rank?)"
        )
    for i, (t, a) in enumerate(zip(tree_leaves(template), tree_leaves(theta))):
        if not torch.is_tensor(a) or tuple(a.shape) != tuple(t.shape) or a.dtype != t.dtype:
            got = (tuple(a.shape), a.dtype) if torch.is_tensor(a) else type(a).__name__
            raise ValueError(
                f"adapter {adapter_id!r} leaf {i}: {got} != template {tuple(t.shape)}/{t.dtype}"
            )


class AdapterEntry:
    __slots__ = ("adapter_id", "theta", "nbytes", "version", "hits")

    def __init__(self, adapter_id: str, theta: Adapter, nbytes: int, version: str):
        self.adapter_id = adapter_id
        self.theta = theta
        self.nbytes = nbytes
        self.version = version
        self.hits = 0


class AdapterStore:
    """LRU-by-bytes working set of adapter trees. ``budget_bytes=0`` disables
    eviction; one adapter larger than the budget is refused. ``template``
    arms the structural check of every :meth:`put`."""

    def __init__(self, budget_bytes: int = 0, template: Optional[Adapter] = None):
        self.budget_bytes = int(budget_bytes)
        self.template = template
        self._entries: "OrderedDict[str, AdapterEntry]" = OrderedDict()
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    @property
    def resident_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def ids(self) -> List[str]:
        """Resident ids, least- to most-recently used."""
        return list(self._entries)

    def _enforce_budget(self, incoming_id: str) -> None:
        if self.budget_bytes <= 0:
            return
        for victim_id in list(self._entries):
            if self.resident_bytes <= self.budget_bytes or len(self._entries) <= 1:
                break
            if victim_id == incoming_id:
                continue
            self._entries.pop(victim_id)
            self.evictions += 1

    def put(self, adapter_id: str, theta: Adapter) -> AdapterEntry:
        """Admit or replace an adapter; leaves are copied to the host so a
        caller changing its tree later cannot change a resident version."""
        validate_adapter_tree(adapter_id, theta, self.template)
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), theta)
        entry = AdapterEntry(adapter_id, host, adapter_bytes(host), adapter_digest(host))
        if 0 < self.budget_bytes < entry.nbytes:
            raise ValueError(
                f"adapter {adapter_id!r} alone exceeds the residency budget "
                f"({entry.nbytes} > {self.budget_bytes} bytes)"
            )
        self._entries[adapter_id] = entry
        self._entries.move_to_end(adapter_id)
        self._enforce_budget(adapter_id)
        return entry

    def get(self, adapter_id: str) -> Adapter:
        """The adapter's host tree; marks it most recently used."""
        entry = self._entries.get(adapter_id)
        if entry is None:
            self.misses += 1
            raise KeyError(
                f"adapter {adapter_id!r} is not resident (loaded ids: {self.ids()}) — "
                "register it with put() first"
            )
        self._entries.move_to_end(adapter_id)
        entry.hits += 1
        self.hits += 1
        return entry.theta

    def entry(self, adapter_id: str) -> AdapterEntry:
        """Metadata without touching the LRU order."""
        e = self._entries.get(adapter_id)
        if e is None:
            self.misses += 1
            raise KeyError(f"adapter {adapter_id!r} is not resident")
        return e

    def evict(self, adapter_id: str) -> bool:
        """Drop an adapter; True if it was resident."""
        if self._entries.pop(adapter_id, None) is None:
            return False
        self.evictions += 1
        return True

    def stats(self) -> Dict[str, Any]:
        return {
            "resident": len(self._entries),
            "resident_bytes": self.resident_bytes,
            "budget_bytes": self.budget_bytes,
            "evictions": self.evictions,
            "hits": self.hits,
            "misses": self.misses,
            "adapters": {aid: {"bytes": e.nbytes, "version": e.version, "hits": e.hits}
                         for aid, e in self._entries.items()},
        }
