"""Resident LoRA adapters, content-versioned, evicted least-recently-used by
bytes (port of ``hyperscalees_t2i_tpu/serve/adapter_store.py``).

Adapters are kept on the host as CPU tensors; a dispatch stacks the batch's
adapters and moves them to the card. A residency lease (refcounted, one per
accepted request while the overload layer is armed) pins an adapter: budget
eviction skips it, so a queued request's adapter cannot be evicted before
its dispatch. Loads, hits, misses, evictions and leases tick counters and
gauges under the JAX package's names (on the engine's registry, or the
process-global one); a telemetry failure never fails a store operation.
:meth:`AdapterStore.load` reads a training run's checkpoint slots.
"""

from __future__ import annotations

import hashlib
import sys
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..resilience.faultinject import maybe_serve_fault
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
    __slots__ = ("adapter_id", "theta", "nbytes", "version", "hits", "source")

    def __init__(self, adapter_id: str, theta: Adapter, nbytes: int, version: str, source: str = "memory"):
        self.adapter_id = adapter_id
        self.theta = theta
        self.nbytes = nbytes
        self.version = version
        self.hits = 0
        self.source = source


class AdapterStore:
    """LRU-by-bytes working set of adapter trees. ``budget_bytes=0`` disables
    eviction; one adapter larger than the budget is refused. ``template``
    arms the structural check of every :meth:`put`. ``registry`` receives
    the store's counters and gauges (``None``: the process-global
    registry)."""

    def __init__(self, budget_bytes: int = 0, template: Optional[Adapter] = None, registry: Any = None):
        self.budget_bytes = int(budget_bytes)
        self.template = template
        self.registry = registry
        self._entries: "OrderedDict[str, AdapterEntry]" = OrderedDict()
        self.evictions = 0
        self.hits = 0
        self.misses = 0
        # adapter_id -> refcount of in-flight requests pinning it
        self._leases: Dict[str, int] = {}
        # times the budget loop (or an explicit evict) was stopped by a lease
        self.lease_blocked = 0

    @property
    def resident_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def ids(self) -> List[str]:
        """Resident ids, least- to most-recently used."""
        return list(self._entries)

    # -- telemetry -----------------------------------------------------------
    def _emit(self, fn) -> None:
        """Run one telemetry emission; a failure is reported and dropped."""
        try:
            from ..obs.metrics import get_registry

            fn(self.registry if self.registry is not None else get_registry())
        except Exception as e:
            print(f"[serve] WARNING: store telemetry dropped ({e!r})", file=sys.stderr, flush=True)

    def _count(self, name: str, n: int = 1) -> None:
        self._emit(lambda reg: reg.inc(name, n))

    def _publish_gauges(self) -> None:
        def emit(reg):
            reg.gauge("serve/adapter_resident_bytes", self.resident_bytes)
            reg.gauge("serve/adapters_resident", len(self._entries))

        self._emit(emit)

    def _publish_lease_gauge(self) -> None:
        self._emit(lambda reg: reg.gauge("serve/leases_active", self.leases_active))

    # -- residency leases ----------------------------------------------------
    @property
    def leases_active(self) -> int:
        """Outstanding lease refcount over every adapter."""
        return sum(self._leases.values())

    def leased(self, adapter_id: str) -> bool:
        return self._leases.get(adapter_id, 0) > 0

    def lease(self, adapter_id: str) -> int:
        """Pin a resident adapter for one in-flight request (refcounted);
        ``KeyError`` for one that is not resident."""
        if adapter_id not in self._entries:
            raise KeyError(f"cannot lease non-resident adapter {adapter_id!r}")
        n = self._leases.get(adapter_id, 0) + 1
        self._leases[adapter_id] = n
        self._count("serve_lease_acquired")
        self._publish_lease_gauge()
        return n

    def release(self, adapter_id: str) -> int:
        """Drop one lease; releasing an unleased id is a counted no-op."""
        n = self._leases.get(adapter_id, 0)
        if n <= 0:
            self._count("serve_lease_release_orphaned")
            return 0
        if n == 1:
            del self._leases[adapter_id]
        else:
            self._leases[adapter_id] = n - 1
        self._count("serve_lease_released")
        self._publish_lease_gauge()
        return n - 1

    # -- admission -----------------------------------------------------------
    def _enforce_budget(self, incoming_id: str) -> None:
        """Evict least-recently-used adapters until the budget holds, never
        the one just admitted and never a leased one; the set may stay over
        budget while leases pin it (counted as ``lease_blocked``)."""
        if self.budget_bytes <= 0:
            return
        skipped_leased = False
        for victim_id in list(self._entries):
            if self.resident_bytes <= self.budget_bytes or len(self._entries) <= 1:
                break
            if victim_id == incoming_id:
                continue
            if self.leased(victim_id):
                skipped_leased = True
                continue
            self._entries.pop(victim_id)
            self.evictions += 1
            self._count("serve/adapter_evictions")
        if self.resident_bytes > self.budget_bytes and skipped_leased:
            self.lease_blocked += 1
            self._count("serve_lease_blocked_evictions")

    def put(self, adapter_id: str, theta: Adapter, source: str = "memory") -> AdapterEntry:
        """Admit or replace an adapter; leaves are copied to the host so a
        caller changing its tree later cannot change a resident version."""
        validate_adapter_tree(adapter_id, theta, self.template)
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), theta)
        entry = AdapterEntry(adapter_id, host, adapter_bytes(host), adapter_digest(host), source)
        if 0 < self.budget_bytes < entry.nbytes:
            raise ValueError(
                f"adapter {adapter_id!r} alone exceeds the residency budget "
                f"({entry.nbytes} > {self.budget_bytes} bytes)"
            )
        self._entries[adapter_id] = entry
        self._entries.move_to_end(adapter_id)
        self._count("serve/adapter_loads")
        self._enforce_budget(adapter_id)
        self._publish_gauges()
        return entry

    def load(self, adapter_id: str, run_dir, template: Optional[Adapter] = None) -> AdapterEntry:
        """Admit an adapter from a training run's checkpoint slots (the
        newest valid slot, else the legacy mirror: ``train.checkpoints.
        load_checkpoint``). Its version is ``epoch<N>:<content sha>``."""
        from ..train.checkpoints import load_checkpoint

        tmpl = template if template is not None else self.template
        if tmpl is None:
            raise ValueError("AdapterStore.load needs a theta template (construct the store with one, or pass "
                             "template=)")
        restored = load_checkpoint(Path(run_dir), tmpl)
        if restored is None:
            raise FileNotFoundError(f"no loadable checkpoint for adapter {adapter_id!r} in {run_dir}")
        theta, epoch = restored
        entry = self.put(adapter_id, theta, source=str(run_dir))
        entry.version = f"epoch{epoch}:{entry.version}"
        return entry

    def get(self, adapter_id: str) -> Adapter:
        """The adapter's host tree; marks it most recently used. The
        ``store_io*N`` fault raises ``OSError`` here, so a store I/O
        failure fails one request at batch assembly, never its batch."""
        if maybe_serve_fault("store_io"):
            raise OSError(f"injected store_io fault reading adapter {adapter_id!r}")
        entry = self._entries.get(adapter_id)
        if entry is None:
            self.misses += 1
            self._count("serve/adapter_store_misses")
            raise KeyError(
                f"adapter {adapter_id!r} is not resident (loaded ids: {self.ids()}) — "
                "register it with put() or load() first"
            )
        self._entries.move_to_end(adapter_id)
        entry.hits += 1
        self.hits += 1
        self._count("serve/adapter_store_hits")
        return entry.theta

    def entry(self, adapter_id: str) -> AdapterEntry:
        """Metadata without touching the LRU order (a miss still counts)."""
        e = self._entries.get(adapter_id)
        if e is None:
            self.misses += 1
            self._count("serve/adapter_store_misses")
            raise KeyError(f"adapter {adapter_id!r} is not resident")
        return e

    def evict(self, adapter_id: str, force: bool = False) -> bool:
        """Drop an adapter; True if it was resident and is now gone. A
        leased adapter stays unless ``force``, which also clears its leases
        (its queued requests then fail at dispatch)."""
        if not force and self.leased(adapter_id) and adapter_id in self._entries:
            self.lease_blocked += 1
            self._count("serve_lease_blocked_evictions")
            return False
        if force:
            self._leases.pop(adapter_id, None)
            self._publish_lease_gauge()
        if self._entries.pop(adapter_id, None) is None:
            return False
        self.evictions += 1
        self._count("serve/adapter_evictions")
        self._publish_gauges()
        return True

    def stats(self) -> Dict[str, Any]:
        return {
            "resident": len(self._entries),
            "resident_bytes": self.resident_bytes,
            "budget_bytes": self.budget_bytes,
            "evictions": self.evictions,
            "hits": self.hits,
            "misses": self.misses,
            "leases_active": self.leases_active,
            "lease_blocked_evictions": self.lease_blocked,
            "adapters": {aid: {"bytes": e.nbytes, "version": e.version, "hits": e.hits, "source": e.source}
                         for aid, e in self._entries.items()},
        }
