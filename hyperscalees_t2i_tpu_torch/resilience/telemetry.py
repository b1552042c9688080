"""The process-global ``resilience/*`` registry and the host snapshot that
``/healthz`` serves (port of ``hyperscalees_t2i_tpu/resilience/telemetry.py``
without the per-host snapshot files, which come with multi-process
training).

Any resilience layer can tick it without a handle being passed down; the
serving tier's exporter renders it beside the engine's registry. Standard
library only.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ..obs.metrics import MetricsRegistry

_REGISTRY = MetricsRegistry(prefix="resilience/")


def get_resilience_registry() -> MetricsRegistry:
    return _REGISTRY


def set_resilience_registry(registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Install the process-global resilience registry (``None``: a fresh
    one); returns it."""
    global _REGISTRY
    _REGISTRY = registry if registry is not None else MetricsRegistry(prefix="resilience/")
    return _REGISTRY


def inc(name: str, n: float = 1) -> None:
    _REGISTRY.inc(name, n)


def gauge(name: str, value: Any) -> None:
    _REGISTRY.gauge(name, value)


def host_snapshot_payload(*, epoch: Optional[int] = None, extra: Optional[Dict[str, Any]] = None,
                          registry: Optional[MetricsRegistry] = None) -> Dict[str, Any]:
    """This process's resilience summary, the JAX payload's keys: process
    identity (one process: index 0), the wall time, and every counter and
    gauge of ``registry`` (default: the process-global one)."""
    return {
        "process_index": 0,
        "wall_time": time.time(),
        **({"epoch": int(epoch)} if epoch is not None else {}),
        **(extra or {}),
        **(registry if registry is not None else _REGISTRY).snapshot(),
    }
