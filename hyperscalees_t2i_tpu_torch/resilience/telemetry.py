"""The process-global ``resilience/*`` registry (port of
``hyperscalees_t2i_tpu/resilience/telemetry.py`` without the per-host
snapshot files, which come with multi-process training).

Any resilience layer can tick it without a handle being passed down; the
serving tier's exporter renders it beside the engine's registry. Standard
library only.
"""

from __future__ import annotations

from typing import Any, Optional

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
