"""Counters, gauges and streaming histograms merged into ``metrics.jsonl``
rows and rendered on ``/metrics`` (port of
``hyperscalees_t2i_tpu/obs/metrics.py``).

``run_training`` makes one :class:`MetricsRegistry` per run under the
``obs/`` prefix and one under ``resilience/``, and passes them to what
ticks them; a ``ServeEngine`` keeps its own (``engine.registry``).
:func:`get_registry`/:func:`set_registry` hold the process-global one, as
in the JAX package, for callers without a handle. :meth:`MetricsRegistry.
export` is the typed view the exporter renders and :meth:`MetricsRegistry.
value` the cheap read the SLO evaluator polls. Stdlib only, apart from
:func:`record_device_memory`.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# log-spaced latency buckets (seconds), 1 ms → ~131 s, factor 2: the JAX
# package's layout, so histograms from both packages merge bucket for bucket
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(0.001 * 2 ** i for i in range(18))


class Histogram:
    """Fixed-layout streaming histogram with Prometheus ``le`` semantics:
    bucket ``i`` counts samples ``<= bounds[i]``, one +Inf bucket last,
    plus ``sum`` and ``count``. Not thread-safe alone; the registry
    serializes :meth:`observe`."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        self.counts[bisect.bisect_left(self.bounds, v)] += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def to_dict(self) -> Dict[str, Any]:
        """The JSONL form: cumulative counts under the fixed layout."""
        return {"hist": "le", "le": list(self.bounds), "buckets": self.cumulative(),
                "sum": self.sum, "count": self.count}

    def quantile(self, q: float) -> float:
        from ..utils.stats import histogram_quantile

        return histogram_quantile(self.bounds, self.cumulative(), q)


def is_histogram_payload(v: Any) -> bool:
    """True for a :meth:`Histogram.to_dict` value (readers must not take it
    for a scalar)."""
    return isinstance(v, dict) and v.get("hist") == "le" and "buckets" in v


class MetricsRegistry:
    """Thread-safe named counters, gauges and histograms; :meth:`snapshot`
    gives ``{prefix + name: value}`` for a ``metrics.jsonl`` row."""

    def __init__(self, prefix: str = "obs/"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}
        self._histograms: Dict[str, Histogram] = {}

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value: float) -> None:
        with self._lock:
            cur = self._gauges.get(name)
            if cur is None or value > cur:
                self._gauges[name] = value

    def histogram(self, name: str, bounds: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        """The named histogram, made on first use (``bounds`` applies only
        then)."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(bounds)
            return h

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            h.observe(value)

    def value(self, name: str, default: Any = 0.0) -> Any:
        """A counter's or gauge's value by its bare name (counters first;
        ``default`` when neither exists)."""
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, default)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {f"{self.prefix}{k}": v for k, v in self._counters.items()}
            out.update({f"{self.prefix}{k}": v for k, v in self._gauges.items() if v is not None})
            out.update({f"{self.prefix}{k}": h.to_dict() for k, h in self._histograms.items() if h.count})
        return out

    def export(self) -> Dict[str, Dict[str, Any]]:
        """The exporter's typed view: counters and gauges under their
        prefixed names, histograms under their bare names (``serve_request_
        latency_seconds``)."""
        with self._lock:
            return {
                "counters": {f"{self.prefix}{k}": v for k, v in self._counters.items()},
                "gauges": {f"{self.prefix}{k}": v for k, v in self._gauges.items() if v is not None},
                "histograms": {k: h.to_dict() for k, h in self._histograms.items()},
            }


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry (prefix ``obs/``)."""
    return _REGISTRY


def set_registry(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install the process-global registry (``None``: a fresh one); returns it."""
    global _REGISTRY
    _REGISTRY = registry if registry is not None else MetricsRegistry()
    return _REGISTRY


def record_device_memory(registry: MetricsRegistry, device: Any) -> None:
    """The card's allocated bytes (``device_bytes_in_use``) and its
    high-water mark (``device_peak_bytes_in_use``) from the caching
    allocator; nothing on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return
    registry.gauge("device_bytes_in_use", torch.cuda.memory_allocated(dev))
    registry.gauge_max("device_peak_bytes_in_use", torch.cuda.max_memory_allocated(dev))
