"""Multi-tenant LoRA serving over one resident frozen base.

- ``engine``        — :class:`ServeEngine` / :class:`ServeConfig`;
- ``adapter_store`` — :class:`AdapterStore`: LRU-by-bytes resident adapters
  with residency leases;
- ``batcher``       — request queue + geometry-keyed coalescing;
- ``admission``     — the fit gate (:class:`ServeAdmissionError`) and the
  overload layer's typed refusal (:class:`ServeShedError`);
- ``overload``      — deadlines, the brownout ladder and the per-adapter
  circuit breaker (:class:`OverloadConfig`, :class:`OverloadGovernor`).
"""

from .adapter_store import AdapterStore, adapter_bytes, adapter_digest, validate_adapter_tree
from .admission import ServeAdmissionError, ServeShedError, check_fit, parse_serve_geometry, resolve_hbm_budget
from .batcher import QueueFullError, RequestQueue, ServeRequest, ServeResult
from .engine import ServeConfig, ServeEngine
from .overload import OverloadConfig, OverloadGovernor

__all__ = [
    "AdapterStore",
    "OverloadConfig",
    "OverloadGovernor",
    "QueueFullError",
    "RequestQueue",
    "ServeAdmissionError",
    "ServeConfig",
    "ServeEngine",
    "ServeRequest",
    "ServeResult",
    "ServeShedError",
    "adapter_bytes",
    "adapter_digest",
    "check_fit",
    "parse_serve_geometry",
    "resolve_hbm_budget",
    "validate_adapter_tree",
]
