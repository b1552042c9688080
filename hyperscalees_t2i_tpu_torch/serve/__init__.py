"""Multi-tenant LoRA serving over one resident frozen base.

- ``engine``        — :class:`ServeEngine` / :class:`ServeConfig`;
- ``adapter_store`` — :class:`AdapterStore`: LRU-by-bytes resident adapters;
- ``batcher``       — request queue + geometry-keyed coalescing.
"""

from .adapter_store import AdapterStore, adapter_bytes, adapter_digest, validate_adapter_tree
from .batcher import QueueFullError, RequestQueue, ServeRequest, ServeResult
from .engine import ServeConfig, ServeEngine

__all__ = [
    "AdapterStore",
    "QueueFullError",
    "RequestQueue",
    "ServeConfig",
    "ServeEngine",
    "ServeRequest",
    "ServeResult",
    "adapter_bytes",
    "adapter_digest",
    "validate_adapter_tree",
]
