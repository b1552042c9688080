"""The process-global ``resilience/*`` registry, the host snapshot that
``/healthz`` serves and its per-process file ``resilience.host<i>.json``
(port of ``hyperscalees_t2i_tpu/resilience/telemetry.py``).

Any resilience layer can tick it without a handle being passed down; the
serving tier's exporter renders it beside the engine's registry. Standard
library only.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union

from ..obs.metrics import MetricsRegistry
from ..obs.multihost import safe_process_index

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
    identity (``obs.multihost.safe_process_index``), the wall time, and
    every counter and gauge of ``registry`` (default: the process-global
    one)."""
    return {
        "process_index": safe_process_index(),
        "wall_time": time.time(),
        **({"epoch": int(epoch)} if epoch is not None else {}),
        **(extra or {}),
        **(registry if registry is not None else _REGISTRY).snapshot(),
    }


def host_snapshot_path(run_dir: Union[str, Path], process_index: int) -> Path:
    return Path(run_dir) / f"resilience.host{int(process_index)}.json"


def write_host_snapshot(run_dir: Union[str, Path], *, epoch: Optional[int] = None,
                        extra: Optional[Dict[str, Any]] = None, registry: Optional[MetricsRegistry] = None) -> None:
    """This process's summary (:func:`host_snapshot_payload`) as
    ``run_dir/resilience.host<i>.json``, written to a temporary file and
    moved into place. ``metrics.jsonl`` is process 0's, so these files are
    where every other process's ``resilience/*`` counters can be read. A
    failed write warns and never stops the run."""
    payload = host_snapshot_payload(epoch=epoch, extra=extra, registry=registry)
    path = host_snapshot_path(run_dir, payload["process_index"])
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(payload, indent=2, default=str))
        os.replace(tmp, path)
    except OSError as e:
        print(f"[resilience] WARNING: host snapshot write failed ({e!r})", file=sys.stderr, flush=True)
