"""Observability: spans, heartbeats, metrics, the program ledger and the
device-time join (port of ``hyperscalees_t2i_tpu/obs/__init__.py``).

- ``trace``: nested host-side spans → ``trace.jsonl``, the process's tracer
  and span observer, Chrome-trace export;
- ``heartbeat``: liveness lines on stderr during long phases, with a stall
  watchdog;
- ``metrics``: counters, gauges and streaming histograms, merged into
  ``metrics.jsonl`` rows; ``exporter`` serves them on ``/metrics`` and
  ``/healthz``;
- ``multihost``: process identity for every writer (per-process trace
  segments, process-0-only shared files);
- ``podtrace``: the pod flight recorder over per-process trace segments;
  ``anomaly``: the ES-health anomaly watchdog;
- ``program_cost``: the per-program ledger (``programs.jsonl``) and the
  roofline, the JAX ``xla_cost``'s counterpart; ``profile_trace``: the
  ``torch.profiler`` trace reader and its join onto the ledger, the JAX
  ``xplane``'s; ``calib``: measured against predicted step times.

The JAX names with no counterpart here are the ``.xplane.pb`` readers
(``build_xspace``, ``device_planes``, ``find_xplane_files``,
``load_xspace``, ``parse_xspace``) and the XLA compile records
(``compile_cache_entries``, ``program_record``, ``record_compile``).

Importing this package imports no torch: the runner's parent imports
``obs.heartbeat`` and ``obs.metrics`` and must stay torch-free. The names
of ``program_cost`` (which imports torch) and of ``profile_trace`` resolve
at first use (PEP 562), and ``es_health``, ``quality``, ``regress`` and
``slo`` are imported by their module names, as in the JAX package.
"""

from .anomaly import AnomalyWatchdog, load_anomalies
from .calib import calib_gauges, calibrate_run, load_calib, predicted_step_time_s, reconcile, write_calib
from .exporter import (
    MetricsExporter,
    maybe_exporter,
    note_anomaly,
    note_health,
    parse_prometheus_text,
    render_prometheus,
    reset_health,
)
from .heartbeat import Heartbeat, device_memory_gauges, emit_heartbeat, maybe_heartbeat
from .metrics import (
    DEFAULT_BUCKETS,
    Histogram,
    MetricsRegistry,
    get_registry,
    is_histogram_payload,
    record_device_memory,
    set_registry,
)
from .multihost import (
    exporter_port,
    is_primary,
    profile_segment_path,
    safe_process_index,
    set_process_index_override,
    trace_segment_path,
)
from .podtrace import discover_trace_segments, load_pod_events, pod_gauges, pod_summary, write_pod_summary
from .trace import Tracer, get_tracer, load_events, set_span_observer, set_tracer, span, to_chrome, traced

# name -> the module that holds it, imported at the name's first use
_LAZY = {
    **dict.fromkeys(("ProgramLedger", "get_ledger", "load_programs", "note_program_geometry", "roofline",
                     "set_ledger"), "program_cost"),
    **dict.fromkeys(("join_ledger", "kernel_evidence", "op_durations", "program_durations"), "profile_trace"),
}

__all__ = sorted([
    "AnomalyWatchdog", "load_anomalies",
    "calib_gauges", "calibrate_run", "load_calib", "predicted_step_time_s", "reconcile", "write_calib",
    "MetricsExporter", "maybe_exporter", "note_anomaly", "note_health", "parse_prometheus_text",
    "render_prometheus", "reset_health",
    "Heartbeat", "device_memory_gauges", "emit_heartbeat", "maybe_heartbeat",
    "DEFAULT_BUCKETS", "Histogram", "MetricsRegistry", "get_registry", "is_histogram_payload",
    "record_device_memory", "set_registry",
    "exporter_port", "is_primary", "profile_segment_path", "safe_process_index", "set_process_index_override",
    "trace_segment_path",
    "discover_trace_segments", "load_pod_events", "pod_gauges", "pod_summary", "write_pod_summary",
    "Tracer", "get_tracer", "load_events", "set_span_observer", "set_tracer", "span", "to_chrome", "traced",
    *_LAZY,
])


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
