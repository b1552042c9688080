"""Live pull telemetry: ``/metrics`` (Prometheus text) and ``/healthz``
(JSON) on a daemon thread (a copy of ``hyperscalees_t2i_tpu/obs/
exporter.py`` for one process; standard library only).

- ``GET /metrics``: every counter and gauge of the wired registries, every
  streaming :class:`~.metrics.Histogram` as ``_bucket``/``_sum``/``_count``
  series, plus the scalar sources' values (labeled series such as the
  hot-adapter top-K render as one name with bounded labels);
- ``GET /healthz``: one JSON object, the process-global health blackboard
  (:func:`note_health` and friends) plus the health source's payload (the
  serving engine's queue, occupancy and pressure view).

The exporter only reads registry snapshots under their locks; it never
touches a program. A port already in use raises at
:meth:`MetricsExporter.start`. ``port=0`` binds an ephemeral port.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .metrics import MetricsRegistry, is_histogram_payload

# ---------------------------------------------------------------------------
# process-global health blackboard (fed by the SLO evaluator and serving)
# ---------------------------------------------------------------------------

_HEALTH_LOCK = threading.Lock()
_HEALTH: Dict[str, Any] = {}


def note_health(**kv: Any) -> None:
    """Merge keys into the process-global health blackboard (what
    ``/healthz`` reports). ``None`` values delete the key."""
    with _HEALTH_LOCK:
        for k, v in kv.items():
            if v is None:
                _HEALTH.pop(k, None)
            else:
                _HEALTH[k] = v


def note_heartbeat(payload: Dict[str, Any]) -> None:
    """Record the latest heartbeat line (called by ``emit_heartbeat`` on
    every emission — liveness on ``/healthz`` is exactly the stderr
    heartbeat stream, re-exposed)."""
    entry = {**payload, "wall_time": time.time()}
    with _HEALTH_LOCK:
        _HEALTH["last_heartbeat"] = entry
        if payload.get("stalled"):
            _HEALTH["last_stall"] = entry


def note_stall(active: bool, payload: Optional[Dict[str, Any]] = None) -> None:
    """Stall watchdog state: set when a heartbeat-wrapped phase exceeds its
    cap, cleared when that phase finally completes (``Heartbeat.__exit__``).
    ``/healthz`` flips ``status`` to ``"stalled"`` while active."""
    with _HEALTH_LOCK:
        _HEALTH["stall_active"] = bool(active)
        if payload is not None:
            _HEALTH["last_stall"] = {**payload, "wall_time": time.time()}


def note_anomaly(event: Dict[str, Any], keep: int = 8) -> None:
    """Ring the most recent anomaly-watchdog events (obs/anomaly.py) on the
    blackboard: ``/healthz`` answers "is this run healthy" with the last
    ``keep`` events (phase/metric/severity) without a file read."""
    entry = {**event, "wall_time": time.time()}
    with _HEALTH_LOCK:
        lst = _HEALTH.setdefault("anomalies", [])
        lst.append(entry)
        del lst[:-int(keep)]


def health_snapshot() -> Dict[str, Any]:
    with _HEALTH_LOCK:
        snap = dict(_HEALTH)
        if "anomalies" in snap:
            snap["anomalies"] = list(snap["anomalies"])
        return snap


def reset_health() -> None:
    """Fresh blackboard (per-run installs, tests)."""
    with _HEALTH_LOCK:
        _HEALTH.clear()


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([+-]?(?:[0-9.eE+-]+|[Nn]a[Nn]|[+-]?[Ii]nf))$"
)


def sanitize_metric_name(name: str) -> str:
    """Registry names (``serve/queue_depth``, ``es/finite_frac``) → valid
    Prometheus metric names (``serve_queue_depth``, ``es_finite_frac``)."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


def is_labeled_payload(v: Any) -> bool:
    """A labeled-series scalar payload: ``{"labeled": [(labels, value),
    ...]}`` — ONE metric name fanning out to a bounded set of labeled
    samples (the hot-adapter series ``serve_adapter_hotness{adapter="..."}``). The scalar-source analogue
    of ``is_histogram_payload``; anything else renders as a plain scalar."""
    return (
        isinstance(v, dict)
        and isinstance(v.get("labeled"), (list, tuple))
    )


def _escape_label_value(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: Any) -> Optional[str]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    # exposition format has NaN/±Inf literals; a non-finite gauge (a NaN
    # reward during a divergence — exactly when live telemetry matters)
    # must render as one, never crash the whole scrape
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if f != int(f) else str(int(f))


def render_prometheus(
    counters: Dict[str, Any],
    gauges: Dict[str, Any],
    histograms: Dict[str, Dict[str, Any]],
) -> str:
    """One exposition-format document. Scalar values that aren't
    float-convertible (string gauges like roofline verdicts) are skipped —
    the scrape must parse, not carry everything."""
    lines: List[str] = []

    def scalars(items: Dict[str, Any], typ: str) -> None:
        for name in sorted(items):
            v = items[name]
            pname = sanitize_metric_name(name)
            if is_labeled_payload(v):
                # one name, bounded labeled fan-out (hot-adapter top-K):
                # skip unrenderable samples, not the whole series
                sample_lines = []
                for sample in v["labeled"]:
                    try:
                        labels, value = sample
                    except (TypeError, ValueError):
                        continue
                    val = _fmt_value(value)
                    if val is None or not isinstance(labels, dict):
                        continue
                    lstr = ",".join(
                        f'{sanitize_metric_name(str(k))}='
                        f'"{_escape_label_value(lv)}"'
                        for k, lv in sorted(labels.items())
                    )
                    sample_lines.append(f"{pname}{{{lstr}}} {val}")
                if sample_lines:
                    lines.append(f"# TYPE {pname} {typ}")
                    lines.extend(sample_lines)
                continue
            val = _fmt_value(v)
            if val is None:
                continue
            lines.append(f"# TYPE {pname} {typ}")
            lines.append(f"{pname} {val}")

    scalars(counters, "counter")
    scalars(gauges, "gauge")
    for name in sorted(histograms):
        h = histograms[name]
        if not is_histogram_payload(h):
            continue
        pname = sanitize_metric_name(name)
        lines.append(f"# TYPE {pname} histogram")
        le = list(h["le"])
        buckets = list(h["buckets"])
        for edge, c in zip(le, buckets):
            lines.append(f'{pname}_bucket{{le="{edge:g}"}} {int(c)}')
        # counts are cumulative, so the last entry is the +Inf total
        lines.append(f'{pname}_bucket{{le="+Inf"}} {int(buckets[-1]) if buckets else 0}')
        lines.append(f"{pname}_sum {repr(float(h['sum']))}")
        lines.append(f"{pname}_count {int(h['count'])}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(
    text: str,
) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Minimal exposition-format parser: ``{name: [(labels, value), ...]}``.
    Raises ``ValueError`` on any malformed non-comment line — the round-trip
    validity check tests and CI scrape assertions rely on."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if m is None:
            raise ValueError(f"malformed Prometheus exposition line: {raw!r}")
        name, labelpart, value = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if labelpart:
            for pair in filter(None, labelpart[1:-1].split(",")):
                k, _, v = pair.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        out.setdefault(name, []).append((labels, float(value)))
    return out


# ---------------------------------------------------------------------------
# the exporter itself
# ---------------------------------------------------------------------------

ScalarSource = Callable[[], Dict[str, Any]]
HealthSource = Callable[[], Dict[str, Any]]


class MetricsExporter:
    """Pull endpoint on a daemon thread. ``port=0`` binds an ephemeral port
    (tests); read :attr:`port` after :meth:`start` for the bound value.

    >>> exp = MetricsExporter(9100, registries=[get_registry()])
    >>> exp.start()          # raises OSError if the port is taken
    >>> ...                  # curl :9100/metrics  /  :9100/healthz
    >>> exp.stop()
    """

    def __init__(
        self,
        port: int,
        host: str = "0.0.0.0",
        registries: Iterable[MetricsRegistry] = (),
        scalar_sources: Iterable[ScalarSource] = (),
        healthz_source: Optional[HealthSource] = None,
    ):
        self.requested_port = int(port)
        self.host = host
        self.registries = list(registries)
        self.scalar_sources = list(scalar_sources)
        self.healthz_source = healthz_source
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- payloads ------------------------------------------------------------
    def render_metrics(self) -> str:
        counters: Dict[str, Any] = {}
        gauges: Dict[str, Any] = {}
        histograms: Dict[str, Dict[str, Any]] = {}
        for reg in self.registries:
            exp = reg.export()
            counters.update(exp["counters"])
            gauges.update(exp["gauges"])
            histograms.update(exp["histograms"])
        for source in self.scalar_sources:
            try:
                extra = source() or {}
            except Exception:
                continue  # a broken source must not break the scrape
            for k, v in extra.items():
                if is_histogram_payload(v):
                    histograms[k] = v
                else:
                    gauges[k] = v
        return render_prometheus(counters, gauges, histograms)

    def healthz(self) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "status": "ok",
            "wall_time": time.time(),
            "process_index": 0,
        }
        payload.update(health_snapshot())
        if payload.get("stall_active"):
            payload["status"] = "stalled"
        if self.healthz_source is not None:
            try:
                payload.update(self.healthz_source() or {})
            except Exception as e:
                payload["healthz_source_error"] = repr(e)
        return payload

    # -- lifecycle -----------------------------------------------------------
    @property
    def port(self) -> int:
        return (
            self._server.server_address[1]
            if self._server is not None
            else self.requested_port
        )

    def start(self) -> "MetricsExporter":
        """Bind + serve on a daemon thread. Raises ``OSError`` when the port
        is already in use — refusal, never a silent rebind."""
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        body = exporter.render_metrics().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path in ("/healthz", "/health"):
                        body = (
                            json.dumps(exporter.healthz(), default=str) + "\n"
                        ).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404, "try /metrics or /healthz")
                        return
                except Exception as e:  # a broken snapshot must answer 500,
                    self.send_error(500, repr(e))  # not kill the thread
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a: Any) -> None:
                pass  # scrape chatter must never hit stderr (heartbeats own it)

        self._server = ThreadingHTTPServer(
            (self.host, self.requested_port), Handler
        )
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"metrics-exporter:{self.port}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def maybe_exporter(
    port: int, **kwargs: Any
) -> Optional[MetricsExporter]:
    """Started exporter when ``port`` is truthy, else ``None`` — call sites
    stay unconditional (mirrors ``maybe_heartbeat``)."""
    if not port:
        return None
    return MetricsExporter(port, **kwargs).start()


__all__ = [
    "MetricsExporter",
    "health_snapshot",
    "is_labeled_payload",
    "maybe_exporter",
    "note_anomaly",
    "note_health",
    "note_heartbeat",
    "note_stall",
    "parse_prometheus_text",
    "render_prometheus",
    "reset_health",
    "sanitize_metric_name",
]
