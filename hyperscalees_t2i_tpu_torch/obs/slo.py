"""Declarative SLOs and multi-window burn-rate alerts over streaming
telemetry (a copy of ``hyperscalees_t2i_tpu/obs/slo.py``; standard
library only).

``latency_p95=2s,availability=99.9`` declares objectives; each
:meth:`SloEvaluator.tick` samples their sources (a latency histogram, or
error and total counters) and keeps, per objective:

- ``slo/*`` gauges on the evaluator's own registry: the fast- and
  slow-window burn rates and an alert flag (the exporter renders them);
- a loud stderr line and one JSON liveness line when an alert fires or
  clears;
- ``slo_alerts`` on the ``/healthz`` blackboard.

An objective with error budget *b* (availability 99.9% → b = 0.1%;
latency_p95 → 5% of requests may exceed the threshold) burns at
``(bad/total)/b``. The alert fires only while both the fast window
(default 5 min) and the slow window (default 1 h) burn at or above the
threshold (default 14.4: 2% of a 30-day budget in one hour).
:func:`build_serve_evaluator` wires a serving engine's registry;
:func:`build_trainer_evaluator` a training run's.
"""

from __future__ import annotations

import dataclasses
import re
import sys
import time
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.stats import window_anchor_index
from .heartbeat import emit_heartbeat
from .metrics import MetricsRegistry

# () -> (bad_events_cumulative, total_events_cumulative)
SloSource = Callable[[], Tuple[float, float]]

DEFAULT_ALERT_BURN = 14.4  # 2% of a 30-day budget in 1h (SRE workbook)


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declared objective. ``budget`` is the error-budget fraction:
    the allowed share of bad events (requests over the latency threshold,
    or failed requests)."""

    name: str  # "latency_p95", "availability"
    kind: str  # "latency" | "availability"
    budget: float
    quantile: float = 0.0  # latency only: 0.95 for latency_p95
    threshold_s: float = 0.0  # latency only
    target: float = 0.0  # availability only (fraction, 0.999)


_DUR = re.compile(r"^([0-9.]+)\s*(ms|s|m|h)?$")
_LAT = re.compile(r"^latency_p(\d{1,2}(?:\.\d+)?)$")


def parse_duration_s(s: str) -> float:
    m = _DUR.match(s.strip().lower())
    if m is None:
        raise ValueError(f"unparseable duration {s!r} (want e.g. 2s, 500ms)")
    mult = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, None: 1.0}[m.group(2)]
    return float(m.group(1)) * mult


def parse_slos(spec: str) -> List[SloSpec]:
    """``"latency_p95=2s,availability=99.9"`` → specs. Latency objectives
    carry their budget in the percentile itself (p95 → 5% of requests may
    exceed the threshold); availability is a percentage target."""
    out: List[SloSpec] = []
    for tok in filter(None, (t.strip() for t in spec.split(","))):
        key, eq, val = tok.partition("=")
        if not eq:
            raise ValueError(f"SLO token {tok!r} is not name=value")
        key = key.strip().lower()
        lat = _LAT.match(key)
        if lat:
            q = float(lat.group(1)) / 100.0
            if not 0.0 < q < 1.0:
                raise ValueError(f"latency percentile out of range in {tok!r}")
            out.append(SloSpec(
                name=key, kind="latency", budget=1.0 - q, quantile=q,
                threshold_s=parse_duration_s(val),
            ))
        elif key == "availability":
            target = float(val) / 100.0
            if not 0.0 < target < 1.0:
                raise ValueError(f"availability target out of range in {tok!r}")
            out.append(SloSpec(
                name=key, kind="availability", budget=1.0 - target,
                target=target,
            ))
        else:
            raise ValueError(
                f"unknown SLO {key!r} (supported: latency_pNN=<dur>, "
                "availability=<pct>)"
            )
    if not out:
        raise ValueError(f"no objectives in SLO spec {spec!r}")
    return out


def latency_source(
    registry: MetricsRegistry, histogram_name: str, threshold_s: float
) -> SloSource:
    """Bad/total from a streaming histogram: bad = samples above the
    threshold, with the threshold rounded UP to its containing bucket edge
    (one-bucket resolution — the same contract as percentile recovery)."""

    def read() -> Tuple[float, float]:
        h = registry.histogram(histogram_name)
        cum = h.cumulative()
        if not h.count:
            return 0.0, 0.0
        # cum has len(bounds)+1 entries (+Inf last), so a threshold beyond
        # the layout resolves to the +Inf bucket: NOTHING is provably bad
        # (rounding the threshold UP, the one-bucket-resolution contract —
        # clamping DOWN would misclassify in-SLO samples as violations)
        idx = bisect_left(h.bounds, float(threshold_s))
        good = cum[idx]
        return float(h.count - good), float(h.count)

    return read


def counter_source(
    total_registry: MetricsRegistry,
    total_name: str,
    error_registry: MetricsRegistry,
    error_name: str,
) -> SloSource:
    """Bad/total from two monotonic counters (possibly in different
    registries — e.g. obs ``epochs_dispatched`` vs resilience
    ``rollbacks``)."""

    def read() -> Tuple[float, float]:
        return (
            float(error_registry.value(error_name, 0.0)),
            float(total_registry.value(total_name, 0.0)),
        )

    return read


class SloEvaluator:
    """Samples the sources each :meth:`tick` and maintains windowed burn
    rates + the alert latch per objective.

    ``clock`` is injectable (tests drive time explicitly); the default is
    the monotonic clock so NTP steps can't fabricate a burn. Gauges land on
    :attr:`registry` (prefix ``slo/``) — the integrator merges/export it
    like any other registry.
    """

    # history hard cap per objective (older half decimates past this):
    # bounds memory when ticks outpace the slow-window prune
    _MAX_SAMPLES = 8192

    def __init__(
        self,
        slos: Sequence[SloSpec],
        sources: Dict[str, SloSource],
        *,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        alert_burn: float = DEFAULT_ALERT_BURN,
        clock: Callable[[], float] = time.monotonic,
        stream: Any = None,
    ):
        missing = [s.name for s in slos if s.name not in sources]
        if missing:
            raise ValueError(f"no telemetry source wired for SLOs: {missing}")
        self.slos = list(slos)
        self.sources = dict(sources)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.alert_burn = float(alert_burn)
        self.clock = clock
        self.stream = stream  # None → sys.stderr at emit time (test-friendly)
        self.registry = MetricsRegistry(prefix="slo/")
        # per-slo sample history, time-ordered, with a PARALLEL timestamp
        # list so window anchors resolve by bisect — a per-dispatch tick
        # rate must not make tick() cost grow with the window (a linear
        # anchor scan over an hour of 7 ms ticks would exceed the step
        # time it is measuring)
        self._history: Dict[str, List[Tuple[float, float, float]]] = {
            s.name: [] for s in self.slos
        }
        self._times: Dict[str, List[float]] = {s.name: [] for s in self.slos}
        self._alerting: Dict[str, bool] = {s.name: False for s in self.slos}

    # -- math ----------------------------------------------------------------
    def _window_burn(
        self, name: str, now: float, window_s: float, budget: float,
    ) -> Optional[float]:
        """Burn rate over [now - window, now]: Δbad/Δtotal normalized by the
        budget, anchored at the newest sample at-or-before the window start
        (or the oldest available — a short history reports over what
        exists, it never invents a denominator). Anchor lookup is the shared
        ``utils/stats.window_anchor_index`` bisect, O(log n) per call."""
        hist, ts = self._history[name], self._times[name]
        if not hist:
            return None
        _t_now, bad_now, tot_now = hist[-1]
        anchor = hist[window_anchor_index(ts, now - window_s)]
        d_total = tot_now - anchor[2]
        if d_total <= 0:
            return None
        d_bad = max(bad_now - anchor[1], 0.0)
        return (d_bad / d_total) / budget

    # -- the per-epoch / per-dispatch hook ----------------------------------
    def tick(self) -> Dict[str, Any]:
        """Sample every source, update gauges, fire/clear alerts. Returns
        the gauge dict (bare names) for callers that want it inline."""
        now = self.clock()
        out: Dict[str, Any] = {}
        for spec in self.slos:
            try:
                bad, total = self.sources[spec.name]()
            except Exception:
                continue  # telemetry failure must never take down the run
            hist, ts = self._history[spec.name], self._times[spec.name]
            hist.append((now, float(bad), float(total)))
            ts.append(now)
            # prune past the slow window (keep one older sample as anchor)
            cut = window_anchor_index(ts, now - self.slow_window_s)
            if cut > 0:
                del hist[:cut]
                del ts[:cut]
            # hard cap: decimate the older half when a per-dispatch tick
            # rate outpaces the window prune — anchors coarsen (older
            # samples thin to half resolution), memory stays bounded
            if len(hist) > self._MAX_SAMPLES:
                hist[: len(hist) // 2] = hist[: len(hist) // 2 : 2]
                ts[: len(ts) // 2] = ts[: len(ts) // 2 : 2]
            fast = self._window_burn(spec.name, now, self.fast_window_s,
                                     spec.budget)
            slow = self._window_burn(spec.name, now, self.slow_window_s,
                                     spec.budget)
            firing = (
                fast is not None and slow is not None
                and fast >= self.alert_burn and slow >= self.alert_burn
            )
            reg = self.registry
            if fast is not None:
                reg.gauge(f"{spec.name}_burn_fast", round(fast, 4))
                out[f"{spec.name}_burn_fast"] = fast
            if slow is not None:
                reg.gauge(f"{spec.name}_burn_slow", round(slow, 4))
                out[f"{spec.name}_burn_slow"] = slow
            reg.gauge(f"{spec.name}_alert", 1 if firing else 0)
            out[f"{spec.name}_alert"] = 1 if firing else 0
            was = self._alerting[spec.name]
            if firing and not was:
                reg.inc(f"{spec.name}_alerts")
                self._transition("ALERT", spec, fast, slow)
            elif was and not firing:
                self._transition("CLEAR", spec, fast, slow)
            self._alerting[spec.name] = firing
        self._note_health()
        return out

    def _transition(
        self, kind: str, spec: SloSpec, fast: Optional[float],
        slow: Optional[float],
    ) -> None:
        detail = (
            f"p{spec.quantile * 100:g} > {spec.threshold_s:g}s"
            if spec.kind == "latency"
            else f"target {spec.target * 100:g}%"
        )
        print(
            f"[slo] {kind}: {spec.name} ({detail}) burn rates "
            f"fast={fast if fast is None else round(fast, 2)} "
            f"slow={slow if slow is None else round(slow, 2)} "
            f"(threshold {self.alert_burn:g}; budget {spec.budget:.4g})",
            file=self.stream or sys.stderr, flush=True,
        )
        emit_heartbeat(
            "slo", "burn_alert" if kind == "ALERT" else "burn_clear",
            stream=self.stream, slo=spec.name, burn_fast=fast, burn_slow=slow,
            alert_threshold=self.alert_burn,
        )

    def _note_health(self) -> None:
        from .exporter import note_health

        note_health(slo_alerts={
            name: bool(v) for name, v in self._alerting.items()
        })

    def max_burn(self, window: str = "fast") -> Optional[float]:
        """Worst current burn rate across objectives for ``window`` ("fast"
        / "slow"); None before any burn is computable. The serve overload
        layer's SLO pressure signal (serve/overload.py) — one number that
        answers "is ANY budget burning", read from the gauges tick()
        already maintains."""
        vals = [
            v for v in (
                self.registry.value(f"{s.name}_burn_{window}", None)
                for s in self.slos
            ) if v is not None
        ]
        return max(vals) if vals else None

    @property
    def alerting(self) -> Dict[str, bool]:
        return dict(self._alerting)


def build_trainer_evaluator(
    spec: str,
    registry: MetricsRegistry,
    resilience_registry: MetricsRegistry,
    **kwargs: Any,
) -> SloEvaluator:
    """Trainer wiring: latency objectives read the ``train_step_time_
    seconds`` histogram; availability reads dispatched epochs vs rollbacks
    (an epoch that had to be rolled back was an epoch the run failed to
    deliver)."""
    slos = parse_slos(spec)
    sources: Dict[str, SloSource] = {}
    for s in slos:
        if s.kind == "latency":
            sources[s.name] = latency_source(
                registry, "train_step_time_seconds", s.threshold_s
            )
        else:
            sources[s.name] = counter_source(
                registry, "epochs_dispatched",
                resilience_registry, "rollbacks",
            )
    return SloEvaluator(slos, sources, **kwargs)


def serve_availability_source(registry: MetricsRegistry) -> SloSource:
    """Bad/total for serve availability. ``serve_requests`` counts only
    *successfully served* requests (engine increments it post-dispatch), so
    the denominator must be ATTEMPTS = served + errored — with served alone
    as the total, a 100%-error outage would hold Δtotal at 0 and the burn
    rate at None, making the availability SLO structurally blind to the
    exact condition it exists to page on."""

    def read() -> Tuple[float, float]:
        err = float(registry.value("serve_request_errors", 0.0))
        ok = float(registry.value("serve_requests", 0.0))
        return err, ok + err

    return read


def build_serve_evaluator(
    spec: str, registry: MetricsRegistry, **kwargs: Any
) -> SloEvaluator:
    """Serve wiring: latency objectives read the ``serve_request_latency_
    seconds`` histogram; availability reads errored vs attempted requests
    (:func:`serve_availability_source`)."""
    slos = parse_slos(spec)
    sources: Dict[str, SloSource] = {}
    for s in slos:
        if s.kind == "latency":
            sources[s.name] = latency_source(
                registry, "serve_request_latency_seconds", s.threshold_s
            )
        else:
            sources[s.name] = serve_availability_source(registry)
    return SloEvaluator(slos, sources, **kwargs)


__all__ = [
    "DEFAULT_ALERT_BURN",
    "SloEvaluator",
    "SloSpec",
    "build_serve_evaluator",
    "build_trainer_evaluator",
    "counter_source",
    "latency_source",
    "parse_duration_s",
    "parse_slos",
    "serve_availability_source",
]
