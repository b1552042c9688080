"""ES-health anomaly watchdog: robust changepoint detection over the
``es/*`` streams (port of ``hyperscalees_t2i_tpu/obs/anomaly.py``; standard
library only, host-side).

One tick per logged dispatch consumes the epoch scalars already read back
(no device work) and flags:

- ``es/update_cosine`` collapse (the update direction turning to noise);
- ``es/reward_std`` collapse (population spread dying, before
  ``es/fitness_zero`` shows it);
- ``es/pair_asym`` spike (antithetic pairs disagreeing: σ too large);
- ``es/cap_step_scale`` / ``es/cap_theta_scale`` saturation (a cap engaged
  for nearly every epoch of the window).

Detection is a rolling robust z-score (``utils.stats.robust_z``: the newest
value against the median/MAD of the prior window, with a floor) confirmed
over ``consecutive`` ticks, with ``utils.stats.changepoint_split`` recorded
when it fires. Below ``min_history`` values a rule stays silent.

Each ALERT and CLEAR takes four paths: a row of ``anomalies.jsonl`` in the
run dir (the file exists once something fired), ``anomaly/*`` gauges on the
watchdog's own registry (merged into ``metrics.jsonl`` and ``/metrics``),
a stderr line plus one heartbeat line, and the ``/healthz`` blackboard ring
(``obs.exporter.note_anomaly``).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, TextIO, Tuple, Union

from ..utils.jsonl import read_jsonl_rows
from ..utils.stats import changepoint_split, median, robust_z
from .exporter import note_anomaly
from .heartbeat import emit_heartbeat
from .metrics import MetricsRegistry

ANOMALIES_FILE = "anomalies.jsonl"


@dataclasses.dataclass(frozen=True)
class AnomalyRule:
    """One watched stream. ``kind`` names the failure mode in alerts;
    ``direction`` is the anomalous z sign (``"low"`` = collapse, ``"high"``
    = spike, ``"both"`` = any large shift). ``min_scale`` floors the robust
    scale so a near-constant healthy stream still scores a jump finitely
    (in the metric's own units)."""

    metric: str
    kind: str
    direction: str = "both"
    min_scale: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SaturationRule:
    """A level-based rule for the cap-engagement streams: anomalous when
    the value is past ``engaged_below`` for ≥ ``frac`` of a full window."""

    metric: str
    kind: str
    engaged_below: float = 1.0
    frac: float = 0.9


DEFAULT_RULES: Tuple[AnomalyRule, ...] = (
    AnomalyRule("es/update_cosine", "update_cosine_collapse",
                direction="low", min_scale=0.05),
    AnomalyRule("es/reward_std", "reward_std_collapse",
                direction="low", min_scale=1e-4),
    AnomalyRule("es/pair_asym", "pair_asym_spike",
                direction="high", min_scale=0.05),
)

DEFAULT_SATURATION_RULES: Tuple[SaturationRule, ...] = (
    SaturationRule("es/cap_step_scale", "cap_step_saturation"),
    SaturationRule("es/cap_theta_scale", "cap_theta_saturation"),
)


class AnomalyWatchdog:
    """Host-side tick over the per-epoch scalars dict.

    ``observe(epoch, scalars)`` feeds every rule its stream value, fires
    ALERT events (and later CLEAR events) through all four surfaces, and
    returns the events emitted this tick — the trainer merges
    ``registry.snapshot()`` into the same metrics payload afterwards.
    ``run_dir=None`` skips the file write but keeps gauges and stderr.
    """

    def __init__(
        self,
        run_dir: Optional[Union[str, Path]] = None,
        registry: Optional[MetricsRegistry] = None,
        rules: Tuple[AnomalyRule, ...] = DEFAULT_RULES,
        saturation_rules: Tuple[SaturationRule, ...] = DEFAULT_SATURATION_RULES,
        *,
        window: int = 32,
        min_history: int = 8,
        z_thresh: float = 8.0,
        consecutive: int = 2,
        clear_after: int = 3,
        stream: Optional[TextIO] = None,
    ):
        self.path = Path(run_dir) / ANOMALIES_FILE if run_dir is not None else None
        self.registry = registry if registry is not None else MetricsRegistry(
            prefix="anomaly/"
        )
        self.rules = tuple(rules)
        self.saturation_rules = tuple(saturation_rules)
        self.window = int(window)
        self.min_history = max(int(min_history), 2)
        self.z_thresh = float(z_thresh)
        self.consecutive = max(int(consecutive), 1)
        self.clear_after = max(int(clear_after), 1)
        self.stream = stream  # None → sys.stderr at emit time
        self._hist: Dict[str, deque] = {
            r.metric: deque(maxlen=self.window) for r in self.rules
        }
        self._sat_hist: Dict[str, deque] = {
            r.metric: deque(maxlen=self.window) for r in self.saturation_rules
        }
        self._bad_streak: Dict[str, int] = {}
        self._good_streak: Dict[str, int] = {}
        self._active: Dict[str, Dict[str, Any]] = {}  # kind -> firing event

    # -- emission paths ------------------------------------------------------
    def _emit(self, state: str, event: Dict[str, Any]) -> None:
        kind = event["kind"]
        print(
            f"[anomaly] {state}: {kind} on {event['metric']} at epoch "
            f"{event['epoch']} (value={event['value']:.6g}, "
            f"baseline={event['baseline']:.6g}, z={event['z']:.2f}, "
            f"severity={event['severity']})",
            file=self.stream or sys.stderr, flush=True,
        )
        emit_heartbeat(
            "anomaly", "alert" if state == "ALERT" else "clear",
            stream=self.stream, **{
                k: event[k] for k in
                ("kind", "metric", "epoch", "value", "z", "severity")
            },
        )
        try:
            note_anomaly({**event, "state": state})
        except Exception:
            pass  # blackboard failure must never cost the alert itself
        if self.path is not None:
            try:
                with self.path.open("a") as f:
                    f.write(json.dumps({**event, "state": state},
                                       default=str) + "\n")
            except OSError:
                pass  # observability must never kill the run

    def _fire(self, event: Dict[str, Any]) -> None:
        self._active[event["kind"]] = event
        self.registry.inc("alerts")
        self.registry.inc(f"alerts/{event['kind']}")
        self.registry.gauge(f"{event['kind']}_active", 1)
        self.registry.gauge("active", len(self._active))
        self._emit("ALERT", event)

    def _clear(self, kind: str, event: Dict[str, Any]) -> None:
        self._active.pop(kind, None)
        self.registry.gauge(f"{kind}_active", 0)
        self.registry.gauge("active", len(self._active))
        self._emit("CLEAR", event)

    # -- the per-logged-dispatch hook ---------------------------------------
    def observe(self, epoch: int, scalars: Dict[str, Any]) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        for rule in self.rules:
            v = scalars.get(rule.metric)
            if not isinstance(v, (int, float)):
                continue
            events.extend(self._observe_z(rule, epoch, float(v)))
        for rule in self.saturation_rules:
            v = scalars.get(rule.metric)
            if not isinstance(v, (int, float)):
                continue
            events.extend(self._observe_saturation(rule, epoch, float(v)))
        return events

    def _observe_z(
        self, rule: AnomalyRule, epoch: int, value: float
    ) -> List[Dict[str, Any]]:
        hist = self._hist[rule.metric]
        out: List[Dict[str, Any]] = []
        if len(hist) >= self.min_history:
            baseline = list(hist)
            center = median(baseline)
            floor = max(rule.min_scale, 0.05 * abs(center))
            z = robust_z(value, baseline, min_scale=floor)
            # clamp ±inf (degenerate MAD with a zero floor can't happen —
            # floor > 0 — but keep the JSON row finite regardless)
            z = max(min(z, 1e6), -1e6)
            self.registry.gauge(f"{rule.kind}_z", round(z, 4))
            bad = (
                (rule.direction in ("low", "both") and z <= -self.z_thresh)
                or (rule.direction in ("high", "both") and z >= self.z_thresh)
            )
            out.extend(self._latch(rule.kind, rule.metric, epoch, value,
                                   center, z, bad, baseline))
        hist.append(value)
        return out

    def _observe_saturation(
        self, rule: SaturationRule, epoch: int, value: float
    ) -> List[Dict[str, Any]]:
        hist = self._sat_hist[rule.metric]
        hist.append(value)
        out: List[Dict[str, Any]] = []
        if len(hist) < max(self.min_history, 4):
            return out
        engaged = [1.0 if v < rule.engaged_below else 0.0 for v in hist]
        frac = sum(engaged) / len(engaged)
        self.registry.gauge(f"{rule.kind}_frac", round(frac, 4))
        bad = frac >= rule.frac
        # the "z" of a saturation rule is the engagement fraction itself;
        # clear hysteresis at half the firing fraction. The window passed
        # down excludes the newest sample — _latch re-appends it for the
        # changepoint split (same contract as the z-rule family, whose
        # baseline also excludes the current value).
        out.extend(self._latch(rule.kind, rule.metric, epoch, value,
                               rule.engaged_below, frac, bad,
                               list(hist)[:-1],
                               clear_ok=frac < 0.5 * rule.frac))
        return out

    def _latch(
        self,
        kind: str,
        metric: str,
        epoch: int,
        value: float,
        baseline: float,
        z: float,
        bad: bool,
        window_vals: List[float],
        clear_ok: Optional[bool] = None,
    ) -> List[Dict[str, Any]]:
        """Consecutive-tick confirmation + alert latch with clear
        hysteresis, shared by both detector families."""
        out: List[Dict[str, Any]] = []
        if bad:
            self._bad_streak[kind] = self._bad_streak.get(kind, 0) + 1
            self._good_streak[kind] = 0
        else:
            self._bad_streak[kind] = 0
            ok = bad is False if clear_ok is None else clear_ok
            if ok:
                self._good_streak[kind] = self._good_streak.get(kind, 0) + 1
        active = kind in self._active
        if not active and self._bad_streak.get(kind, 0) >= self.consecutive:
            cp_idx, cp_score = changepoint_split(window_vals + [value])
            event = {
                "phase": "train", "kind": kind, "metric": metric,
                "epoch": int(epoch), "value": value, "baseline": baseline,
                "z": round(float(z), 4),
                "severity": "critical" if abs(z) >= 2 * self.z_thresh
                else "warn",
                "window": len(window_vals),
                "changepoint_index": cp_idx,
                "changepoint_score": round(cp_score, 4),
            }
            self._fire(event)
            out.append({**event, "state": "ALERT"})
        elif active and self._good_streak.get(kind, 0) >= self.clear_after:
            event = {
                **self._active[kind], "epoch": int(epoch), "value": value,
                "z": round(float(z), 4), "severity": "info",
            }
            self._clear(kind, event)
            out.append({**event, "state": "CLEAR"})
        return out

    @property
    def active(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._active)


def load_anomalies(run_dir: Union[str, Path]) -> List[Dict[str, Any]]:
    """Rows of a run's ``anomalies.jsonl`` (empty when absent/unparseable)."""
    return read_jsonl_rows(Path(run_dir) / ANOMALIES_FILE)


__all__ = [
    "ANOMALIES_FILE",
    "AnomalyRule",
    "AnomalyWatchdog",
    "DEFAULT_RULES",
    "DEFAULT_SATURATION_RULES",
    "SaturationRule",
    "load_anomalies",
]
