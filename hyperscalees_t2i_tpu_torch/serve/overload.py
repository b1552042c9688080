"""Overload protection for the serving tier: shed early, degrade gracefully
(a copy of ``hyperscalees_t2i_tpu/serve/overload.py``; host logic only,
nothing here touches a program).

- **Deadlines and doomed-work shedding.** A request may carry an absolute
  deadline (``ServeRequest.t_deadline``). One whose deadline passed, or
  whose remaining budget cannot cover its geometry's EWMA dispatch time
  (:class:`DispatchEwma`), is shed before it takes a batch lane; its
  censored wait stays in the queue-wait histogram.
- **Pressure controller and brownout ladder.** :class:`PressureController`
  reads queue depth, the SLO fast-window burn and store evictions, and
  walks :data:`BROWNOUT_LADDER` with hysteresis: up after
  ``escalate_after`` pressured evaluations, down one rung after
  ``recover_after`` calm ones. Rung 1 sheds low-priority submits; rung 2
  also truncates requests to ``degraded_images`` prompts (flagged
  ``degraded``).
- **Per-adapter circuit breaker.** :class:`AdapterBreaker` refuses an
  adapter whose dispatches fault ``breaker_faults`` times in a row; after
  ``breaker_cooldown_s`` one probe is let through (half-open).
- **Residency leases** live on :class:`~.adapter_store.AdapterStore`;
  the engine takes one per accepted request and releases it exactly once.

Deterministic, with an injectable clock, so tests assert exact behavior.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

# escalation order; index == rung. "normal" serves everything; each later
# rung keeps every earlier rung's interventions and adds its own.
BROWNOUT_LADDER: Tuple[str, ...] = ("normal", "shed_low_priority", "degrade")

# breaker states (gauge encoding: closed=0, half_open=1, open=2 — so a
# dashboard MAX over adapters is "worst breaker state")
BREAKER_CLOSED = "closed"
BREAKER_HALF_OPEN = "half_open"
BREAKER_OPEN = "open"
_BREAKER_GAUGE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Static knobs for the overload layer (``ServeConfig.overload``;
    ``None`` there = layer off: no deadlines, leases, ladder or breaker).

    Signal normalization: each pressure signal maps to a score where
    ``>= 1.0`` means "pressured" — queue depth against
    ``queue_high_frac`` of ``max_queue``, SLO fast-window burn against
    ``burn_high`` (the canonical page threshold), store evictions per
    controller evaluation against ``thrash_high``. The controller acts on
    the WORST signal, so any one saturated axis is enough to brown out.
    """

    # default deadline stamped on requests submitted without one
    # (<= 0 = no default; requests without deadlines are never shed as
    # doomed, only by priority/brownout)
    deadline_default_s: float = 0.0
    # shed a queued request when its remaining deadline budget cannot cover
    # its geometry's EWMA dispatch time (False = shed only at expiry)
    shed_doomed: bool = True
    ewma_alpha: float = 0.3
    # -- pressure signal thresholds -----------------------------------------
    queue_high_frac: float = 0.5
    burn_high: float = 14.4  # obs.slo.DEFAULT_ALERT_BURN
    thrash_high: float = 8.0  # store evictions per controller evaluation
    # hysteresis: escalate after N consecutive pressured evals; step down
    # one rung after M consecutive calm ones (calm = worst score below
    # recover_below, NOT merely below 1.0 — the gap is the flap guard)
    escalate_after: int = 2
    recover_after: int = 6
    recover_below: float = 0.5
    # -- ladder actions ------------------------------------------------------
    # rung >= 1: refuse submits with priority < shed_below_priority
    shed_below_priority: int = 1
    # rung >= 2: truncate requests to this many prompts (flagged degraded)
    degraded_images: int = 1
    # -- per-adapter circuit breaker ----------------------------------------
    breaker_faults: int = 3
    breaker_cooldown_s: float = 5.0
    breaker_max_tracked: int = 256


class DispatchEwma:
    """Per-geometry EWMA of dispatch time — the doomed-work predictor.

    Keyed by the request's geometry key (prompt count, guidance): different
    geometries run different compiled programs with genuinely different
    dispatch costs, and one pooled average would shed small requests on a
    big geometry's tail. Unprimed geometries return ``None`` — a request is
    never shed on a prediction the engine has not yet measured.
    """

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._ewma: Dict[Any, float] = {}

    def observe(self, key: Any, seconds: float) -> float:
        cur = self._ewma.get(key)
        val = (
            float(seconds) if cur is None
            else self.alpha * float(seconds) + (1.0 - self.alpha) * cur
        )
        self._ewma[key] = val
        return val

    def get(self, key: Any) -> Optional[float]:
        return self._ewma.get(key)

    def snapshot(self) -> Dict[str, float]:
        return {str(k): round(v, 6) for k, v in self._ewma.items()}


class PressureController:
    """Hysteretic brownout ladder driven by normalized pressure scores.

    Pure logic, injectable inputs: :meth:`update` takes the three raw
    signals, normalizes each against its config threshold, and walks
    :data:`BROWNOUT_LADDER` — up one rung after ``escalate_after``
    consecutive pressured evaluations (worst score >= 1), down one rung
    after ``recover_after`` consecutive calm ones (worst score <
    ``recover_below``). Scores between the two bands freeze the ladder:
    neither streak advances, which is what keeps a borderline system from
    flapping between serving modes.
    """

    def __init__(self, cfg: OverloadConfig):
        self.cfg = cfg
        self.rung = 0
        self.escalations = 0
        self.recoveries = 0
        self._hot_streak = 0
        self._calm_streak = 0
        self.last: Dict[str, float] = {}

    @property
    def rung_name(self) -> str:
        return BROWNOUT_LADDER[self.rung]

    def update(
        self, queue_frac: float, burn: Optional[float], thrash: float
    ) -> int:
        """One evaluation; returns the (possibly new) rung index."""
        cfg = self.cfg
        scores = {
            "queue": max(float(queue_frac), 0.0) / max(cfg.queue_high_frac, 1e-9),
            "burn": max(float(burn or 0.0), 0.0) / max(cfg.burn_high, 1e-9),
            "thrash": max(float(thrash), 0.0) / max(cfg.thrash_high, 1e-9),
        }
        worst = max(scores.values())
        self.last = dict(scores, worst=worst)
        if worst >= 1.0:
            self._calm_streak = 0
            self._hot_streak += 1
            if (self._hot_streak >= cfg.escalate_after
                    and self.rung < len(BROWNOUT_LADDER) - 1):
                self.rung += 1
                self.escalations += 1
                self._hot_streak = 0
        elif worst < cfg.recover_below:
            self._hot_streak = 0
            self._calm_streak += 1
            if self._calm_streak >= cfg.recover_after and self.rung > 0:
                self.rung -= 1
                self.recoveries += 1
                self._calm_streak = 0
        else:
            # the hysteresis band: hold the rung, reset both streaks so a
            # single borderline sample cannot complete either transition
            self._hot_streak = 0
            self._calm_streak = 0
        return self.rung


class AdapterBreaker:
    """Per-adapter circuit breaker over *dispatch* faults.

    Closed → (``breaker_faults`` consecutive faults) → open →
    (``breaker_cooldown_s`` elapsed) → half-open, admitting exactly ONE
    probe → closed on success / re-open on fault. A dispatch success always
    resets the adapter to closed and forgets it (state is only kept for
    misbehaving adapters, bounded by ``breaker_max_tracked`` — oldest
    entries drop first, which merely re-closes a breaker early, never
    wedges a healthy adapter open).
    """

    def __init__(self, cfg: OverloadConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        # adapter_id -> {"state", "faults", "t_open", "probing"}
        self._st: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.opens = 0
        self.closes = 0

    def state(self, adapter_id: str) -> str:
        st = self._st.get(adapter_id)
        return st["state"] if st else BREAKER_CLOSED

    def allow(self, adapter_id: str) -> bool:
        """Submit-time gate. False = refuse instantly (quarantined)."""
        st = self._st.get(adapter_id)
        if st is None or st["state"] == BREAKER_CLOSED:
            return True
        if st["state"] == BREAKER_OPEN:
            if self.clock() - st["t_open"] >= self.cfg.breaker_cooldown_s:
                st["state"] = BREAKER_HALF_OPEN
                st["probing"] = True
                return True  # this request is the probe
            return False
        # half-open: exactly one probe in flight at a time
        if st["probing"]:
            return False
        st["probing"] = True
        return True

    def record_fault(self, adapter_id: str) -> bool:
        """A dispatch-side fault for this adapter; True if the breaker is
        (now) open."""
        st = self._st.get(adapter_id)
        if st is None:
            st = {"state": BREAKER_CLOSED, "faults": 0, "t_open": 0.0,
                  "probing": False}
            self._st[adapter_id] = st
            while len(self._st) > max(int(self.cfg.breaker_max_tracked), 1):
                self._st.popitem(last=False)
        st["faults"] += 1
        if st["state"] == BREAKER_HALF_OPEN:
            # the probe failed: straight back to open, fresh cooldown
            st["state"] = BREAKER_OPEN
            st["t_open"] = self.clock()
            st["probing"] = False
            self.opens += 1
        elif (st["state"] == BREAKER_CLOSED
                and st["faults"] >= max(int(self.cfg.breaker_faults), 1)):
            st["state"] = BREAKER_OPEN
            st["t_open"] = self.clock()
            self.opens += 1
        return st["state"] == BREAKER_OPEN

    def abort_probe(self, adapter_id: str) -> None:
        """Return an un-dispatched probe slot (the probe request was shed,
        abandoned, or refused before reaching dispatch) — without this a
        half-open breaker whose probe never resolves refuses forever."""
        st = self._st.get(adapter_id)
        if st is not None and st["state"] == BREAKER_HALF_OPEN and st["probing"]:
            st["probing"] = False

    def record_ok(self, adapter_id: str) -> None:
        if adapter_id in self._st:
            if self._st[adapter_id]["state"] != BREAKER_CLOSED:
                self.closes += 1
            del self._st[adapter_id]

    def non_closed(self) -> List[Tuple[str, str]]:
        """(adapter_id, state) for every tracked non-closed breaker —
        bounded by construction, the exporter's labeled-series payload."""
        return [(aid, st["state"]) for aid, st in self._st.items()
                if st["state"] != BREAKER_CLOSED]


class OverloadGovernor:
    """The engine-facing facade: controller + breaker + EWMA + shed ledger.

    Owns no request state — the engine threads requests through
    :meth:`doom_reason` / the breaker / the ladder and reports outcomes
    back; the governor just decides and counts. ``clock`` is injectable so
    breaker cooldowns are testable without sleeping.
    """

    def __init__(self, cfg: Optional[OverloadConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or OverloadConfig()
        self.controller = PressureController(self.cfg)
        self.breaker = AdapterBreaker(self.cfg, clock=clock)
        self.ewma = DispatchEwma(self.cfg.ewma_alpha)
        self.shed: Dict[str, int] = {}  # reason -> count (bounded vocabulary)
        self.degraded_total = 0
        self._last_evictions = 0

    @property
    def rung(self) -> int:
        return self.controller.rung

    def count_shed(self, reason: str) -> None:
        self.shed[reason] = self.shed.get(reason, 0) + 1

    def shed_total(self) -> int:
        return sum(self.shed.values())

    def doom_reason(self, req: Any, now: float) -> Optional[str]:
        """Why a queued request should be shed now, or ``None``. Checked
        before every batch assembly: ``deadline`` = already expired;
        ``doomed`` = remaining budget < its geometry's EWMA dispatch time
        (only once that geometry has been measured)."""
        deadline = getattr(req, "t_deadline", None)
        if deadline is None:
            return None
        if now >= deadline:
            return "deadline"
        if self.cfg.shed_doomed:
            est = self.ewma.get(req.geometry_key)
            if est is not None and (deadline - now) < est:
                return "doomed"
        return None

    def evaluate(self, queue_depth: int, queue_ref: int,
                 burn: Optional[float], evictions_total: int) -> int:
        """One pressure evaluation (engine calls this per flush iteration).
        ``evictions_total`` is the store's monotonic counter — the governor
        differences it into a per-evaluation thrash rate."""
        thrash = max(evictions_total - self._last_evictions, 0)
        self._last_evictions = evictions_total
        frac = queue_depth / max(int(queue_ref), 1)
        return self.controller.update(frac, burn, thrash)

    def pressure_view(self, queue_depth: int, queue_ref: int,
                      leases_active: int) -> Dict[str, Any]:
        """The /healthz ``pressure`` slice: ladder rung, the raw signals
        behind it, breaker and lease occupancy, shed totals."""
        last = self.controller.last
        return {
            "rung": self.controller.rung_name,
            "rung_index": self.controller.rung,
            "queue_depth": int(queue_depth),
            "queue_frac": round(queue_depth / max(int(queue_ref), 1), 4),
            "burn_fast": last.get("burn", 0.0) * self.cfg.burn_high,
            "signals": {k: round(v, 4) for k, v in last.items()},
            "escalations": self.controller.escalations,
            "recoveries": self.controller.recoveries,
            "breakers_open": len(self.breaker.non_closed()),
            "leases_active": int(leases_active),
            "shed_total": self.shed_total(),
            "shed": dict(self.shed),
            "degraded_total": self.degraded_total,
        }

    def metrics(self) -> Dict[str, Any]:
        """Exporter scalar source payload (merged by the engine into its
        own): shed counts as ONE labeled series keyed by reason (bounded
        vocabulary), breaker states as one labeled series over the tracked
        (≤ ``breaker_max_tracked``) non-closed adapters."""
        out: Dict[str, Any] = {
            "serve/pressure_rung": self.controller.rung,
            "serve_degraded_total": self.degraded_total,
            "serve_shed_total": self.shed_total(),
        }
        if self.shed:
            out["serve_shed_reason"] = {
                "labeled": [({"reason": r}, n)
                            for r, n in sorted(self.shed.items())],
            }
        non_closed = self.breaker.non_closed()
        out["serve/breakers_open"] = len(non_closed)
        if non_closed:
            out["serve_breaker_state"] = {
                "labeled": [({"adapter": aid}, _BREAKER_GAUGE[st])
                            for aid, st in non_closed],
            }
        return out


__all__ = [
    "BROWNOUT_LADDER",
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "AdapterBreaker",
    "DispatchEwma",
    "OverloadConfig",
    "OverloadGovernor",
    "PressureController",
]
