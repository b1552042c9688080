"""Deterministic fault injection: every recovery path runs on the CPU (port
of ``hyperscalees_t2i_tpu/resilience/faultinject.py``: the same grammar,
the same messages).

A plan arms named fault points from a spec string (``TrainConfig.faults``,
``--faults``, or ``$HYPERSCALEES_FAULTS``); the instrumented sites consult
it, and with no plan installed every check is a no-op.

Tokens, separated by ``;`` or ``,``:

- ``preempt@K``     a graceful preemption at the end of epoch K (slot,
                    ``preempted.json``, exit 0);
- ``crash@K``       raise :class:`SimulatedCrash` at the end of epoch K,
                    before the periodic slot;
- ``die@K``         ``os._exit(1)`` at the end of epoch K: no broadcast, no
                    cleanup. With a host scope the survivors block in their
                    next store gather, which the elastic roll-call
                    (``resilience.elastic``) arbitrates;
- ``nan_theta@K``   θ set to NaN after epoch K's update (the non-finite
                    rollback guard's case);
- ``desync@K``      θ × 1.001 after epoch K's update: a finite silent fork
                    that only the cross-host fingerprint check and the
                    commit digest vote can see (meaningful with a host scope);
- ``torn_write@K``  the slot of boundary K truncated between its rename and
                    its publication (the restore scan and the commit's
                    read-back must refuse it);
- ``slow@K``        a sleep of ``HYPERSCALEES_SLOW_FAULT_S`` s (default
                    0.25) inside epoch K's dispatch;
- ``io_error:SITE*N``  a transient ``OSError`` before each of the first N
                    attempts at retry site SITE (``ckpt_write``,
                    ``ckpt_read``, ``prompt_cache``, ``weights``,
                    ``obs_write``);
- ``slow_dispatch*N``  the sleep inside the serve engine's next N timed
                    batch dispatches (``dispatch_s`` grows by it);
- ``store_io*N``    an ``OSError`` from the next N ``AdapterStore.get``
                    calls (one request fails, not its batch).

Any token takes a ``:hostI`` scope (``preempt@3:host1``,
``io_error:ckpt_write*2:host1``) that restricts it to the process of rank
I (``obs.multihost.safe_process_index``). Every process gets the same spec:
an epoch fault scoped to another host still counts as armed for the chain
clamp (:meth:`FaultPlan.next_armed_epoch`), and it disarms on every host
once its epoch is consulted. Everything is host-side and deterministic.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, Optional

from . import telemetry

ENV_VAR = "HYPERSCALEES_FAULTS"

_EPOCH_FAULTS = ("preempt", "crash", "die", "nan_theta", "desync", "torn_write", "slow")

# count faults of the serving tier, armed as NAME*N (serving has no epochs)
_SERVE_FAULTS = ("slow_dispatch", "store_io")

SLOW_FAULT_ENV = "HYPERSCALEES_SLOW_FAULT_S"
DEFAULT_SLOW_FAULT_S = 0.25


def slow_fault_seconds() -> float:
    """The injected straggle of ``slow@K`` and ``slow_dispatch*N``, s."""
    try:
        return float(os.environ.get(SLOW_FAULT_ENV, DEFAULT_SLOW_FAULT_S))
    except ValueError:
        return DEFAULT_SLOW_FAULT_S


class SimulatedCrash(RuntimeError):
    """An injected unclean death (``crash@K``); nothing catches it."""


def _split_host_scope(token: str) -> "tuple[str, Optional[int]]":
    """``(token without a trailing :hostI, I or None)``."""
    head, sep, tail = token.rpartition(":")
    if sep and tail.startswith("host") and tail[len("host"):].isdigit():
        return head, int(tail[len("host"):])
    return token, None


@dataclasses.dataclass
class FaultPlan:
    """Armed fault points: ``epoch_faults[name]`` maps each armed epoch to
    its host scope (``None``: every process); ``io_faults[site]`` and
    ``serve_faults[name]`` count the injections left here (their host
    scope is resolved at parse: armed for another host means not armed)."""

    epoch_faults: Dict[str, Dict[int, Optional[int]]] = dataclasses.field(default_factory=dict)
    io_faults: Dict[str, int] = dataclasses.field(default_factory=dict)
    serve_faults: Dict[str, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        from ..obs.multihost import safe_process_index

        plan = cls()
        for token in spec.replace(";", ",").split(","):
            token = token.strip()
            if not token:
                continue
            token, host = _split_host_scope(token)
            if token.startswith("io_error:"):
                site, _, count = token[len("io_error:"):].partition("*")
                if not site:
                    raise ValueError(f"io_error fault needs a site: {token!r}")
                if host is None or host == safe_process_index():
                    plan.io_faults[site] = plan.io_faults.get(site, 0) + (int(count) if count else 1)
                continue
            name_c, _, count_c = token.partition("*")
            if name_c in _SERVE_FAULTS:
                if host is None or host == safe_process_index():
                    plan.serve_faults[name_c] = plan.serve_faults.get(name_c, 0) + (int(count_c) if count_c else 1)
                continue
            name, sep, epoch = token.partition("@")
            if not sep or name not in _EPOCH_FAULTS:
                raise ValueError(
                    f"unknown fault token {token!r} (expected one of "
                    f"{_EPOCH_FAULTS} as name@epoch[:hostI], "
                    f"{_SERVE_FAULTS} as name*n[:hostI], or "
                    "io_error:site*n[:hostI])"
                )
            plan.epoch_faults.setdefault(name, {})[int(epoch)] = host
        return plan

    def next_armed_epoch(self, epoch: int) -> Optional[int]:
        """The smallest armed epoch ≥ ``epoch`` over every epoch fault, host
        scopes ignored (every process clamps its chains alike)."""
        armed = [k for s in self.epoch_faults.values() for k in s if k >= epoch]
        return min(armed) if armed else None


_PLAN: Optional[FaultPlan] = None


def get_fault_plan() -> Optional[FaultPlan]:
    return _PLAN


def set_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    global _PLAN
    _PLAN = plan
    return _PLAN


def install_fault_plan(spec: Optional[str] = None) -> Optional[FaultPlan]:
    """The run's plan: ``spec`` where given, else ``$HYPERSCALEES_FAULTS``,
    else whatever :func:`set_fault_plan` installed."""
    if spec:
        return set_fault_plan(FaultPlan.parse(spec))
    env = os.environ.get(ENV_VAR, "").strip()
    if env:
        return set_fault_plan(FaultPlan.parse(env))
    return _PLAN


def fault_epoch(name: str, epoch: int) -> bool:
    """True, once, when ``name`` is armed at ``epoch`` for this process.
    The epoch disarms as it is consulted, on every process, fired or not."""
    plan = _PLAN
    if plan is None:
        return False
    armed = plan.epoch_faults.get(name)
    if not armed or epoch not in armed:
        return False
    host = armed.pop(epoch)
    if host is not None:
        from ..obs.multihost import safe_process_index

        if host != safe_process_index():
            return False
    telemetry.inc("faults_injected")
    scope = "" if host is None else f" (host {host})"
    print(f"[resilience] FAULT {name}@{epoch}{scope} injected", file=sys.stderr, flush=True)
    return True


def maybe_io_error(site: str) -> None:
    """Raise one injected transient ``OSError`` when ``site`` is armed (the
    retry wrapper calls it before every attempt)."""
    plan = _PLAN
    if plan is None:
        return
    remaining = plan.io_faults.get(site, 0)
    if remaining <= 0:
        return
    plan.io_faults[site] = remaining - 1
    telemetry.inc("faults_injected")
    print(f"[resilience] FAULT io_error@{site} injected ({remaining - 1} remaining)", file=sys.stderr, flush=True)
    raise OSError(f"injected transient I/O fault at {site!r}")


def maybe_serve_fault(name: str) -> bool:
    """True, consuming one armed count, when the serve fault ``name`` fires
    at this consult; the site acts on it itself."""
    plan = _PLAN
    if plan is None:
        return False
    remaining = plan.serve_faults.get(name, 0)
    if remaining <= 0:
        return False
    plan.serve_faults[name] = remaining - 1
    telemetry.inc("faults_injected")
    print(f"[resilience] FAULT {name} injected ({remaining - 1} remaining)", file=sys.stderr, flush=True)
    return True
