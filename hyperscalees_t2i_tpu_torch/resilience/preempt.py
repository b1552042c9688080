"""SIGTERM/SIGINT → a checkpoint at the next epoch boundary (port of
``hyperscalees_t2i_tpu/resilience/preempt.py``, single process).

The handler only latches the request; the training loop checks it at each
epoch boundary, saves a slot, writes ``preempted.json`` and returns, so the
process exits 0 and a restart with ``resume`` continues where it stopped.
Handlers install only from the main thread; elsewhere :meth:`request` is
the only trigger. A second SIGINT raises ``KeyboardInterrupt``.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

PREEMPT_MARKER = "preempted.json"
HALT_MARKER = "halted.json"


class PreemptionHandler:
    """Latches a graceful-shutdown request; :meth:`uninstall` restores the
    previous handlers. With a ``registry``, a request ticks
    ``preempt_requests``."""

    def __init__(self, registry: Optional[Any] = None):
        self.requested = False
        self.reason: Optional[str] = None
        self._registry = registry
        self._old: Dict[int, object] = {}

    def install(self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)) -> "PreemptionHandler":
        try:
            for s in signals:
                self._old[s] = signal.signal(s, self._handler)
        except ValueError:  # not the main thread
            self._old.clear()
        return self

    def uninstall(self) -> None:
        for s, old in self._old.items():
            try:
                signal.signal(s, old)
            except (ValueError, TypeError):
                pass
        self._old.clear()

    def _handler(self, signum, frame) -> None:
        if self.requested and signum == signal.SIGINT:
            print("[resilience] second SIGINT — aborting now", file=sys.stderr, flush=True)
            raise KeyboardInterrupt
        self.request(f"signal {signal.Signals(signum).name}")

    def request(self, reason: str) -> None:
        if not self.requested:
            self.requested = True
            self.reason = reason
            if self._registry is not None:
                self._registry.inc("preempt_requests")
            print(f"[resilience] PREEMPT requested ({reason}) — checkpointing at the next epoch boundary, "
                  "then exiting cleanly", file=sys.stderr, flush=True)


def write_marker(run_dir: Path, name: str, payload: Dict) -> Path:
    """An atomic (tmp → replace) JSON marker in the run dir."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    path = run_dir / name
    tmp = run_dir / (name + ".tmp")
    tmp.write_text(json.dumps({"wall_time": time.time(), **payload}, indent=2))
    os.replace(tmp, path)
    return path
