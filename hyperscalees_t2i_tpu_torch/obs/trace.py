"""Nested host-side spans written to ``trace.jsonl`` (port of the parts of
``hyperscalees_t2i_tpu/obs/trace.py`` the training loop uses).

``Tracer(path)`` appends one JSON line per completed span (children before
their parent), timed with the monotonic clock; ``Tracer(None)`` writes
nothing. ``on_span(name, dur_s)``, when given, sees every completed span
whether or not a file is written: the loop's phase histograms read it.
:meth:`Tracer.event` writes a span whose start and end were stamped in
different frames (a served request's submit → complete). The file's lines
are the JAX package's, so its trace readers take them.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union


class Tracer:
    def __init__(self, path: Optional[Union[str, Path]] = None,
                 on_span: Optional[Callable[[str, float], None]] = None):
        self.path = Path(path) if path is not None else None
        self.on_span = on_span
        self._lock = threading.Lock()
        self._local = threading.local()
        self._wall0 = time.time()
        self._mono0 = time.perf_counter()
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._write({"meta": "trace_start", "wall_time": self._wall0, "pid": os.getpid(), "process_index": 0})

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def _write(self, obj: Dict[str, Any]) -> None:
        line = json.dumps(obj, default=str) + "\n"
        try:
            with self._lock, self.path.open("a") as f:
                f.write(line)
        except OSError:
            pass  # a lost trace line must never stop the run

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **attrs: Any):
        """Time a phase; the line carries ``t0_s``/``dur_s`` (offsets from
        the tracer's monotonic origin), ``depth``, ``parent``, pid/tid and
        ``attrs``."""
        if not self.enabled and self.on_span is None:
            yield
            return
        stack = self._stack()
        t0 = time.perf_counter() - self._mono0
        parent = stack[-1] if stack else None
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()
            t1 = time.perf_counter() - self._mono0
            if self.on_span is not None:
                self.on_span(name, t1 - t0)
            if self.enabled:
                ev = {"name": name, "t0_s": round(t0, 6), "dur_s": round(t1 - t0, 6), "depth": len(stack),
                      "parent": parent, "pid": os.getpid(), "tid": threading.get_ident(), "process_index": 0}
                if attrs:
                    ev["attrs"] = attrs
                self._write(ev)


    def event(self, name: str, t0_monotonic: float, t1_monotonic: float, parent: Optional[str] = None,
              **attrs: Any) -> None:
        """A completed span from two ``time.perf_counter()`` stamps, written
        as a ``span`` line is."""
        if not self.enabled:
            return
        ev = {"name": name, "t0_s": round(t0_monotonic - self._mono0, 6),
              "dur_s": round(max(t1_monotonic - t0_monotonic, 0.0), 6), "depth": 0, "parent": parent,
              "pid": os.getpid(), "tid": threading.get_ident(), "process_index": 0}
        if attrs:
            ev["attrs"] = attrs
        self._write(ev)


def load_events(path: Union[str, Path]) -> List[Dict[str, Any]]:
    """Span events of ``trace.jsonl`` (or of the run dir holding one), in
    file order, each tagged with its 0-based tracer ``session`` (a resumed
    run appends a new one); unparseable lines are skipped."""
    p = Path(path)
    if p.is_dir():
        p = p / "trace.jsonl"
    events: List[Dict[str, Any]] = []
    session = -1
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue
        if ev.get("meta") == "trace_start":
            session += 1
        elif "name" in ev and "dur_s" in ev and "t0_s" in ev:
            ev["session"] = max(session, 0)
            events.append(ev)
    return events
