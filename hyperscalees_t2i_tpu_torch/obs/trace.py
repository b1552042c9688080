"""Nested host-side spans written to ``trace.jsonl`` (port of
``hyperscalees_t2i_tpu/obs/trace.py``).

``Tracer(path)`` appends one JSON line per completed span (children before
their parent), timed with the monotonic clock; ``Tracer(None)`` writes
nothing. :meth:`Tracer.event` writes a span whose start and end were
stamped in different frames (a served request's submit → complete). The
file's lines are the JAX package's, so its trace readers take them.
:func:`to_chrome` turns the events into Chrome trace-event JSON
(``chrome://tracing``, Perfetto).

One tracer is the process's (:func:`set_tracer`, :func:`get_tracer`): the
layers that open spans without a handle (``parallel/pop_eval.py``'s
``trace/*`` spans, the engine, a program cache's build span) write to it
through the module-level :func:`span` and :func:`traced`, resolved at call
time. :func:`set_span_observer` installs one observer of every completed
span's ``(name, dur_s)``, called whether or not a file is written (the
trainer's phase histograms read it); an observer that raises is ignored.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

from .multihost import safe_process_index


class Tracer:
    def __init__(self, path: Optional[Union[str, Path]] = None):
        self.path = Path(path) if path is not None else None
        self._lock = threading.Lock()
        self._local = threading.local()
        self._wall0 = time.time()
        self._mono0 = time.perf_counter()
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._write({"meta": "trace_start", "wall_time": self._wall0, "pid": os.getpid(),
                         "process_index": safe_process_index()})

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
        ``attrs``. The process's span observer sees every completed span,
        on a disabled tracer too; with neither a file nor an observer the
        span costs nothing."""
        if not self.enabled and _OBSERVER is None:
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
            observer = _OBSERVER
            if observer is not None:
                try:
                    observer(name, t1 - t0)
                except Exception:
                    pass  # a broken observer must not stop the traced phase
            if self.enabled:
                ev = {"name": name, "t0_s": round(t0, 6), "dur_s": round(t1 - t0, 6), "depth": len(stack),
                      "parent": parent, "pid": os.getpid(), "tid": threading.get_ident(),
                      "process_index": safe_process_index()}
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
              "pid": os.getpid(), "tid": threading.get_ident(), "process_index": safe_process_index()}
        if attrs:
            ev["attrs"] = attrs
        self._write(ev)


_NULL = Tracer(None)
_GLOBAL: Tracer = _NULL
# (name, dur_s) -> None of every completed span, or None; installed per run
# by run_training
_OBSERVER: Optional[Callable[[str, float], None]] = None


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install the process's tracer (``None``: the disabled one). Returns it."""
    global _GLOBAL
    _GLOBAL = tracer if tracer is not None else _NULL
    return _GLOBAL


def get_tracer() -> Tracer:
    return _GLOBAL


def set_span_observer(observer: Optional[Callable[[str, float], None]]) -> None:
    """Install the process's span observer (``None``: off)."""
    global _OBSERVER
    _OBSERVER = observer


@contextmanager
def process_tracer(path: Optional[Union[str, Path]]):
    """``Tracer(path)`` as the process's tracer for the block, the disabled
    one after it."""
    tracer = set_tracer(Tracer(path))
    try:
        yield tracer
    finally:
        set_tracer(None)


@contextmanager
def span(name: str, **attrs: Any):
    """A span on the process's tracer (nothing until :func:`set_tracer`)."""
    with get_tracer().span(name, **attrs):
        yield


def traced(name: Optional[str] = None, **attrs: Any):
    """Decorator: each call in a span on the process's tracer, looked up at
    the call, so a function decorated at import traces once a tracer is
    installed."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with get_tracer().span(label, **attrs):
                return fn(*args, **kwargs)

        return wrapper

    return deco


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


def to_chrome(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event JSON: one complete ``"ph": "X"`` event per span,
    in microseconds, its attrs under ``args``."""
    trace_events = []
    for ev in sorted(events, key=lambda e: (e["t0_s"], -e["dur_s"])):
        trace_events.append({"name": ev["name"], "cat": ev.get("parent") or "root", "ph": "X",
                             "ts": round(ev["t0_s"] * 1e6, 3), "dur": round(ev["dur_s"] * 1e6, 3),
                             "pid": ev.get("pid", 0), "tid": ev.get("tid", 0), "args": ev.get("attrs", {})})
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}
