"""Phase heartbeats and the stall watchdog (port of
``hyperscalees_t2i_tpu/obs/heartbeat.py``; standard library plus the
allocator's counters).

- One JSON object per line on stderr, never stdout (scripts print their
  result as the last stdout line): ``{"hb": name, "phase": ..., "process_index": 0,
  "elapsed_s": ...}`` plus the card's memory gauges when CUDA is up.
- :class:`Heartbeat` wraps a long blocking phase (a capture, a dispatch, a
  checkpoint): a daemon thread prints a line every ``interval_s``.
- ``stall_cap_s > 0`` arms the watchdog: when the phase outlasts the cap,
  ``on_stall(name, phase, elapsed_s)`` fires once from the heartbeat thread
  (the line gains ``"stalled": true`` and ``stall_payload``), and
  ``/healthz`` reads ``"stalled"`` until the phase ends. The phase keeps
  running; what to do is the callback's policy (the trainer's
  ``stall_action checkpoint_exit`` latches a preemption request).

The heartbeat thread must never disturb the phase it watches. A CUDA graph
is captured in global mode, where a CUDA runtime call from another thread
(``mem_get_info``, a synchronize, a context's first init) can invalidate
the capture. :func:`device_memory_gauges` therefore reads only the caching
allocator's counters, which make no CUDA call, and reads nothing before
CUDA is initialized.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from contextlib import nullcontext
from typing import Any, Callable, Dict, Optional, TextIO


def device_memory_gauges(device: Any = None) -> Dict[str, int]:
    """``bytes_in_use`` and ``peak_bytes_in_use`` of card ``device`` (an
    index or a ``torch.device``; ``None`` or an unindexed ``cuda``: card 0)
    from the caching allocator's counters; ``{}`` for a CPU device, on a
    machine without CUDA, and before CUDA is initialized (a heartbeat never
    initializes it). The index is passed explicitly, so not even the
    current device is asked of CUDA. Never raises."""
    try:
        import torch

        if device is not None and not isinstance(device, int):
            device = torch.device(device)
            if device.type != "cuda":
                return {}
            device = device.index
        if not torch.cuda.is_initialized():
            return {}
        index = 0 if device is None else int(device)
        return {"bytes_in_use": int(torch.cuda.memory_allocated(index)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(index))}
    except Exception:
        return {}


def emit_heartbeat(name: str, phase: str, stream: Optional[TextIO] = None, **extra: Any) -> None:
    """One liveness line (stderr by default, never stdout), mirrored onto
    the ``/healthz`` blackboard. One process: ``process_index`` is 0."""
    payload = {"hb": name, "phase": phase, "process_index": 0, **extra}
    print(json.dumps(payload, default=str), file=stream or sys.stderr, flush=True)
    try:
        from .exporter import note_heartbeat

        note_heartbeat(payload)
    except Exception:
        pass  # a broken blackboard must never cost a heartbeat line


class Heartbeat:
    """Context manager: liveness lines every ``interval_s`` while a phase
    runs, and the stall watchdog when ``stall_cap_s > 0`` (module note)."""

    def __init__(
        self,
        name: str,
        phase: str,
        interval_s: float = 20.0,
        stall_cap_s: float = 0.0,
        on_stall: Optional[Callable[[str, str, float], None]] = None,
        gauges: Optional[Callable[[], Dict[str, Any]]] = device_memory_gauges,
        stream: Optional[TextIO] = None,
        stall_payload: Optional[Dict[str, Any]] = None,
    ):
        self.name, self.phase = name, phase
        self.interval_s = float(interval_s)
        self.stall_cap_s = float(stall_cap_s or 0.0)
        self.on_stall = on_stall
        self.gauges = gauges
        self.stream = stream
        self.stall_payload = stall_payload
        self.stalled = False
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, name=f"heartbeat:{name}:{phase}", daemon=True)

    def _run(self) -> None:
        t0 = time.perf_counter()
        while True:
            timeout = self.interval_s
            if self.stall_cap_s and not self.stalled:
                # wake for the watchdog even when the interval is far longer
                remaining = self.stall_cap_s - (time.perf_counter() - t0)
                timeout = min(timeout, max(remaining, 0.005))
            if self._stop.wait(timeout):
                return
            elapsed = time.perf_counter() - t0
            extra: Dict[str, Any] = {"elapsed_s": round(elapsed, 1)}
            if self.gauges is not None:
                try:
                    extra.update(self.gauges())
                except Exception:
                    pass
            if self.stall_cap_s and not self.stalled and elapsed >= self.stall_cap_s:
                self.stalled = True
                extra["stalled"] = True
                if self.stall_payload:
                    extra.update(self.stall_payload)
                try:  # /healthz reads "stalled" while this phase hangs
                    from .exporter import note_stall

                    note_stall(True, {"hb": self.name, "phase": self.phase, "elapsed_s": round(elapsed, 1), **extra})
                except Exception:
                    pass
                if self.on_stall is not None:
                    try:
                        self.on_stall(self.name, self.phase, elapsed)
                    except Exception:
                        pass  # a broken callback must not kill liveness
            emit_heartbeat(self.name, self.phase, stream=self.stream, **extra)

    def __enter__(self) -> "Heartbeat":
        self._t.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._stop.set()
        self._t.join(timeout=2)
        if self.stalled:
            try:  # the stalled phase has ended, however it ended
                from .exporter import note_stall

                note_stall(False)
            except Exception:
                pass


def maybe_heartbeat(name: str, phase: str, interval_s: float, **kwargs: Any):
    """:class:`Heartbeat` when ``interval_s > 0``, else a no-op context."""
    if interval_s and interval_s > 0:
        return Heartbeat(name, phase, interval_s=interval_s, **kwargs)
    return nullcontext()


__all__ = ["Heartbeat", "device_memory_gauges", "emit_heartbeat", "maybe_heartbeat"]
