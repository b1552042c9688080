"""``metrics.jsonl`` and the console brief (port of
``hyperscalees_t2i_tpu/train/logging.py`` without wandb).

Each epoch appends one row ``{"ts", **scalars}`` to ``run_dir/
metrics.jsonl`` (retried; a row that still fails is dropped with a warning)
and prints ``[epoch NNNN] mean=… combined_mean=… theta_norm=…
images_per_sec=…`` on stdout; progress lines go to stderr.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

from ..resilience.retry import call_with_retry

_BRIEF_KEYS = ("opt_score_mean", "reward/combined_mean", "theta_norm", "images_per_sec")


def _json_default(o: Any):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


def _console_fmt(v: Any) -> str:
    try:
        return f"{float(v):.4f}"
    except (TypeError, ValueError):
        return str(v)


class MetricsLogger:
    """``registry`` (the run's ``resilience/`` one) counts the retries.
    ``run_dir=None`` is a silent logger that writes nothing (the processes
    of a launch other than process 0)."""

    def __init__(self, run_dir: Optional[Path], registry: Optional[Any] = None):
        self.registry = registry
        self.run_dir = self.path = None
        if run_dir is not None:
            self.run_dir = Path(run_dir)
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self.path = self.run_dir / "metrics.jsonl"

    def info(self, msg: str) -> None:
        if self.path is not None:
            print(f"[train] {msg}", file=sys.stderr, flush=True)

    def _append_line(self, line: str) -> None:
        with self.path.open("a") as f:
            f.write(line)

    def log(self, epoch: int, scalars: Dict[str, Any]) -> None:
        if self.path is None:
            return
        line = json.dumps({"ts": time.time(), **scalars}, default=_json_default) + "\n"
        try:
            call_with_retry(self._append_line, (line,), site="obs_write", base_delay_s=0.05, max_delay_s=1.0,
                            registry=self.registry)
        except OSError as e:
            print(f"[train] WARNING: metrics.jsonl write failed after retries ({e!r}) — epoch {epoch} row dropped",
                  file=sys.stderr, flush=True)
        brief = " ".join(f"{k.split('/')[-1]}={_console_fmt(scalars[k])}" for k in _BRIEF_KEYS if k in scalars)
        print(f"[epoch {epoch:04d}] {brief}", flush=True)
