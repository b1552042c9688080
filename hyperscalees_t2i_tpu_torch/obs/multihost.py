"""Process identity for the observability writers of a multi-process run
(port of ``hyperscalees_t2i_tpu/obs/multihost.py``).

The processes of a launch share ``run_dir``. The write discipline:

- ``metrics.jsonl``, ``programs.jsonl``, ``quality.jsonl`` and checkpoint
  slots: process 0 only (``train.trainer.run_training``);
- ``trace.jsonl``: one segment a process; process 0 keeps
  ``trace.jsonl`` (what the report tools read), process ``i`` writes
  ``trace.<i>.jsonl`` beside it, and the profile window's trace goes to
  ``profile/`` or ``profile.<i>/``;
- heartbeats: each process's own stderr, every payload tagged with its
  ``process_index``;
- ``/metrics`` and ``/healthz``: one exporter a process, on
  ``base port + rank``.

Heartbeat threads call :func:`safe_process_index`, so it never touches
CUDA: it reads an explicit override, then an initialized process group,
then the launcher's variables, then says 0.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

_OVERRIDE: Optional[int] = None


def set_process_index_override(idx: Optional[int]) -> None:
    """Pin the process identity (``None`` restores auto-detection): for
    tests and callers that know their rank before the group exists."""
    global _OVERRIDE
    _OVERRIDE = None if idx is None else int(idx)


def safe_process_index() -> int:
    """This process's rank: the override, else an initialized process
    group's rank, else ``JAX_PROCESS_ID``/``PROCESS_ID`` (the launcher's
    variables, as ``parallel.mesh`` reads them), else 0."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except (ImportError, RuntimeError, ValueError):
        pass
    for var in ("JAX_PROCESS_ID", "PROCESS_ID"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def is_primary() -> bool:
    """True on the process that owns the shared files (rank 0)."""
    return safe_process_index() == 0


def exporter_port(base_port: int) -> int:
    """This process's ``/metrics`` port: ``base + rank``, so every process
    of a launch exports its own slice and two processes of one machine never
    share a socket. ``0`` (exporter off) stays 0 on every rank."""
    base = int(base_port)
    if base <= 0:
        return 0
    return base + safe_process_index()


def trace_segment_path(run_dir: Union[str, Path], filename: str = "trace.jsonl") -> Path:
    """This process's trace segment: ``trace.jsonl`` on rank 0,
    ``trace.<i>.jsonl`` on rank ``i``."""
    run_dir = Path(run_dir)
    idx = safe_process_index()
    if idx == 0:
        return run_dir / filename
    stem, dot, ext = filename.partition(".")
    suffix = f".{ext}" if dot else ""
    return run_dir / f"{stem}.{idx}{suffix}"


def profile_segment_path(run_dir: Union[str, Path]) -> Path:
    """This process's profile directory: ``profile/`` on rank 0,
    ``profile.<i>/`` on rank ``i`` (the trainer's profile window writes
    its ``torch.profiler`` trace there)."""
    run_dir = Path(run_dir)
    idx = safe_process_index()
    return run_dir / ("profile" if idx == 0 else f"profile.{idx}")
