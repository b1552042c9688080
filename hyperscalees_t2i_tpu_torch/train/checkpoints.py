"""Checkpoints of a training run (port of
``hyperscalees_t2i_tpu/train/checkpoints.py`` without the PEFT export).

The ES optimizer's state is (θ, epoch), since every draw derives from the
epoch. :func:`save_checkpoint` commits a versioned slot
(``resilience.checkpoints.CheckpointStore``) and, by default, the legacy
single-slot mirror ``latest_theta.npz`` + ``latest_meta.json`` (each file
tmp → ``os.replace``). :func:`load_checkpoint` restores the newest valid
slot, else the mirror. The files are the JAX package's.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..resilience.checkpoints import CheckpointStore, load_validated
from ..resilience.retry import call_with_retry
from ..utils.pytree import flatten_with_paths

_THETA_FILE = "latest_theta.npz"
_META_FILE = "latest_meta.json"


def save_checkpoint(run_dir: Path, theta: Any, epoch: int, summary_reward: float, backend_name: str,
                    config: Optional[Dict[str, Any]] = None, *, prev_delta: Optional[Any] = None, keep: int = 3,
                    legacy_mirror: bool = True, topology: Optional[Dict[str, Any]] = None,
                    registry: Optional[Any] = None) -> None:
    """A durable slot (θ, Δθ_{t−1} when given, the manifest) plus, with
    ``legacy_mirror``, the single-slot mirror."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    CheckpointStore(run_dir, keep=keep, registry=registry).save(
        theta, epoch, prev_delta=prev_delta, summary_reward=summary_reward, backend_name=backend_name,
        config=config, topology=topology)
    if legacy_mirror:
        write_legacy_mirror(run_dir, theta, epoch, summary_reward=summary_reward, backend_name=backend_name,
                            config=config, registry=registry)


def write_legacy_mirror(run_dir: Path, theta: Any, epoch: int, *, summary_reward: float = 0.0,
                        backend_name: str = "", config: Optional[Dict[str, Any]] = None,
                        registry: Optional[Any] = None) -> None:
    """``latest_theta.npz`` and ``latest_meta.json``, each written to a tmp
    file and renamed."""
    run_dir = Path(run_dir)

    def write() -> None:
        tmp = run_dir / (_THETA_FILE + ".tmp.npz")
        np.savez(tmp, **flatten_with_paths(theta))
        tmp.replace(run_dir / _THETA_FILE)
        meta = {"epoch": int(epoch), "summary_mean_reward": float(summary_reward), "backend": backend_name,
                "config": config or {}}
        meta_tmp = run_dir / (_META_FILE + ".tmp")
        meta_tmp.write_text(json.dumps(meta, indent=2))
        os.replace(meta_tmp, run_dir / _META_FILE)

    call_with_retry(write, site="ckpt_write", registry=registry)


def load_checkpoint(run_dir: Path, theta_template: Any) -> Optional[Tuple[Any, int]]:
    """(θ, epoch) from the newest valid slot, else from the legacy mirror."""
    run_dir = Path(run_dir)
    restored = CheckpointStore(run_dir).restore(theta_template)
    if restored is not None:
        return restored.theta, restored.epoch
    return load_legacy_checkpoint(run_dir, theta_template)


def load_legacy_checkpoint(run_dir: Path, theta_template: Any,
                           registry: Optional[Any] = None) -> Optional[Tuple[Any, int]]:
    """(θ, epoch) from the legacy mirror only; a mirror that does not fit
    the template is rejected (logged, ``restore_rejected``) and gives
    ``None``."""
    run_dir = Path(run_dir)
    theta_path, meta_path = run_dir / _THETA_FILE, run_dir / _META_FILE
    if not theta_path.exists() or not meta_path.exists():
        return None
    try:
        theta = load_validated(theta_path, theta_template, "legacy theta")
    except ValueError as e:
        if registry is not None:
            registry.inc("restore_rejected")
        print(f"[resilience] RESTORE: rejecting legacy checkpoint: {e}", file=sys.stderr, flush=True)
        return None
    return theta, int(json.loads(meta_path.read_text())["epoch"])
