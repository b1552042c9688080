"""Versioned checkpoint slots with atomic commit and checksummed restore
(port of ``hyperscalees_t2i_tpu/resilience/checkpoints.py``, single
process). The files are the JAX package's, so a slot either package
writes restores in the other::

    run_dir/ckpt/step_00000012/theta.npz      θ, one f32 array per slash-joined path
    run_dir/ckpt/step_00000012/delta.npz      Δθ_{t−1} (optional)
    run_dir/ckpt/step_00000012/manifest.json  epoch, per-array sha256/shape/dtype, config, topology
    run_dir/ckpt/latest                       the newest published slot's name

Commit: write into ``ckpt/.tmp-<slot>-<pid>/``, fsync each file and the
dir, ``os.replace`` to the slot's name, fsync ``ckpt/``, then move
``latest`` (tmp → replace). Retention keeps the newest ``keep`` slots (0:
all). Restore scans slots newest first and falls back past a slot that is
torn, mis-shaped or fails its sha256 (logged, ``restore_rejected`` ticked),
skips a slot newer than ``latest``, and raises :class:`TopologyMismatch`
for a slot written under another launch topology. The cross-host commit
vote (``invalidate_slot``) and reshard-on-restore come with multi-GPU
training.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.pytree import flatten_with_paths, tree_leaves_with_path, tree_replace_leaves
from .retry import call_with_retry

SCHEMA_VERSION = 1
_SLOT_PREFIX = "step_"
_THETA = "theta.npz"
_DELTA = "delta.npz"
_MANIFEST = "manifest.json"
_LATEST = "latest"
DEFAULT_TOPOLOGY = {"process_count": 1}


class TopologyMismatch(RuntimeError):
    """A slot written under one launch topology was asked to resume under
    another. It applies to every slot of the run dir, so the restore scan
    raises it instead of falling back."""


def slot_theta_digest(manifest: Dict[str, Any]) -> str:
    """sha256 over a slot's sorted per-array sha256 entries (θ and Δθ)."""
    h = hashlib.sha256()
    for section in ("arrays", "delta_arrays"):
        for key, meta in sorted((manifest.get(section) or {}).items()):
            h.update(f"{section}/{key}:{meta.get('sha256', '')}\n".encode())
    return h.hexdigest()


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # some filesystems cannot fsync a directory


def _write_bytes_fsync(path: Path, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _save_npz_fsync(path: Path, flat: Dict[str, np.ndarray]) -> None:
    with open(path, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())


def _array_meta(flat: Dict[str, np.ndarray]) -> Dict[str, Dict[str, Any]]:
    return {k: {"sha256": _sha256(v), "shape": list(v.shape), "dtype": str(v.dtype)} for k, v in flat.items()}


@dataclasses.dataclass
class RestoreResult:
    theta: Any
    epoch: int
    prev_delta: Optional[Any]
    slot: str
    meta: Dict[str, Any]


class CheckpointStore:
    """The slot store of one run dir. With a ``registry`` (the run's
    ``resilience/`` one), a rejected slot ticks ``restore_rejected`` and
    the I/O retries tick theirs."""

    def __init__(self, run_dir, keep: int = 3, registry: Optional[Any] = None):
        self.run_dir = Path(run_dir)
        self.dir = self.run_dir / "ckpt"
        self.keep = int(keep)
        self.registry = registry

    def slot_path(self, epoch: int) -> Path:
        return self.dir / f"{_SLOT_PREFIX}{int(epoch):08d}"

    def slots(self) -> List[Path]:
        """Committed slot dirs, oldest → newest."""
        if not self.dir.is_dir():
            return []
        out = [p for p in self.dir.iterdir()
               if p.is_dir() and p.name.startswith(_SLOT_PREFIX) and p.name[len(_SLOT_PREFIX):].isdigit()]
        return sorted(out, key=lambda p: int(p.name[len(_SLOT_PREFIX):]))

    # -- save -----------------------------------------------------------------

    def save(self, theta: Any, epoch: int, *, prev_delta: Optional[Any] = None, summary_reward: float = 0.0,
             backend_name: str = "", config: Optional[Dict[str, Any]] = None,
             topology: Optional[Dict[str, Any]] = None) -> Path:
        """Commit a slot and publish it as ``latest`` (θ on any device; it
        is copied to the host)."""
        return call_with_retry(self._save_once, (theta, int(epoch), prev_delta, summary_reward, backend_name,
                                                 config, topology),
                               site="ckpt_write", registry=self.registry)

    def _save_once(self, theta, epoch, prev_delta, summary_reward, backend_name, config, topology) -> Path:
        final = self.slot_path(epoch)
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = self.dir / f".tmp-{final.name}-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        flat = flatten_with_paths(theta)
        _save_npz_fsync(tmp / _THETA, flat)
        manifest: Dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "epoch": int(epoch),
            "summary_mean_reward": float(summary_reward),
            "backend": backend_name,
            "config": config or {},
            "topology": topology if topology is not None else dict(DEFAULT_TOPOLOGY),
            "wall_time": time.time(),
            "arrays": _array_meta(flat),
        }
        if prev_delta is not None:
            dflat = flatten_with_paths(prev_delta)
            _save_npz_fsync(tmp / _DELTA, dflat)
            manifest["delta_arrays"] = _array_meta(dflat)
        _write_bytes_fsync(tmp / _MANIFEST, json.dumps(manifest, indent=2).encode())
        _fsync_dir(tmp)
        if final.exists():  # a re-save of the same epoch (a replay after a rollback)
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self.dir)
        latest_tmp = self.dir / (_LATEST + ".tmp")
        _write_bytes_fsync(latest_tmp, (final.name + "\n").encode())
        os.replace(latest_tmp, self.dir / _LATEST)
        _fsync_dir(self.dir)
        self._retain()
        return final

    def verify_slot(self, epoch: int, theta_template: Any) -> str:
        """Read a written slot back, re-check its structure and every sha256
        against the file bytes, and return :func:`slot_theta_digest`;
        raises on any mismatch."""
        slot = self.slot_path(epoch)
        manifest = json.loads((slot / _MANIFEST).read_text())
        load_validated(slot / _THETA, theta_template, "theta", manifest.get("arrays"))
        if (slot / _DELTA).exists():
            load_validated(slot / _DELTA, theta_template, "delta", manifest.get("delta_arrays"))
        return slot_theta_digest(manifest)

    def _retain(self) -> None:
        if self.keep <= 0:
            return
        for old in self.slots()[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def latest_epoch(self) -> Optional[int]:
        """The epoch ``latest`` names, or ``None`` without a pointer."""
        try:
            name = (self.dir / _LATEST).read_text().strip()
        except OSError:
            return None
        if name.startswith(_SLOT_PREFIX) and name[len(_SLOT_PREFIX):].isdigit():
            return int(name[len(_SLOT_PREFIX):])
        return None

    def restore(self, theta_template: Any, *, with_delta: bool = False,
                expect_topology: Optional[Dict[str, Any]] = None) -> Optional[RestoreResult]:
        """The newest valid slot as CPU tensors shaped and typed like
        ``theta_template`` (θ, epoch and, with ``with_delta``, Δθ), or
        ``None`` when no slot validates."""
        return call_with_retry(self._restore_once, (theta_template, with_delta, expect_topology),
                               site="ckpt_read", registry=self.registry)

    def _restore_once(self, theta_template, with_delta, expect_topology) -> Optional[RestoreResult]:
        published = self.latest_epoch()
        for slot in reversed(self.slots()):
            if published is not None and int(slot.name[len(_SLOT_PREFIX):]) > published:
                self._reject(slot, RuntimeError(
                    f"newer than the published latest pointer (step_{published:08d}) — written but never "
                    "committed; refusing to resume an unratified slot"))
                continue
            try:
                return self._load_slot(slot, theta_template, with_delta, expect_topology)
            except TopologyMismatch:
                raise
            except (FileNotFoundError, IsADirectoryError, NotADirectoryError) as e:
                self._reject(slot, e)  # a torn slot
            except OSError:
                raise  # transient I/O: the ckpt_read retry tries again
            except Exception as e:  # torn zip, checksum, structure, json: fall back
                self._reject(slot, e)
        return None

    def _reject(self, slot: Path, e: Exception) -> None:
        if self.registry is not None:
            self.registry.inc("restore_rejected")
        print(f"[resilience] RESTORE: rejecting slot {slot.name}: {e}", file=sys.stderr, flush=True)

    def _load_slot(self, slot: Path, theta_template, with_delta, expect_topology) -> RestoreResult:
        manifest = json.loads((slot / _MANIFEST).read_text())
        if expect_topology:
            stored = manifest.get("topology") or {}
            for k in ("process_count", "pop_shards", "pop_size"):
                if k in stored and k in expect_topology and int(stored[k]) != int(expect_topology[k]):
                    raise TopologyMismatch(
                        f"checkpoint slot {slot.name} was written with {k}={int(stored[k])} but this launch has "
                        f"{k}={int(expect_topology[k])} (stored topology {stored}, current {expect_topology}) — "
                        "resuming would replay a wrong population split; relaunch with the matching geometry "
                        "or start a fresh run_dir")
        theta = load_validated(slot / _THETA, theta_template, "theta", manifest.get("arrays"))
        prev_delta = None
        if with_delta and (slot / _DELTA).exists():
            prev_delta = load_validated(slot / _DELTA, theta_template, "delta", manifest.get("delta_arrays"))
        return RestoreResult(theta, int(manifest["epoch"]), prev_delta, slot.name, manifest)


def load_validated(path: Path, template: Any, label: str,
                   arrays_meta: Optional[Dict[str, Dict[str, Any]]] = None) -> Any:
    """An npz as ``template``'s tree of CPU tensors (the template's dtypes),
    raising with the first diverging key on a missing or extra key, a
    shape mismatch or, given ``arrays_meta``, a sha256 mismatch."""
    with np.load(path) as z:
        files = set(z.files)
        paths = list(tree_leaves_with_path(template))
        keys = [p for p, _ in paths]
        missing, extra = sorted(set(keys) - files), sorted(files - set(keys))
        if missing or extra:
            raise ValueError(f"{label} structure mismatch: missing keys {missing[:3]}, unexpected keys {extra[:3]}")
        out = []
        for key, leaf in paths:
            arr = z[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{label} shape mismatch at {key!r}: stored {tuple(arr.shape)} "
                                 f"vs template {tuple(leaf.shape)}")
            meta = (arrays_meta or {}).get(key)
            if meta and meta.get("sha256") and _sha256(arr) != meta["sha256"]:
                raise ValueError(f"{label} checksum mismatch at {key!r}")
            out.append(torch.from_numpy(np.array(arr)).to(leaf.dtype))
    return tree_replace_leaves(template, out)
