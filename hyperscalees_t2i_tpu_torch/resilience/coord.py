"""The commit and agreement layer of a launch of several processes (port of
``hyperscalees_t2i_tpu/resilience/coord.py``).

- :class:`CoordinatedCheckpoint`: a two-phase slot commit. Every process
  writes its own store (rank 0 the canonical ``ckpt/``, rank *i*
  ``ckpt.host<i>/``: no two processes rename into one directory), reads
  the slot back from the file bytes, and votes with its 32-byte digest in
  one host gather (:func:`host_commit_vote`). Only a unanimous vote (every
  process ok, one digest) publishes ``latest``; otherwise the slot is
  invalidated in every store and the previous published slot stays the
  newest one every process agrees on.
- :func:`fingerprint_payload` / :func:`fingerprints_agree`: the desync
  check. θ's and Δθ's global norms, which the step already returns, ride
  the trainer's per-epoch scalar gather (f32 on the wire, bitwise) and are
  compared as f32 bit patterns.

With one process the commit is the plain store's save with immediate
publication, no vote and no gather.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import telemetry
from .checkpoints import CheckpointStore
from .retry import call_with_retry

_DIGEST_LEN = 32  # sha256
_FAILED_DIGEST = b"\x00" * _DIGEST_LEN


def process_count() -> int:
    from ..parallel.collectives import process_count as _pc

    return _pc()


def process_index() -> int:
    from ..parallel.collectives import process_rank as _pr

    return _pr()


def host_store_dirname(rank: int) -> str:
    """Rank 0 owns the canonical ``ckpt/`` (what restore reads); rank *i*
    writes its vote copy into ``ckpt.host<i>/``."""
    return "ckpt" if rank == 0 else f"ckpt.host{rank}"


@dataclasses.dataclass
class CommitVote:
    """The outcome of one commit round."""

    committed: bool
    ok_flags: List[bool]
    digests: List[bytes]

    @property
    def failed_hosts(self) -> List[int]:
        return [i for i, ok in enumerate(self.ok_flags) if not ok]

    @property
    def forked(self) -> bool:
        """Every process wrote, but not the same bytes: a desync caught at
        the commit."""
        return all(self.ok_flags) and len(set(self.digests)) > 1


def host_commit_vote(local_ok: bool, digest_hex: str) -> CommitVote:
    """One host gather of ``(ok, sha256)`` rows: every process learns the
    same verdict."""
    from ..parallel.collectives import host_allgather_bytes

    payload = (b"\x01" if local_ok else b"\x00") + bytes.fromhex(digest_hex)
    rows = host_allgather_bytes(payload, 1 + _DIGEST_LEN)
    ok_flags = [r[0] == 1 for r in rows]
    digests = [r[1:] for r in rows]
    committed = all(ok_flags) and len(set(digests)) == 1
    return CommitVote(committed=committed, ok_flags=ok_flags, digests=digests)


class CoordinatedCheckpoint:
    """The launch's slot commit. :meth:`save` is a collective with more than
    one process: every process calls it at the same boundary. It returns
    True when the slot committed, False when it was invalidated everywhere.
    Its counters go to the process-global ``resilience/`` registry."""

    def __init__(self, run_dir, keep: int = 3):
        self.run_dir = Path(run_dir)
        self.keep = int(keep)

    def store(self, rank: Optional[int] = None) -> CheckpointStore:
        """This process's store. When rank 0 is among the dead (after an
        elastic roll-call), the lowest live rank takes the canonical
        ``ckpt/``."""
        from ..parallel.collectives import live_ranks

        r = process_index() if rank is None else rank
        dirname = host_store_dirname(r)
        live = live_ranks()
        if live and r == min(live) and 0 not in live:
            dirname = "ckpt"
        return CheckpointStore(self.run_dir, keep=self.keep, dirname=dirname)

    def save(self, theta: Any, epoch: int, *, prev_delta: Optional[Any] = None, summary_reward: float = 0.0,
             backend_name: str = "", config: Optional[Dict[str, Any]] = None,
             topology: Optional[Dict[str, Any]] = None, legacy_mirror: bool = True) -> bool:
        if process_count() <= 1:
            # one process: the plain save, published at once
            from ..train.checkpoints import save_checkpoint

            save_checkpoint(self.run_dir, theta, epoch, summary_reward, backend_name, config=config,
                            topology=topology, prev_delta=prev_delta, keep=self.keep, legacy_mirror=legacy_mirror)
            return True

        store = self.store()
        local_ok, digest = True, _FAILED_DIGEST.hex()
        try:
            store.save(theta, epoch, prev_delta=prev_delta, summary_reward=summary_reward,
                       backend_name=backend_name, config=config, topology=topology, publish_latest=False)
            # re-read the slot: a transient read error is retried (site
            # ckpt_read), a checksum or structure failure is not
            digest = call_with_retry(store.verify_slot, (epoch, theta), site="ckpt_read")
        except Exception as e:
            local_ok = False
            print(f"[resilience] COMMIT: host {process_index()} slot write/verify failed at epoch {epoch}: {e}",
                  file=sys.stderr, flush=True)

        vote = host_commit_vote(local_ok, digest)
        if vote.committed:
            store.publish_latest(epoch)
            telemetry.inc("ckpt_commits")
            if process_index() == 0 and legacy_mirror:
                from ..train.checkpoints import write_legacy_mirror

                write_legacy_mirror(self.run_dir, theta, epoch, summary_reward=summary_reward,
                                    backend_name=backend_name, config=config)
            return True

        # no unanimity: the slot stops being a resume candidate everywhere
        store.invalidate_slot(epoch)
        telemetry.inc("ckpt_commit_failed")
        why = (f"digest fork across hosts ({[d[:4].hex() for d in vote.digests]})" if vote.forked
               else f"write/verify failed on host(s) {vote.failed_hosts}")
        print(f"[resilience] COMMIT REFUSED at epoch {epoch}: {why} — slot invalidated on every host; previous "
              "published slot remains authoritative", file=sys.stderr, flush=True)
        return False


FINGERPRINT_KEYS = ("theta_norm", "delta_norm")
_FP_PREFIX = "_desync_fp/"


def fingerprint_payload(scalars: Dict[str, Any]) -> Dict[str, float]:
    """θ's fingerprint from scalars the step already returned (the f32
    global norms of θ′ and Δθ), as extra keys of the per-epoch scalar
    gather."""
    return {_FP_PREFIX + k: float(scalars.get(k, 0.0)) for k in FINGERPRINT_KEYS}


def fingerprints_agree(gathered: Dict[str, Any]) -> bool:
    """True when every process gathered the same fingerprint rows, compared
    as f32 bit patterns (a θ NaN everywhere alike is the non-finite guard's
    case, not a desync)."""
    import numpy as np

    for k in FINGERPRINT_KEYS:
        rows = gathered.get(_FP_PREFIX + k)
        if rows is None:
            continue
        bits = np.asarray(rows, np.float32).view(np.uint32)
        if not (bits == bits[0]).all():
            return False
    return True
