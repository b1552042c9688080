"""Elastic membership of a launch: hard-failure detection, an agreed
survivor set, and the survivors' commit (port of
``hyperscalees_t2i_tpu/resilience/elastic.py``; every call goes over the
launch's store through ``parallel.collectives._StoreClient``).

- **Detect**: a host gather that misses its deadline raises
  ``parallel.collectives.GatherTimeout`` naming the gather's round, the
  waiting rank and the missing ranks.
- **Agree** (:func:`roll_call`): the callers post incarnation-stamped
  liveness keys under a round named after the failed gather (every
  survivor of a fail-stop death fails at the same round), read every
  peer's key with a bounded deadline, vote their observed alive-sets and
  intersect them, then ratify: each adopts the verdict of the lowest rank
  whose verdict it can read. A stale incarnation counts as dead. Survivors
  of a verdict with dead ranks post it as a round-independent tombstone
  (``membership/<rank>/<k>``), which a straggler that fails at a later
  round reads first and stands down on.
- **Reshard**: member slices are keyed by global member ids
  (``parallel.mesh.host_slices``) and θ is replicated, so the population
  re-splits over the survivors; ``restore(on_mismatch="reshard")`` is the
  relaunch half.
- **Act**: ``checkpoint_exit`` commits one slot among the survivors
  (:func:`survivor_commit`: write, read back, digest vote over the store's
  keys scoped to the survivors) and exits for a relaunch; ``continue``
  adopts the lost slices from the last ratified slot
  (``collectives.set_live_ranks`` scopes later gathers to the survivors).

Everything here is on the host. The membership view (:func:`membership_view`)
is what ``/healthz`` serves; :func:`write_transition` appends each verdict
and reshard restore to ``run_dir/elastic.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from . import telemetry

Pytree = Any

ELASTIC_MARKER = "elastic.json"

# bounded per-key read timeout for the roll-call's liveness/vote rounds —
# deliberately much shorter than the gather timeout that got us here: by the
# time roll-call runs, a live peer is already unblocked and posting
ROLLCALL_TIMEOUT_ENV = "HYPERSCALEES_ELASTIC_ROLLCALL_MS"
DEFAULT_ROLLCALL_MS = 10_000

_KEY_ROOT = "hyperscalees/elastic"


def rollcall_timeout_ms() -> int:
    v = os.environ.get(ROLLCALL_TIMEOUT_ENV, "").strip()
    try:
        return int(v) if v else DEFAULT_ROLLCALL_MS
    except ValueError:
        return DEFAULT_ROLLCALL_MS


# ---------------------------------------------------------------------------
# membership view (the /healthz + run_report surface)
# ---------------------------------------------------------------------------

_MEMBERSHIP: Dict[str, Any] = {}

# per-rank post index for the ratified-membership tombstone keys: only rank
# R ever writes membership/<R>/<k>, so a local counter is exactly the key
# sequence (a key is written once). Keyed by
# rank, not process-global, so single-process tests simulating several
# ranks keep each rank's chain dense from k=0.
_MEMBERSHIP_POST_SEQ: Dict[int, int] = {}


def reset_membership(incarnation: str, live_ranks: Sequence[int]) -> None:
    """Install this run's membership view (fresh per run, like the obs
    registries): the /healthz ``membership`` payload and the transition log
    the run_report row renders both read it."""
    global _MEMBERSHIP
    _MEMBERSHIP = {
        "incarnation": str(incarnation),
        "live_ranks": sorted(int(r) for r in live_ranks),
        "transitions": [],
    }
    _MEMBERSHIP_POST_SEQ.clear()


def set_incarnation(incarnation: str) -> None:
    """Stamp the run's incarnation id (known only after resume resolves the
    start epoch) without wiping transitions already noted during setup."""
    if not _MEMBERSHIP:
        reset_membership(incarnation, [])
    else:
        _MEMBERSHIP["incarnation"] = str(incarnation)


def note_membership(
    live_ranks: Sequence[int], transition: Optional[Dict[str, Any]] = None
) -> None:
    if not _MEMBERSHIP:
        reset_membership("?", live_ranks)
    _MEMBERSHIP["live_ranks"] = sorted(int(r) for r in live_ranks)
    if transition is not None:
        _MEMBERSHIP["transitions"].append(dict(transition))


def membership_view() -> Dict[str, Any]:
    """Snapshot for /healthz: incarnation, live ranks, every membership
    transition this incarnation observed (roll-call verdicts, reshard
    restores)."""
    return json.loads(json.dumps(_MEMBERSHIP)) if _MEMBERSHIP else {}


def write_transition(run_dir, transition: Dict[str, Any]) -> Optional[Path]:
    """Append one membership transition to ``run_dir/elastic.json`` (a list
    — reshard restores and roll-call verdicts accumulate across
    incarnations; atomic tmp→replace). Best-effort: the marker is forensics
    + report material, never load-bearing for recovery."""
    path = Path(run_dir) / ELASTIC_MARKER
    try:
        doc: List[Dict[str, Any]] = []
        if path.exists():
            loaded = json.loads(path.read_text())
            if isinstance(loaded, list):
                doc = loaded
        doc.append({**transition, "wall_time": time.time()})
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(doc, indent=2, default=str) + "\n")
        os.replace(tmp, path)
        return path
    except (OSError, json.JSONDecodeError) as e:
        print(f"[resilience] WARNING: elastic marker write failed ({e!r})",
              file=sys.stderr, flush=True)
        return None


def read_transitions(run_dir) -> List[Dict[str, Any]]:
    path = Path(run_dir) / ELASTIC_MARKER
    try:
        doc = json.loads(path.read_text())
        return doc if isinstance(doc, list) else []
    except (OSError, json.JSONDecodeError):
        return []


# ---------------------------------------------------------------------------
# roll-call: one bounded KV round from "a gather timed out" to an agreed
# survivor set
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RollCall:
    """Outcome of one membership roll-call round."""

    round_id: str
    rank: int
    survivors: List[int]  # the agreed set (vote intersection; self included)
    dead: List[int]  # polled ranks not in the agreed set
    observed_alive: List[int]  # this rank's own liveness observation
    duration_s: float

    @property
    def all_alive(self) -> bool:
        """Every polled rank answered: the gather timeout was a SLOW host,
        not a dead one — elastic action would be wrong, escalate instead."""
        return not self.dead and not self.evicted

    @property
    def evicted(self) -> bool:
        """THIS rank was voted out: a peer's vote did not include us (our
        liveness key arrived past its deadline), so the agreed survivor set
        — which must be identical on every member, hence a pure
        intersection — excludes us. The correct move is to stand down
        cleanly: the survivors are continuing without us."""
        return self.rank not in self.survivors


def _bounded_get(client, key: str, timeout_ms: int) -> Optional[str]:
    """One bounded KV read; ``None`` on timeout/absence (any failure to
    produce the key within the deadline counts as 'not there' — the caller
    is deciding liveness, and a read error IS an unavailable peer)."""
    try:
        return client.blocking_key_value_get(key, timeout_ms)
    except Exception:
        return None


def _probe_timeout_ms() -> int:
    """Short per-key probe for the tombstone scan (absent keys are the
    common case — every healthy roll-call pays this once per peer)."""
    from ..parallel.collectives import _kv_probe_timeout_ms

    return _kv_probe_timeout_ms()


def _ratified_membership(
    client, *, rank: int, ranks: Sequence[int], incarnation: str
) -> Optional[Dict[str, Any]]:
    """Scan every peer's ``membership/<r>/<k>`` tombstone chain and return
    the latest same-incarnation verdict that EXCLUDES this rank (``None``
    when no peer has ratified a membership without us). Bounded: one short
    probe per absent key, chains only as long as the run's verdict count."""
    verdict: Optional[Dict[str, Any]] = None
    probe = _probe_timeout_ms()
    for r in ranks:
        if r == rank:
            continue
        k = 0
        while True:
            v = _bounded_get(client, f"{_KEY_ROOT}/membership/{r}/{k}", probe)
            if v is None:
                break
            k += 1
            try:
                row = json.loads(v)
                survivors = [int(x) for x in row.get("survivors", [])]
            except (ValueError, TypeError):
                continue
            if str(row.get("incarnation")) != str(incarnation):
                continue
            if rank not in survivors:
                verdict = {**row, "survivors": survivors}
    return verdict


def _post_membership_verdict(
    client, *, rank: int, incarnation: str, round_id: str,
    survivors: Sequence[int],
) -> None:
    """Tombstone this round's verdict under a round-INDEPENDENT key so a
    straggler that times out at a later gather seq (its own round — nobody
    else is there) still finds it. Best-effort: a failed post degrades to
    the pre-tombstone behavior, never blocks the survivors."""
    k = _MEMBERSHIP_POST_SEQ.get(int(rank), 0)
    key = f"{_KEY_ROOT}/membership/{rank}/{k}"
    try:
        client.key_value_set(key, json.dumps({
            "incarnation": str(incarnation), "round": str(round_id),
            "survivors": sorted(int(r) for r in survivors),
        }))
        _MEMBERSHIP_POST_SEQ[int(rank)] = k + 1
    except Exception as e:
        print(
            f"[resilience] WARNING: membership tombstone post failed "
            f"({e!r}) — a late straggler may need the operator",
            file=sys.stderr, flush=True,
        )


def roll_call(
    client,
    *,
    rank: int,
    ranks: Sequence[int],
    incarnation: str,
    round_id: str,
    timeout_ms: Optional[int] = None,
) -> RollCall:
    """Agree on the surviving membership after a gather timeout.

    ``ranks`` is the currently-believed-live set (every member of it calls
    this with the same ``round_id`` — derived from the failed gather's seq,
    which the deterministic call order makes identical everywhere).
    Bounded phases over the launch's store:

    1. **liveness** — every caller posts ``alive/<rank> = incarnation`` and
       reads every peer's key with a bounded timeout. A missing key, a read
       error, or a STALE incarnation (a key left by a previous run of this
       run dir) all count as dead.
    2. **vote** — every caller posts its observed alive-set and reads the
       vote of every rank it observed alive; the local candidate set is the
       intersection of all readable votes. A rank whose vote cannot be read
       (it died between phases) is dropped.
    3. **ratify** — local intersections are NOT guaranteed identical: a
       marginal peer's vote can land within one survivor's deadline but
       past another's, and under ``--elastic_action continue`` divergent
       survivor sets would recompile mismatched gather widths (or elect two
       different "lowest survivors" for the commit). So every caller posts
       its intersection under ``final/<rank>`` and adopts the verdict of
       the LOWEST rank whose posted verdict it can read (its own when no
       lower rank's key is readable — dead ranks never post). All callers
       scan in the same ascending order, so the agreed set is one rank's
       verdict, not N private ones; the residual window is a single key's
       visibility rather than every vote read. A caller whose own rank is
       not in the adopted verdict was voted out by its peers
       (``RollCall.evicted``) — its move is to stand down cleanly, not to
       fork the pod by insisting on itself.

    Before phase 1 the caller probes the round-independent membership
    tombstones: a same-incarnation verdict a previous round ratified WITHOUT
    us means our peers already voted us out while we were wedged — stand
    down immediately (``evicted``) instead of running a solo round, electing
    ourselves sole survivor, and split-braining the run. Survivors of a
    verdict with dead ranks post the tombstone before returning.

    Total wall time is bounded by ~3 · len(ranks) · timeout (a dead rank
    below this one costs one full timeout in the ratify scan); in the common
    case (peers already unblocked and posting) it is milliseconds.
    """
    t0 = time.perf_counter()
    timeout = rollcall_timeout_ms() if timeout_ms is None else int(timeout_ms)
    ranks = sorted(int(r) for r in ranks)
    prior = _ratified_membership(
        client, rank=rank, ranks=ranks, incarnation=incarnation
    )
    if prior is not None:
        print(
            f"[resilience] ELASTIC roll-call {round_id}: a previous round "
            f"({prior.get('round')}) already ratified survivors "
            f"{prior['survivors']} WITHOUT this rank ({rank}) — standing "
            "down instead of forking the pod",
            file=sys.stderr, flush=True,
        )
        telemetry.inc("elastic_rollcalls")
        return RollCall(
            round_id=round_id, rank=rank, survivors=prior["survivors"],
            dead=sorted(set(ranks) - set(prior["survivors"])),
            observed_alive=[rank], duration_s=time.perf_counter() - t0,
        )
    base = f"{_KEY_ROOT}/{round_id}"
    client.key_value_set(f"{base}/alive/{rank}", str(incarnation))
    observed = [rank]
    for r in ranks:
        if r == rank:
            continue
        v = _bounded_get(client, f"{base}/alive/{r}", timeout)
        if v is not None and v == str(incarnation):
            observed.append(r)
        elif v is not None:
            print(
                f"[resilience] ELASTIC roll-call {round_id}: rank {r} posted "
                f"a STALE incarnation ({v!r} != {incarnation!r}) — counted "
                "dead",
                file=sys.stderr, flush=True,
            )
    observed.sort()
    client.key_value_set(f"{base}/vote/{rank}", json.dumps(observed))
    final = set(observed)
    for r in observed:
        if r == rank:
            continue
        v = _bounded_get(client, f"{base}/vote/{r}", timeout)
        if v is None:
            final.discard(r)  # died between liveness and vote
            continue
        try:
            final &= set(int(x) for x in json.loads(v))
        except (ValueError, TypeError):
            final.discard(r)  # unreadable vote == unavailable peer
    # ratify: adopt the lowest readable verdict so every caller leaves with
    # the SAME set even when the local intersections diverged (see docstring)
    client.key_value_set(f"{base}/final/{rank}", json.dumps(sorted(final)))
    for r in ranks:
        if r >= rank:
            break  # no lower rank's verdict readable: our own stands
        v = _bounded_get(client, f"{base}/final/{r}", timeout)
        if v is None:
            continue  # never reached ratify (dead/wedged): next lowest
        try:
            adopted = set(int(x) for x in json.loads(v))
        except (ValueError, TypeError):
            continue
        if final != adopted:
            print(
                f"[resilience] ELASTIC roll-call {round_id}: local "
                f"intersection {sorted(final)} differs from rank {r}'s "
                f"ratified verdict {sorted(adopted)} — adopting the verdict",
                file=sys.stderr, flush=True,
            )
        final = adopted
        break
    survivors = sorted(final)
    dead = sorted(set(ranks) - final)
    if dead and rank in final:
        _post_membership_verdict(
            client, rank=rank, incarnation=incarnation, round_id=round_id,
            survivors=survivors,
        )
    telemetry.inc("elastic_rollcalls")
    telemetry.gauge("elastic_live_hosts", len(survivors))
    if dead:
        telemetry.inc("elastic_dead_hosts", len(dead))
    return RollCall(
        round_id=round_id, rank=rank, survivors=survivors, dead=dead,
        observed_alive=observed, duration_s=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# survivor-coordinated checkpoint (the checkpoint_exit half)
# ---------------------------------------------------------------------------

def survivor_commit(
    run_dir,
    theta: Pytree,
    epoch: int,
    *,
    client,
    rank: int,
    survivors: Sequence[int],
    round_id: str,
    incarnation: str,
    keep: int = 3,
    prev_delta: Optional[Pytree] = None,
    summary_reward: float = 0.0,
    backend_name: str = "",
    config: Optional[Dict[str, Any]] = None,
    topology: Optional[Dict[str, Any]] = None,
    timeout_ms: Optional[int] = None,
) -> bool:
    """Two-phase commit of one slot among the AGREED survivors only.

    The ordinary coordinated commit (``coord.CoordinatedCheckpoint``) votes
    over the seq-ordered host gather, which would block forever on the dead
    rank — so this twin runs the identical write → read-back-verify →
    digest-vote discipline over elastic KV keys scoped to ``survivors``.
    Every survivor holds the identical replicated θ (the epoch in flight
    never completed), so a unanimous digest is expected; any divergence or
    write failure invalidates the slot everywhere, exactly like coord.py.

    When rank 0 is among the dead, the LOWEST surviving rank additionally
    writes/publishes the canonical ``ckpt/`` store (no race — its owner is
    gone), so a relaunch at the new topology restores from the canonical
    path unchanged.
    """
    from .checkpoints import CheckpointStore
    from .coord import host_store_dirname

    survivors = sorted(int(r) for r in survivors)
    if timeout_ms is not None:
        timeout = int(timeout_ms)
    else:
        # the digest vote waits on peers' full checkpoint WRITES, not on an
        # already-posted liveness key — the short roll-call deadline would
        # let a fast survivor refuse while a slow-disk peer is mid-save and
        # the two would exit with contradictory verdicts. Use the (long) KV
        # gather deadline, never less than the roll-call one.
        from ..parallel.collectives import _kv_timeout_ms

        timeout = max(rollcall_timeout_ms(), _kv_timeout_ms())
    store = CheckpointStore(run_dir, keep=keep, dirname=host_store_dirname(rank))
    # a boundary the ordinary coordinated commit already ratified and
    # published (gather timed out AFTER a save_every boundary) must not be
    # rewritten — and above all must not be INVALIDATED by a refused vote:
    # the published slot is authoritative precisely because it ratified
    already_ratified, local_ok, digest = False, True, ""
    try:
        if store.latest_epoch() == int(epoch):
            digest = store.verify_slot(epoch, theta)
            already_ratified = True
    except Exception:
        already_ratified = False
    if not already_ratified:
        try:
            store.save(
                theta, epoch, prev_delta=prev_delta,
                summary_reward=summary_reward, backend_name=backend_name,
                config=config, topology=topology, publish_latest=False,
            )
            digest = store.verify_slot(epoch, theta)
        except Exception as e:
            local_ok = False
            print(
                f"[resilience] ELASTIC COMMIT: rank {rank} slot write/verify "
                f"failed at epoch {epoch}: {e}",
                file=sys.stderr, flush=True,
            )
    base = f"{_KEY_ROOT}/{round_id}/ckpt"
    client.key_value_set(
        f"{base}/{rank}", json.dumps({"ok": local_ok, "digest": digest})
    )
    ok_all, digests = True, set()
    for r in survivors:
        if r == rank:
            ok_all &= local_ok
            digests.add(digest)
            continue
        v = _bounded_get(client, f"{base}/{r}", timeout)
        if v is None:
            ok_all = False  # a survivor vanished mid-commit: refuse
            continue
        try:
            row = json.loads(v)
            ok_all &= bool(row.get("ok"))
            digests.add(str(row.get("digest", "")))
        except (ValueError, TypeError):
            ok_all = False
    committed = ok_all and len(digests) == 1
    if not committed:
        if already_ratified:
            print(
                f"[resilience] ELASTIC COMMIT REFUSED at epoch {epoch} "
                f"(ok={ok_all}, digests={len(digests)}) — slot {epoch} was "
                "ratified by the ordinary coordinated commit and stays "
                "published",
                file=sys.stderr, flush=True,
            )
        else:
            store.invalidate_slot(epoch)
            print(
                f"[resilience] ELASTIC COMMIT REFUSED at epoch {epoch} "
                f"(ok={ok_all}, digests={len(digests)}) — previous published "
                "slot remains authoritative",
                file=sys.stderr, flush=True,
            )
        telemetry.inc("elastic_commit_failed")
        return False
    store.publish_latest(epoch)
    telemetry.inc("elastic_commits")
    if 0 not in survivors and rank == survivors[0]:
        # the canonical store's owner is dead: the lowest survivor republishes
        # the agreed slot there so relaunch-at-new-N restores the usual path
        canonical = CheckpointStore(run_dir, keep=keep, dirname="ckpt")
        try:
            canonical.save(
                theta, epoch, prev_delta=prev_delta,
                summary_reward=summary_reward, backend_name=backend_name,
                config=config, topology=topology, publish_latest=True,
            )
            print(
                f"[resilience] ELASTIC COMMIT: rank {rank} republished slot "
                f"{epoch} to the canonical ckpt/ (rank 0 is dead)",
                file=sys.stderr, flush=True,
            )
        except Exception as e:
            print(
                f"[resilience] WARNING: canonical republish failed ({e!r}) — "
                f"restore from ckpt.host{rank}/ instead",
                file=sys.stderr, flush=True,
            )
    return True


__all__ = [
    "DEFAULT_ROLLCALL_MS",
    "ELASTIC_MARKER",
    "ROLLCALL_TIMEOUT_ENV",
    "RollCall",
    "membership_view",
    "note_membership",
    "read_transitions",
    "reset_membership",
    "roll_call",
    "rollcall_timeout_ms",
    "survivor_commit",
    "write_transition",
]
