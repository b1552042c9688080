"""Fault tolerance of the training loop (port of
``hyperscalees_t2i_tpu/resilience/``):

- ``checkpoints``: versioned, checksummed, atomically committed slots, the
  per-process stores of a launch and reshard-on-restore;
- ``preempt``: SIGTERM/SIGINT → a slot at the epoch boundary,
  ``preempted.json``, a clean exit;
- ``rollback``: the non-finite / divergence guard's policy;
- ``retry``: bounded exponential backoff for host I/O;
- ``faultinject``: deterministic fault points (host-scopable) for every
  recovery path;
- ``coord``: the launch's two-phase commit and the desync fingerprint;
- ``elastic``: the roll-call after a hard death, the survivors' commit,
  the membership view and ``elastic.json``;
- ``telemetry``: the ``resilience/*`` counters and the host snapshot.

``checkpoints``, ``coord`` and ``elastic`` load on first use, as in the
JAX package.
"""

from .faultinject import (
    FaultPlan,
    SimulatedCrash,
    fault_epoch,
    get_fault_plan,
    install_fault_plan,
    maybe_io_error,
    maybe_serve_fault,
    set_fault_plan,
    slow_fault_seconds,
)
from .preempt import HALT_MARKER, PREEMPT_MARKER, PreemptionHandler, write_marker
from .retry import call_with_retry, retry
from .rollback import POLICIES, RollbackController
from .telemetry import (
    get_resilience_registry,
    host_snapshot_payload,
    inc,
    set_resilience_registry,
    write_host_snapshot,
)

_LAZY = ("CheckpointStore", "RestoreResult", "TopologyMismatch", "flatten_with_paths")
_LAZY_COORD = ("CoordinatedCheckpoint", "CommitVote", "fingerprint_payload", "fingerprints_agree",
               "host_commit_vote")
_LAZY_ELASTIC = ("RollCall", "roll_call", "survivor_commit", "membership_view", "note_membership",
                 "reset_membership", "read_transitions", "write_transition", "ELASTIC_MARKER")

__all__ = [
    "FaultPlan",
    "HALT_MARKER",
    "POLICIES",
    "PREEMPT_MARKER",
    "PreemptionHandler",
    "RollbackController",
    "SimulatedCrash",
    "call_with_retry",
    "fault_epoch",
    "get_fault_plan",
    "get_resilience_registry",
    "host_snapshot_payload",
    "inc",
    "install_fault_plan",
    "maybe_io_error",
    "maybe_serve_fault",
    "retry",
    "set_fault_plan",
    "set_resilience_registry",
    "slow_fault_seconds",
    "write_host_snapshot",
    "write_marker",
    *_LAZY,
    *_LAZY_COORD,
    *_LAZY_ELASTIC,
]


def __getattr__(name):
    if name in _LAZY:
        from . import checkpoints as _ckpt

        return getattr(_ckpt, name)
    if name in _LAZY_COORD:
        from . import coord as _coord

        return getattr(_coord, name)
    if name in _LAZY_ELASTIC:
        from . import elastic as _elastic

        return getattr(_elastic, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
