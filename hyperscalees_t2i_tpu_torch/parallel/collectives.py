"""Collectives over the process group, and the host gathers of a launch
(port of ``hyperscalees_t2i_tpu/parallel/collectives.py``).

The JAX package's in-program collectives run over a named mesh axis inside
one compiled program. The port's pop axis is the process group
(``parallel.mesh``), so :func:`psum_tree`, :func:`pmean_tree`,
:func:`all_gather_tree`, :func:`all_gather_ragged`, :func:`axis_size` and
:func:`ppermute_ring` run over the gloo group of the launch. Gloo reduces
host memory: a leaf on the card is copied to the host and back. A process
alone (no group, or a group of one) gets the single-device results with no
communication.

The host gathers (:func:`host_scalar_allgather`, :func:`host_allgather_bytes`,
:func:`host_allgather_rows`, :func:`barrier`, ...) go through the launch's
``TCPStore``, as the JAX package's go through its coordination-service
key-value store on the CPU: round ``s`` posts each rank's row under
``hyperscalees/hg{s}/{rank}`` and reads every live rank's, a rank deletes
its own row of round ``s − 2``, and a read that misses its deadline
(``HYPERSCALEES_KV_TIMEOUT_MS``, at least ``HYPERSCALEES_KV_COMPILE_GRACE_MS``
in an epoch that builds programs) downgrades the remaining reads to a
short probe (``HYPERSCALEES_KV_PROBE_MS``) and raises :class:`GatherTimeout`
naming every missing rank. The JAX package's ``xla`` transport
(``HYPERSCALEES_HOST_GATHER=xla``) has no counterpart and raises.

Every collective is called by every live process in the same order (the
training loop is the same program on every rank).
"""

from __future__ import annotations

import functools
import itertools
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch

from ..utils.pytree import tree_map
from .mesh import coordination_store

T = TypeVar("T")
Pytree = Any


# --------------------------------------------------------------------------
# collectives over the process group
# --------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def axis_size(group: Any = None) -> int:
    """Processes on the pop axis (the group's size; 1 alone)."""
    dist = _dist()
    return dist.get_world_size(group) if dist is not None else 1


def _host(x: torch.Tensor) -> torch.Tensor:
    """A contiguous host tensor the collective may write (gloo works on the
    host's memory: a card tensor crosses to it and back)."""
    return x.detach().to("cpu", copy=True).contiguous()


def psum_tree(tree: Pytree, group: Any = None) -> Pytree:
    """Sum every leaf over the group."""
    if axis_size(group) <= 1:
        return tree_map(lambda x: x.clone(), tree)

    def reduce(x: torch.Tensor) -> torch.Tensor:
        h = _host(x)
        _dist().all_reduce(h, group=group)
        return h.to(x.device)

    return tree_map(reduce, tree)


def pmean_tree(tree: Pytree, group: Any = None) -> Pytree:
    """Mean of every leaf over the group (the sum over the group size)."""
    n = axis_size(group)
    return tree_map(lambda x: x / n, psum_tree(tree, group))


def all_gather_tree(tree: Pytree, *, axis: int = 0, group: Any = None) -> Pytree:
    """Every rank's leaf concatenated along ``axis`` in rank order."""
    n = axis_size(group)
    if n <= 1:
        return tree_map(lambda x: x.clone(), tree)

    def gather(x: torch.Tensor) -> torch.Tensor:
        h = _host(x)
        parts = [torch.empty_like(h) for _ in range(n)]
        _dist().all_gather(parts, h, group=group)
        return torch.cat(parts, dim=axis).to(x.device)

    return tree_map(gather, tree)


def all_gather_ragged(x: torch.Tensor, length: torch.Tensor, max_len: int,
                      group: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each rank holds a valid prefix of ``length`` rows of ``x``, padded
    here to ``max_len`` along axis 0; returns ``(data [n, max_len, ...],
    lengths [n])``, both in rank order. Callers mask past each length."""
    if x.shape[0] != max_len:
        pad = torch.zeros((max_len - x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    data = all_gather_tree(x[None], group=group)
    lens = all_gather_tree(torch.as_tensor(length).reshape(1), group=group)
    return data, lens


def ppermute_ring(x: torch.Tensor, *, shift: int = 1, group: Any = None) -> torch.Tensor:
    """Ring shift over the group: rank ``i`` sends ``x`` to rank ``(i +
    shift) % n`` and returns what rank ``(i − shift) % n`` sent
    (``torch.distributed.batch_isend_irecv``)."""
    n = axis_size(group)
    if n <= 1 or shift % n == 0:
        return x.clone()
    dist = _dist()
    rank = dist.get_rank(group)
    send, recv = _host(x), torch.empty_like(_host(x))
    to, frm = (rank + shift) % n, (rank - shift) % n
    if group is not None:
        to, frm = dist.get_global_rank(group, to), dist.get_global_rank(group, frm)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group),
                                       dist.P2POp(dist.irecv, recv, frm, group)]):
        req.wait()
    return recv.to(x.device)


# --------------------------------------------------------------------------
# processes
# --------------------------------------------------------------------------

def process_rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def is_master() -> bool:
    """Process 0 owns the shared files (metrics, ledger, checkpoints)."""
    return process_rank() == 0


def master_only(fn: Callable[..., T]) -> Callable[..., Optional[T]]:
    """Decorator: run ``fn`` on process 0 only (``None`` elsewhere)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_master():
            return fn(*args, **kwargs)
        return None

    return wrapper


# --------------------------------------------------------------------------
# host gathers over the store
# --------------------------------------------------------------------------

_KV_SEQ = itertools.count()

# elastic membership: once a failed process has been voted out, every later
# host gather is scoped to the surviving ranks (None: every process is live)
_LIVE_RANKS: Optional[Tuple[int, ...]] = None


class GatherTimeout(RuntimeError):
    """A host gather timed out waiting on peer rows: a dead (or very slow)
    process. Carries the gather's ``seq`` (every process issues gathers in
    the same order, so survivors agree on it), the waiting ``rank`` and
    ``missing``, the ranks whose rows never appeared."""

    def __init__(self, *, seq: int, rank: int, missing: List[int], timeout_ms: int,
                 cause: Optional[BaseException] = None):
        self.seq = int(seq)
        self.rank = int(rank)
        self.missing = sorted(int(r) for r in missing)
        self.timeout_ms = int(timeout_ms)
        super().__init__(
            f"host gather hg{self.seq} timed out on rank {self.rank}: no "
            f"key from rank(s) {self.missing} within {self.timeout_ms} ms — "
            "dead host or straggler beyond the KV deadline (elastic "
            "roll-call arbitrates)"
            + (f"; first error: {cause}" if cause is not None else "")
        )


def set_live_ranks(ranks: Optional[Sequence[int]]) -> None:
    """Scope every later host gather to ``ranks`` (``None``: every
    process). The set must include this process's rank."""
    global _LIVE_RANKS
    if ranks is None:
        _LIVE_RANKS = None
        return
    live = tuple(sorted(int(r) for r in ranks))
    if process_rank() not in live:
        raise ValueError(
            f"live rank set {list(live)} does not include this process "
            f"(rank {process_rank()})"
        )
    _LIVE_RANKS = live


def live_ranks() -> List[int]:
    """Ranks that take part in host gathers."""
    if _LIVE_RANKS is not None:
        return list(_LIVE_RANKS)
    return list(range(process_count()))


def live_count() -> int:
    return len(_LIVE_RANKS) if _LIVE_RANKS is not None else process_count()


class _StoreClient:
    """The store with the key-value calls the gathers make: string values,
    a blocking get with its own deadline, a delete."""

    def __init__(self, store: "torch.distributed.Store"):
        self.store = store

    def key_value_set(self, key: str, value: str) -> None:
        self.store.set(key, value)

    def key_value_delete(self, key: str) -> None:
        self.store.delete_key(key)

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        import datetime

        self.store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
        return self.store.get(key).decode()


def _check_transport() -> None:
    mode = os.environ.get("HYPERSCALEES_HOST_GATHER", "").strip().lower()
    if mode == "xla":
        raise RuntimeError("HYPERSCALEES_HOST_GATHER=xla selects the JAX package's compiled host-gather "
                           "transport, which the port does not have: its host gathers go through the launch's "
                           "TCPStore (unset the variable, or set it to kv)")


def kv_client() -> _StoreClient:
    """The launch's store as a key-value client (raises outside a launch)."""
    _check_transport()
    store = coordination_store()
    if store is None:
        raise RuntimeError(
            "multi-process host gather requested but no launch store exists "
            "(the process group is not initialized) — launch through "
            "initialize_multihost/--coordinator"
        )
    return _StoreClient(store)


# A gather issued in an epoch that builds programs waits on peers that are
# still building the same programs: the trainer turns the grace on for such
# epochs and off for steady-state ones.
_GATHER_GRACE = False


def set_gather_grace(on: bool) -> None:
    global _GATHER_GRACE
    _GATHER_GRACE = bool(on)


def _env_ms(name: str, default: int) -> int:
    v = os.environ.get(name, "").strip()
    try:
        return int(v) if v else default
    except ValueError:
        return default


def _kv_grace_ms() -> int:
    return _env_ms("HYPERSCALEES_KV_COMPILE_GRACE_MS", 600_000)


def _kv_timeout_ms() -> int:
    base = _env_ms("HYPERSCALEES_KV_TIMEOUT_MS", 600_000)
    return max(base, _kv_grace_ms()) if _GATHER_GRACE else base


def _kv_probe_timeout_ms() -> int:
    """The short per-key probe after a first miss: it names which ranks are
    missing without paying the full deadline again for each."""
    return _env_ms("HYPERSCALEES_KV_PROBE_MS", 1_000)


def _kv_gather_rows(client, rank: int, ranks: Sequence[int], seq: int, data: bytes, length: int,
                    timeout_ms: int) -> List[bytes]:
    """Post this rank's row of round ``seq``, delete its row of round
    ``seq − 2`` (every peer has read it: reaching round ``s`` needs every
    row of ``s − 1``, which peers post only after their reads of ``s −
    2``), and read every rank's row in order. The first read that misses
    its deadline turns the rest into short probes, and the call raises
    :class:`GatherTimeout` naming every missing rank."""
    client.key_value_set(f"hyperscalees/hg{seq}/{rank}", data.hex())
    if seq >= 2:
        try:
            client.key_value_delete(f"hyperscalees/hg{seq - 2}/{rank}")
        except Exception:
            pass  # best effort: a stale row is a few bytes
    rows: Dict[int, bytes] = {}
    missing: List[int] = []
    first_err: Optional[BaseException] = None
    timeout = timeout_ms
    for r in ranks:
        try:
            rows[r] = bytes.fromhex(client.blocking_key_value_get(f"hyperscalees/hg{seq}/{r}", timeout))
        except Exception as e:
            if first_err is None:
                first_err = e
                timeout = _kv_probe_timeout_ms()
            missing.append(r)
    if missing:
        raise GatherTimeout(seq=seq, rank=rank, missing=missing, timeout_ms=timeout_ms, cause=first_err)
    out = [rows[r] for r in ranks]
    if any(len(r) != length for r in out):
        raise RuntimeError(f"host gather hg{seq}: rows disagree on length ({[len(r) for r in out]}, want {length})")
    return out


def _kv_allgather_bytes(data: bytes, length: int) -> List[bytes]:
    """One fixed-length row per live process, in rank order, through the
    store (the round counter is what the ranks rendezvous on)."""
    return _kv_gather_rows(kv_client(), process_rank(), live_ranks(), next(_KV_SEQ), data, length,
                           _kv_timeout_ms())


def barrier(name: str = "barrier") -> None:
    """Every live process waits here for the others (a one-byte gather
    round; ``name`` labels the call site). No-op alone."""
    if live_count() > 1:
        _kv_allgather_bytes(b"\x01", 1)


def host_scalar_allgather(scalars: Dict[str, float]) -> Dict[str, np.ndarray]:
    """``{key: float32 [process_count]}``, row ``i`` process ``i``'s value.
    Keys travel sorted, as f32 (an f32 scalar round-trips bitwise). Alone:
    one-row arrays, no gather. Every process passes the same key set."""
    keys = sorted(scalars)
    vec = np.asarray([float(scalars[k]) for k in keys], np.float32)
    if live_count() <= 1:
        gathered = vec[None]
    else:
        rows = _kv_allgather_bytes(vec.tobytes(), vec.nbytes)
        gathered = np.stack([np.frombuffer(r, np.float32) for r in rows])
    return {k: gathered[:, i] for i, k in enumerate(keys)}


def host_scalar_allmean(scalars: Dict[str, float]) -> Dict[str, float]:
    """Each scalar's mean over the processes (as given, alone)."""
    if live_count() <= 1:
        return dict(scalars)
    return {k: float(v.mean()) for k, v in host_scalar_allgather(scalars).items()}


def host_allgather_bytes(data: bytes, length: int) -> List[bytes]:
    """One ``length``-byte blob per process (``data`` padded or cut to
    ``length``), every process receiving all of them in rank order."""
    buf = np.zeros(length, np.uint8)
    raw = np.frombuffer(data[:length], np.uint8)
    buf[: raw.size] = raw
    if live_count() <= 1:
        return [buf.tobytes()]
    return _kv_allgather_bytes(buf.tobytes(), length)


def host_allgather_rows(arrays: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Row concatenation across processes: each passes a dict of arrays
    whose leading axis is its row slice (the same shapes and dtypes on every
    process) and receives ``{key: [n_proc · rows, ...]}`` in rank order,
    bitwise. Every key's bytes travel in one blob a process, keys sorted,
    in one gather round. Alone: the arrays as given. This is the pod's
    fitness gather: each process's ``[lpop, B]`` reward rows."""
    if live_count() <= 1 or not arrays:
        return {k: np.asarray(v) for k, v in arrays.items()}
    keys = sorted(arrays)
    local = {k: np.ascontiguousarray(np.asarray(arrays[k])) for k in keys}
    blob = b"".join(local[k].tobytes() for k in keys)
    rows = _kv_allgather_bytes(blob, len(blob))
    out = {}
    offset = 0
    for k in keys:
        a = local[k]
        out[k] = np.concatenate([np.frombuffer(r[offset:offset + a.nbytes], a.dtype).reshape(a.shape)
                                 for r in rows])
        offset += a.nbytes
    return out


def host_flag_any(flag: bool) -> bool:
    """True on every process iff any process passed True."""
    if live_count() <= 1:
        return bool(flag)
    return bool(host_scalar_allgather({"flag": 1.0 if flag else 0.0})["flag"].any())


def fmt_metric_vals(metrics: Dict[str, Any], fmt: str = "%.4f") -> Dict[str, str]:
    """Each metric's mean, formatted (the reference's ``dist_fmt_vals``)."""
    return {k: fmt % float(np.mean(np.asarray(torch.as_tensor(v).detach().cpu()))) for k, v in metrics.items()}
