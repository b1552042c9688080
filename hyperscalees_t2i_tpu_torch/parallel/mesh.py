"""Processes, the population's split over them, and the launch that joins
them (port of ``hyperscalees_t2i_tpu/parallel/mesh.py``).

The port's pop axis is the process group. A torch process drives one card,
so the counterpart of the JAX package's one-program N-device pop mesh is N
processes with one device each: rank ``i`` evaluates the contiguous member
slice ``host_slices(pop, N)[i]``, and :func:`pop_slice_plan` and
``parallel.pop_update.pop_shard_update_plan`` read the pop axis's size from
the group (``collectives.process_count``).

A process runs on ``cuda:{rank % torch.cuda.device_count()}`` unless its
caller names a device (``device="cpu"``, the CLI's ``--device cpu``)
(:func:`process_device`); with no CUDA device and no such request it
raises. On a host with one card every rank lands on ``cuda:0``, each with
its own CUDA context.

:func:`initialize_multihost` reads the launcher's variables (the JAX
package's names, both spellings) or the CLI's ``--coordinator``,
``--num_processes`` and ``--process_id``. Rank 0 hosts a
``torch.distributed.TCPStore`` at the coordinator address; the host gathers
of ``parallel.collectives`` go through it (the counterpart of the
coordination-service key-value store the JAX gathers use on the CPU), and
a gloo process group made over the same store carries the tensor
collectives. NCCL is not used: it cannot place two ranks on one GPU, so the
card's one-card host could not test it. With no coordinator configured the
run is one process; a configured launch whose store or group cannot be
reached raises and never carries on alone.

The JAX mesh's axes are axes over processes here (:class:`ProcessMesh`):
:func:`make_mesh` lays ranks on a grid as ``make_mesh`` lays devices (the
last axis innermost, ``data`` inside ``pop``), :func:`gcd_pop_data_mesh` is
the bench's pop × data plan, and :func:`make_axis_groups` makes one gloo
sub-group per line of each axis, once a launch. A JAX host with D local
devices is D processes of the port: the launcher sets
``HYPERSCALEES_PROCESSES_PER_HOST`` (:func:`processes_per_host`), the host
split (:func:`host_slices`) is over the launch's hosts and a host's mesh is
over its D processes.

Not ported: ``shard_map``, ``replicate_to_mesh`` and
``mesh_spans_processes`` (device-mesh plumbing with no meaning when one
process holds one card).
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device

POP_AXIS = "pop"
DATA_AXIS = "data"
TP_AXIS = "tp"

_ENV = (("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"), ("JAX_NUM_PROCESSES", "NUM_PROCESSES"),
        ("JAX_PROCESS_ID", "PROCESS_ID"))

# the coordinator's store, once this process has joined a launch
_STORE: Optional["torch.distributed.Store"] = None


def _env(names: Tuple[str, str]) -> Optional[str]:
    return os.environ.get(names[0]) or os.environ.get(names[1])


def launch_config(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                  process_id: Optional[int] = None) -> Optional[Tuple[str, int, int]]:
    """``(host:port, processes, rank)`` of a configured launch, or ``None``.
    Arguments win over the launcher's variables, each read in both
    spellings (``JAX_COORDINATOR_ADDRESS``/``COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``/``NUM_PROCESSES``, ``JAX_PROCESS_ID``/``PROCESS_ID``)."""
    coord = coordinator or _env(_ENV[0])
    num = num_processes if num_processes is not None else _env(_ENV[1])
    pid = process_id if process_id is not None else _env(_ENV[2])
    if not (coord and num and pid is not None):
        return None
    return coord, int(num), int(pid)


def coordination_store() -> Optional["torch.distributed.Store"]:
    """The launch's ``TCPStore`` (``None`` outside a launch)."""
    return _STORE


def initialize_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> bool:
    """Join the launch this process belongs to; True when it has more than
    one process.

    Idempotent: a process that already joined reports its group's size.
    Without a configured launch (:func:`launch_config`) it returns False
    and nothing is made. Otherwise rank 0 hosts the store at the
    coordinator address, every rank connects to it (waiting up to
    ``HYPERSCALEES_KV_TIMEOUT_MS``), and a gloo process group forms over
    it; a store or group that cannot be reached raises."""
    global _STORE
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    cfg = launch_config(coordinator, num_processes, process_id)
    if cfg is None:
        return False
    coord, n, rank = cfg
    host, sep, port = coord.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got {coord!r}")
    if n < 1 or not 0 <= rank < n:
        raise ValueError(f"process id {rank} is outside a launch of {n} process(es)")
    from .collectives import _kv_timeout_ms

    timeout = datetime.timedelta(milliseconds=_kv_timeout_ms())
    try:
        store = dist.TCPStore(host, int(port), world_size=n, is_master=rank == 0, timeout=timeout,
                              wait_for_workers=True)
        dist.init_process_group("gloo", store=dist.PrefixStore("gloo", store), rank=rank, world_size=n,
                                timeout=timeout)
    except Exception as e:
        raise RuntimeError(f"multi-process launch configured (coordinator {coord}, {n} process(es), this rank "
                           f"{rank}) but its store or process group could not be reached: {e}") from e
    _STORE = store
    atexit.register(_leave_launch)
    return n > 1


def _leave_launch() -> None:
    """At exit, destroy the process groups before the interpreter's own
    teardown: a gloo group left to it can still hold running threads, and
    the process then aborts after its work is done (exit -6)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_device(device: DeviceLike = None) -> torch.device:
    """This process's device: ``device`` where the caller names one;
    otherwise, in a launch of more than one process, ``cuda:{rank %
    device_count}`` (made the current device), and alone the card
    (``device.resolve_device``). Without a CUDA device and no device named,
    it raises."""
    from .collectives import process_count, process_rank

    if device is not None or process_count() <= 1:
        return resolve_device(device)
    resolve_device(None)  # raises without a card
    dev = torch.device("cuda", process_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def local_pop(pop_size: int, n_pop: Optional[int] = None) -> int:
    """Each rank's member count; the population must tile the pop axis
    (``n_pop``, default the process count)."""
    from .collectives import process_count

    n = process_count() if n_pop is None else int(n_pop)
    if pop_size % n:
        raise ValueError(f"pop_size={pop_size} not divisible by pop-axis size {n}")
    return pop_size // n


def host_slices(pop_size: int, n_hosts: int) -> List[Tuple[int, int]]:
    """Contiguous per-process member slices ``[(lo, n), ...]`` of a
    population split over ``n_hosts`` processes: disjoint, in rank order,
    covering ``[0, pop_size)``. Slices are keyed by global member ids and
    the update is replicated, so the same population split over another
    process count replays the same members.

    Raises (naming both numbers) when the population does not tile the
    process count."""
    pop_size, n_hosts = int(pop_size), int(n_hosts)
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    if pop_size % n_hosts:
        raise ValueError(
            f"host-sharded population needs pop_size divisible by the host "
            f"count: pop_size={pop_size}, hosts={n_hosts}"
        )
    lpop = pop_size // n_hosts
    return [(i * lpop, lpop) for i in range(n_hosts)]


def pop_slice_plan(pop_size: int, n_pop: Optional[int] = None) -> Dict[str, object]:
    """How the population lands on the pop axis: one shard per rank
    (``n_pop``, default the process count), each with its contiguous member
    slice and the process that owns it. A population that does not tile the
    axis is padded as the JAX plan pads it (padded slots wrap onto existing
    members); that branch is there for parity with the JAX description
    only, since the port's launches refuse such a population
    (:func:`host_slices`).

    Returns ``{"n_pop", "lpop", "pop_size", "process_count", "shards":
    [{"shard", "members": [lo, hi), "processes": [rank]}, ...]}``."""
    from .collectives import process_count

    n = process_count() if n_pop is None else int(n_pop)
    pop_pad = -(-pop_size // n) * n
    lpop = pop_pad // n
    shards = [{"shard": p, "members": [p * lpop, min((p + 1) * lpop, pop_pad)], "processes": [p]}
              for p in range(n)]
    return {"n_pop": n, "lpop": lpop, "pop_size": int(pop_size), "process_count": process_count(),
            "shards": shards}


# --------------------------------------------------------------------------
# meshes over processes
# --------------------------------------------------------------------------

PROCESSES_PER_HOST_ENV = "HYPERSCALEES_PROCESSES_PER_HOST"

# the gloo sub-group of each mesh line, made once a launch (by ranks)
_AXIS_GROUPS: Dict[Tuple[int, ...], Any] = {}


def processes_per_host() -> int:
    """Processes of one host group (the JAX host's local device count):
    ``$HYPERSCALEES_PROCESSES_PER_HOST`` (``tools.launch_local
    --devices_per_process`` sets it), 1 when unset."""
    v = os.environ.get(PROCESSES_PER_HOST_ENV, "").strip()
    n = int(v) if v else 1
    if n < 1:
        raise ValueError(f"{PROCESSES_PER_HOST_ENV}={v!r} must be >= 1")
    return n


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A named grid of ranks: ``names``/``sizes`` outermost first, ``ranks``
    in grid order (row-major, the last axis innermost), as a JAX mesh holds
    devices."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    ranks: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.ranks)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``{axis: index}`` of ``rank`` (default: this process) on the grid."""
        from .collectives import process_rank

        rank = process_rank() if rank is None else int(rank)
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} is not on the mesh {self.shape} (ranks {list(self.ranks)})")
        return dict(zip(self.names, (int(i) for i in _unravel(self.ranks.index(rank), self.sizes))))

    def index(self, axis: str, rank: Optional[int] = None) -> int:
        """``rank``'s index along ``axis`` (0 for an axis the mesh lacks)."""
        return self.coords(rank).get(axis, 0)

    def line(self, axis: str, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The ranks that share every coordinate but ``axis`` with ``rank``,
        in ``axis`` order (``rank`` alone for an axis the mesh lacks)."""
        from .collectives import process_rank

        rank = process_rank() if rank is None else int(rank)
        if axis not in self.names:
            return (rank,)
        c = self.coords(rank)
        a = self.names.index(axis)
        out = []
        for i in range(self.sizes[a]):
            idx = [c[n] for n in self.names]
            idx[a] = i
            out.append(self.ranks[_ravel(idx, self.sizes)])
        return tuple(out)

    def lines(self, axis: str) -> List[Tuple[int, ...]]:
        """Every line of ``axis`` over the grid, in grid order."""
        seen: Dict[Tuple[int, ...], None] = {}
        for r in self.ranks:
            seen.setdefault(self.line(axis, r), None)
        return list(seen)

    def group(self, axis: str, rank: Optional[int] = None) -> Any:
        """The gloo sub-group of ``rank``'s line along ``axis``
        (:func:`make_axis_groups`); ``None`` for a line of one process."""
        line = self.line(axis, rank)
        if len(line) <= 1:
            return None
        if line not in _AXIS_GROUPS:
            raise RuntimeError(f"no process group for the {axis} line {list(line)}: make_axis_groups has not run")
        return _AXIS_GROUPS[line]


def _unravel(i: int, sizes: Sequence[int]) -> List[int]:
    out = []
    for s in reversed(sizes):
        out.append(i % s)
        i //= s
    return out[::-1]


def _ravel(idx: Sequence[int], sizes: Sequence[int]) -> int:
    i = 0
    for x, s in zip(idx, sizes):
        i = i * s + x
    return i


def make_mesh(axes: Optional[Dict[str, int]] = None, *, ranks: Optional[Sequence[int]] = None) -> ProcessMesh:
    """A named mesh over ``ranks`` (default: every process of the launch).
    ``axes`` maps axis name → size; one ``-1`` entry absorbs the remaining
    ranks. ``make_mesh()`` is the 1-D pop mesh over every rank."""
    from .collectives import process_count

    rks = [int(r) for r in ranks] if ranks is not None else list(range(process_count()))
    if not axes:
        axes = {POP_AXIS: len(rks)}
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    n_wild = sum(1 for s in sizes if s == -1)
    if n_wild > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if n_wild:
        if len(rks) % fixed:
            raise ValueError(f"{len(rks)} devices not divisible by {fixed}")
        sizes = [len(rks) // fixed if s == -1 else s for s in sizes]
    total = math.prod(sizes)
    if total > len(rks):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} devices, have {len(rks)}")
    return ProcessMesh(tuple(names), tuple(sizes), tuple(rks[:total]))


def gcd_pop_data_mesh(pop_size: int, n_devices: int, *, ranks: Optional[Sequence[int]] = None) -> ProcessMesh:
    """The bench's slice-filling plan at ``n_devices`` processes: the pop
    axis takes ``gcd(pop, n)`` of them and the rest shard each member's
    image batch over the data axis (``parallel.pop_eval`` pads both)."""
    n_pop = math.gcd(pop_size, n_devices)
    return make_mesh({POP_AXIS: n_pop, DATA_AXIS: n_devices // n_pop}, ranks=ranks)


def host_meshes(axes: Dict[str, int], n_hosts: int) -> List[ProcessMesh]:
    """One mesh of ``axes`` a host group: host ``h`` holds the consecutive
    ranks ``[h·size, (h + 1)·size)``."""
    size = math.prod(axes.values())
    return [make_mesh(axes, ranks=range(h * size, (h + 1) * size)) for h in range(n_hosts)]


def make_axis_groups(meshes: Sequence[ProcessMesh]) -> None:
    """Make the gloo sub-group of every line of every axis longer than one
    of ``meshes`` (every host's mesh of the launch), once a launch. Every
    process calls it with the same meshes: ``new_group`` is collective over
    the launch's group."""
    import torch.distributed as dist

    for mesh in meshes:
        for axis in mesh.names:
            for line in mesh.lines(axis):
                if len(line) > 1 and line not in _AXIS_GROUPS:
                    _AXIS_GROUPS[line] = dist.new_group(list(line), backend="gloo")
