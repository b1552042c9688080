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

Not ported: ``shard_map``, ``replicate_to_mesh`` and
``mesh_spans_processes`` (device-mesh plumbing with no meaning when one
process holds one card), and ``make_mesh``'s ``data`` axis with
``gcd_pop_data_mesh`` (one member's batch sharded across devices: queue A
item 7 part 4, with ``tp``).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Tuple

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
    return n > 1


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
