"""The program ledger: one ``programs.jsonl`` record per captured program,
with its FLOPs and bytes counted, and the roofline (port of the parts of
``hyperscalees_t2i_tpu/obs/xla_cost.py`` that have a counterpart).

The JAX package reads a program's cost from the compiler
(``compiled.cost_analysis()``). A PyTorch step has no compiler to ask, so
the port counts it: :class:`CostCounter` is a ``TorchDispatchMode`` that,
over one eager run of the program (the plan's warm-up epoch, the epoch its
CUDA graph then captures), sums

- FLOPs: ``torch.utils.flop_counter``'s registered formulas (``mm``,
  ``bmm``, ``addmm``, convolutions, ...) over the aten ops, after
  decomposing the composite ops that reach the mode (as ``FlopCounterMode``
  does);
- bytes: every op's tensor inputs and outputs once (views and bare
  allocations move nothing and count nothing): an op-level upper bound, as
  XLA's ``bytes_accessed`` is. A copy between devices (a constant made on
  the host and moved once, at the warm-up; a graph's replays never run it)
  is not the program's work and counts nothing;
- each hand-written kernel's own count, added by its wrapper
  (:func:`kernel_cost`): a ``ctypes`` launch is invisible to the mode, and
  on the CPU the plain version would be counted op by op with more bytes
  than the kernel moves, so the wrapper counts its formula on both devices
  and pauses the mode inside. The card and the CPU count an epoch alike.

A Python dispatch mode costs tens of microseconds an op, and an epoch
repeats one unit of work many times: each member tile's generate → decode
→ reward call (``parallel/pop_eval.py``) runs the same ops on other data (a
step captured as a CUDA graph has no data-dependent control flow).
:func:`repeated` counts a unit's first two occurrences of a shape in full
(the first may hold one-time work, a lazily made buffer) and adds the
second one's counts for every later one, with the mode off. The totals are
the full count's (``CostCounter(repeat_units=False)`` counts every op;
``tests/test_torch_program_cost.py`` holds the two equal).

:func:`record_program` writes a plan's record (site, label, chain,
geometry, the device, the warm-up, capture and instantiate seconds and the
graph pool's bytes of ``utils.graphs.EntryStats``, ``flops``,
``bytes_accessed``, ``intensity`` and the kernels' share) to the installed
:class:`ProgramLedger`. The XLA-only fields of the reference (StableHLO
statistics, the donation audit, collective and legalization statistics)
have no counterpart and are left out, and the records publish no
``obs/program_*`` gauges: a counted FLOP is not XLA's, and a row key of the
reference must not carry another measure.

:func:`roofline` classifies a measured step against the hardware floors;
the peaks come from ``utils/mfu.py``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# allocations that touch no memory: counted as moving nothing
_NO_BYTES = frozenset((_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
                       _aten.new_empty.default, _aten.new_empty_strided.default))
# copies that may cross devices (not counted when they do)
_COPIES = frozenset((_aten._to_copy.default, _aten.copy_.default))

# the counters active on this process, innermost last
_ACTIVE: List["CostCounter"] = []


def _tensors(values, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors among ``values`` and one level of lists/tuples in them
    (an aten op's arguments and results nest no deeper)."""
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _nbytes(tensors: List[torch.Tensor]) -> int:
    seen, n = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            n += t.numel() * t.element_size()
    return n


def _op_info(func) -> Tuple[Any, bool, bool]:
    """``(flop formula or None, moves bytes, has a composite decomposition)``."""
    name = func.name()
    composite = (torch._C.DispatchKey.CompositeImplicitAutograd in func.py_kernels
                 or torch._C._dispatch_has_kernel_for_dispatch_key(name, torch._C.DispatchKey.CompositeImplicitAutograd))
    return flop_registry.get(func.overloadpacket), not func.is_view and func not in _NO_BYTES, composite


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of the aten ops run under it (see the
    module note), and the hand-written kernels' own counts: ``flops``,
    ``bytes_accessed``, ``ops`` (aten ops that move bytes) and ``kernels`` (wrapper
    name → ``{"calls", "flops", "bytes"}``). ``repeat_units=False`` counts
    every occurrence of a :func:`repeated` unit in full."""

    def __init__(self, repeat_units: bool = True) -> None:
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.repeat_units = repeat_units
        self._paused = 0
        self._info: Dict[Any, Tuple[Any, bool, bool]] = {}  # op → _op_info
        self._units: Dict[Any, List[Any]] = {}  # unit key → [occurrences, the second one's counts]

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _op_info(func)
        flop_fn, moves, composite = info
        if flop_fn is None and composite:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            self._info[func] = (flop_fn, moves, False)
        out = func(*args, **kwargs)
        if func in _COPIES and args[0].device != (args[1].device if func is _aten.copy_.default else out.device):
            return out  # a transfer between devices
        if flop_fn is not None:
            self.flops += int(flop_fn(*args, **kwargs, out_val=out))
        if moves:
            self.ops += 1
            self.bytes_accessed += _nbytes(_tensors(kwargs.values(), _tensors(args, []))) + \
                _nbytes(_tensors((out,), []))
        return out

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        slot = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        slot["calls"] += 1
        slot["flops"] += int(flops)
        slot["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes_accessed += int(nbytes)

    def _state(self) -> Tuple[int, int, int, Dict[str, Dict[str, int]]]:
        return self.flops, self.bytes_accessed, self.ops, {k: dict(v) for k, v in self.kernels.items()}

    def _add(self, delta: Tuple[int, int, int, Dict[str, Dict[str, int]]]) -> None:
        self.flops += delta[0]
        self.bytes_accessed += delta[1]
        self.ops += delta[2]
        for name, d in delta[3].items():
            slot = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
            for k in slot:
                slot[k] += d[k]

    def summary(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed, "counted_ops": self.ops,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


@contextlib.contextmanager
def repeated(key: Any):
    """A unit of work that an epoch repeats with the same ops (see the
    module note), keyed by its shape: under a :class:`CostCounter` its first
    two occurrences are counted in full, every later one adds the second
    one's counts and runs with the mode off. Outside a counter, nothing."""
    counter = active_counter()
    if counter is None or counter._paused or not counter.repeat_units:
        yield
        return
    unit = counter._units.setdefault(key, [0, None])
    unit[0] += 1
    if unit[1] is not None:
        counter._paused += 1  # the kernel wrappers inside count nothing either
        try:
            with _disable_current_modes():
                yield
        finally:
            counter._paused -= 1
        counter._add(unit[1])
        return
    before = counter._state()
    yield
    if unit[0] == 2:
        after = counter._state()
        unit[1] = (after[0] - before[0], after[1] - before[1], after[2] - before[2],
                   {k: {f: v[f] - before[3].get(k, {}).get(f, 0) for f in v} for k, v in after[3].items()
                    if v != before[3].get(k)})


def active_counter() -> Optional[CostCounter]:
    """The innermost :class:`CostCounter` running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def kernel_cost(cost: Callable[..., Tuple[int, int]]):
    """Decorator for a kernel wrapper: under a :class:`CostCounter`, add
    ``cost(*args, **kwargs) = (flops, bytes)`` under the wrapper's name and
    run the wrapper with the counter paused, so nothing inside it (its
    plain version on the CPU, its checks and allocations on the card) is
    counted again. Outside a counter the wrapper runs as it is."""

    def wrap(fn):
        name = fn.__name__

        @functools.wraps(fn)
        def counted(*args, **kwargs):
            counter = active_counter()
            if counter is None or counter._paused:
                return fn(*args, **kwargs)
            flops, nbytes = cost(*args, **kwargs)
            counter.add_kernel(name, flops, nbytes)
            counter._paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                counter._paused -= 1

        return counted

    return wrap


def tensor_bytes(*tensors: Optional[torch.Tensor]) -> int:
    """Bytes of the given tensors (``None`` counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(
    flops: Optional[float],
    bytes_accessed: Optional[float],
    measured_step_s: Optional[float] = None,
    *,
    peak_flops: Optional[float],
    hbm_bw: Optional[float],
    n_devices: int = 1,
    latency_factor: float = 2.0,
    collective_bytes: Optional[float] = None,
    ici_bw: Optional[float] = None,
) -> Dict[str, Any]:
    """Classify one step against the hardware roofline.

    ``t_compute_s = flops / (peak_flops·n)`` and ``t_bandwidth_s =
    bytes / (hbm_bw·n)`` are the two hardware floors; ``t_comms_s =
    collective_bytes / ici_bw`` joins them when both are known (the port
    runs one process and passes neither). ``t_roofline_s`` is the max of
    the known floors. The verdict:

    - **latency** — measured > ``latency_factor`` × roofline: the step is
      dominated by costs the program model does not see (launches, host
      syncs, idle gaps);
    - **comms** — the interconnect floor is the (strictly) largest;
    - **compute** — compute floor ≥ bandwidth floor;
    - **bandwidth** — bandwidth floor > compute floor;
    - ``None`` — peaks unknown (the CPU, an unknown card) or no cost data.
    """
    n = max(int(n_devices), 1)
    t_c = flops / (peak_flops * n) if flops and peak_flops else None
    t_b = bytes_accessed / (hbm_bw * n) if bytes_accessed and hbm_bw else None
    t_m = collective_bytes / ici_bw if collective_bytes and ici_bw else None
    t_roof = max(t_c or 0.0, t_b or 0.0, t_m or 0.0) or None
    intensity = flops / bytes_accessed if flops and bytes_accessed else None
    ridge = peak_flops / hbm_bw if peak_flops and hbm_bw else None
    bound = None
    if t_roof is not None:
        if measured_step_s is not None and measured_step_s > latency_factor * t_roof:
            bound = "latency"
        elif t_m is not None and t_m > max(t_c or 0.0, t_b or 0.0):
            bound = "comms"
        elif (t_c or 0.0) >= (t_b or 0.0):
            bound = "compute"
        else:
            bound = "bandwidth"
    return {
        "t_compute_s": t_c,
        "t_bandwidth_s": t_b,
        "t_comms_s": t_m,
        "t_roofline_s": t_roof,
        "intensity": intensity,
        "ridge_intensity": ridge,
        "bound": bound,
    }


class ProgramLedger:
    """Append-only ``programs.jsonl`` writer, one JSON line per program.
    ``ProgramLedger(None)`` is a disabled no-op. Writes are lock-guarded and
    never raise: losing a ledger line must not kill a training run."""

    def __init__(self, path: Optional[Union[str, Path]] = None):
        self.path = Path(path) if path is not None else None
        self._lock = threading.Lock()
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def write(self, record: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        line = json.dumps(record, default=str) + "\n"
        try:
            with self._lock, self.path.open("a") as f:
                f.write(line)
        except OSError:
            pass


_NULL_LEDGER = ProgramLedger(None)
_LEDGER: ProgramLedger = _NULL_LEDGER
# geometry noted by layers that know it where the program is built
# (parallel/pop_eval.py), merged into the next record
_GEOMETRY_CONTEXT: Dict[str, Any] = {}


def set_ledger(ledger: Optional[ProgramLedger]) -> ProgramLedger:
    """Install the process-global ledger (``None`` → disabled). Returns it."""
    global _LEDGER
    _LEDGER = ledger if ledger is not None else _NULL_LEDGER
    return _LEDGER


def get_ledger() -> ProgramLedger:
    return _LEDGER


def note_program_geometry(**attrs: Any) -> None:
    """Merge geometry facts into the context attached to the next record."""
    _GEOMETRY_CONTEXT.update(attrs)


def take_program_geometry() -> Dict[str, Any]:
    """The noted geometry context, cleared: :func:`record_program` takes
    it, and a build that writes no record drops it."""
    global _GEOMETRY_CONTEXT
    noted, _GEOMETRY_CONTEXT = _GEOMETRY_CONTEXT, {}
    return noted


def record_program(
    *,
    site: str,
    label: str,
    stats: Any,
    cost: Optional[Dict[str, Any]],
    device: Union[str, torch.device],
    geometry: Optional[Dict[str, Any]] = None,
    chain: int = 1,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build one ledger record from a program's ``utils.graphs.EntryStats``
    and its counted ``cost`` (:meth:`CostCounter.summary`), write it to the
    installed ledger and return it. Consumes the noted geometry context.
    Never raises."""
    from ..utils.mfu import device_kind

    noted = take_program_geometry()
    try:
        dev = torch.device(device)
        rec: Dict[str, Any] = {
            "ts": time.time(),
            "site": site,
            "label": label,
            "chain": int(chain),
            "geometry": {**noted, **(geometry or {})},
            "platform": dev.type,
            "device_kind": device_kind(dev),
            "n_devices": 1,
        }
        for field in ("warmup_s", "capture_s", "instantiate_s", "pool_bytes", "workspace_bytes"):
            rec[field] = getattr(stats, field, None)
        cost = cost or {}
        rec["flops"] = cost.get("flops") or None
        rec["bytes_accessed"] = cost.get("bytes_accessed") or None
        rec["counted_ops"] = cost.get("counted_ops")
        rec["kernels"] = cost.get("kernels")
        if rec["flops"] and rec["bytes_accessed"]:
            rec["intensity"] = rec["flops"] / rec["bytes_accessed"]
        if extra:
            rec.update(extra)
    except Exception:
        return {}
    get_ledger().write(rec)
    return rec


def load_programs(path: Union[str, Path]) -> list:
    """Ledger records from ``programs.jsonl`` (or a run dir containing one),
    in file order; unparseable lines skipped, missing file → ``[]``."""
    p = Path(path)
    if p.is_dir():
        p = p / "programs.jsonl"
    if not p.exists():
        return []
    out = []
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "site" in rec:
            out.append(rec)
    return out
