"""Captured programs: the port's counterpart of the JAX package's AOT
compile cache (``hyperscalees_t2i_tpu/train/trainer.py`` keeps one compiled
ES step per (m, r) plan, ``serve/engine.py`` one program per serving
geometry).

An eager PyTorch step launches every kernel from Python, so the host's
launch pace sets the epoch time. A ``torch.cuda.CUDAGraph`` records the
step's launches once and replays them as one.

:class:`GraphCache` holds one entry per key. An entry's first call is its
warm-up: the function runs eagerly with the call's own inputs on the side
stream the capture then uses, and that run's outputs are the call's result
(the kernels' ``nvcc`` builds, their ``_plan`` runs and the allocator's
first blocks all happen here). The entry then allocates a static buffer for
every tensor input and captures one graph in a private memory pool, inside
the tracer's ``compile`` span, counted under the registry's ``compiles``
counter and ``compile_cache_entries`` gauge (or the names the cache is
given). Every later call copies its inputs into the buffers, replays, and
returns the output buffers, which the next replay of the entry overwrites:
a caller that keeps outputs across calls clones them. Non-tensor inputs are
part of the program and must not change between calls.

A kernel wrapper adds one to its ``launches`` counter where it launches its
kernel, and nowhere else: not while a graph is captured (nothing runs
then), and a replay, which runs the captured kernels without the wrappers,
adds nothing. A replay's kernels are counted on the device, by name, from a
``torch.profiler`` trace (``chip_smoke.py``).

Programs run under ``torch.inference_mode()``: the ES step and serving need
no gradient. On the CPU there are no graphs: an entry runs its function
eagerly at every call (the rule of the kernel wrappers: CPU tensors take the
plain path). On the card a failed capture raises; nothing falls back to
eager. ``graph=False`` gives eager entries on the card too, for A/B timing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device

_LEAF = object()


def _flatten(tree: Any) -> Tuple[List[torch.Tensor], Any]:
    """``(tensor leaves, spec)``: dicts (keys sorted), lists, tuples and
    named tuples are containers; any other non-tensor value is part of the
    spec (compared by ``==``)."""
    leaves: List[torch.Tensor] = []

    def walk(t: Any) -> Any:
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return _LEAF
        if isinstance(t, dict):
            return ("dict", tuple((k, walk(t[k])) for k in sorted(t)))
        if isinstance(t, (list, tuple)):
            return (type(t), tuple(walk(v) for v in t))
        return ("value", t)

    return leaves, walk(tree)


def _unflatten(spec: Any, leaves: List[torch.Tensor]) -> Any:
    it = iter(leaves)

    def build(s: Any) -> Any:
        if s is _LEAF:
            return next(it)
        kind, body = s
        if kind == "dict":
            return {k: build(v) for k, v in body}
        if kind == "value":
            return body
        items = [build(v) for v in body]
        return kind(*items) if hasattr(kind, "_fields") else kind(items)

    return build(spec)


def graphs_on(device: torch.device) -> bool:
    """Whether entries on ``device`` capture graphs: only on the card."""
    return device.type == "cuda"


@dataclasses.dataclass
class Captured:
    """One captured graph: ``replay()`` reruns it into ``outputs``;
    ``pool_bytes`` is what its private memory pool holds on the device."""

    replay: Callable[[], None]
    outputs: Any
    capture_s: float
    instantiate_s: float
    pool_bytes: int


def capture(fn: Callable, static_args: Tuple[Any, ...], stream: Optional["torch.cuda.Stream"]) -> Captured:
    """Capture ``fn(*static_args)`` on ``stream`` into a new private pool;
    the graph is instantiated separately, so both times are read."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    with torch.cuda.graph(g, stream=stream):
        outputs = fn(*static_args)
    t1 = time.perf_counter()
    g.instantiate()
    torch.cuda.synchronize(stream.device)
    t2 = time.perf_counter()
    return Captured(g.replay, outputs, t1 - t0, t2 - t1, pool_bytes(g.pool()))


def pool_bytes(pool: Tuple[int, int]) -> int:
    """Device memory held by the segments of the allocator's pool ``pool``
    (a graph's private pool): the allocator's snapshot, not a difference
    of totals that other frees would move."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


@dataclasses.dataclass
class EntryStats:
    """What building and running one entry cost."""

    warmup_s: float = 0.0  # the first call's eager run, host clock to a synchronize
    capture_s: float = 0.0
    instantiate_s: float = 0.0
    pool_bytes: int = 0  # device memory the graph's private pool holds
    replays: int = 0


class _Entry:
    def __init__(self, fn: Callable, graphed: bool):
        self.fn = fn
        self.graphed = graphed
        self.spec: Any = None
        self.shapes: List[Tuple[Tuple[int, ...], torch.dtype, torch.device]] = []
        self.static: List[torch.Tensor] = []
        self.captured: Optional[Captured] = None
        self.stats = EntryStats()

    def replay(self, args: Tuple[Any, ...]) -> Any:
        leaves, spec = _flatten(args)
        if spec != self.spec or [(tuple(t.shape), t.dtype) for t in leaves] != [s[:2] for s in self.shapes]:
            raise ValueError("a captured program was called with inputs of another structure, shape or dtype "
                             "than it was captured for")
        with torch.inference_mode():
            for dst, src in zip(self.static, leaves):
                if src is not dst:
                    dst.copy_(src)
            self.captured.replay()
        self.stats.replays += 1
        return self.captured.outputs


class GraphCache:
    """Captured programs by key on one device (see the module note).

    ``registry``/``tracer`` (``obs.metrics.MetricsRegistry``,
    ``obs.trace.Tracer``), where given, see each new entry: a ``compile``
    span around the capture (attributes ``span_attrs(key)``), ``counter``
    incremented and ``gauge`` set to the number of entries."""

    def __init__(self, device: DeviceLike = None, *, graph: bool = True, registry: Any = None, tracer: Any = None,
                 counter: str = "compiles", gauge: str = "compile_cache_entries",
                 span_attrs: Optional[Callable[[Hashable], Dict[str, Any]]] = None):
        self.device = resolve_device(device)
        self.graphed = bool(graph) and graphs_on(self.device)
        self.registry, self.tracer = registry, tracer
        self.counter, self.gauge = counter, gauge
        self.span_attrs = span_attrs or (lambda key: {"key": str(key)})
        self.entries: Dict[Hashable, _Entry] = {}
        self._stream: Optional["torch.cuda.Stream"] = None

    def __call__(self, key: Hashable, fn: Callable, *args: Any) -> Any:
        """Entry ``key``'s program on ``args``: built from ``fn`` at the
        key's first call, later calls ignore ``fn``."""
        entry = self.entries.get(key)
        if entry is None:
            return self._build(key, fn, args)
        if not entry.graphed:
            with torch.inference_mode():
                return entry.fn(*args)
        return entry.replay(args)

    def _span(self, key: Hashable):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span("compile", **self.span_attrs(key))

    def _count_entry(self) -> None:
        if self.registry is not None:
            self.registry.inc(self.counter)
            self.registry.gauge(self.gauge, len(self.entries))

    def _build(self, key: Hashable, fn: Callable, args: Tuple[Any, ...]) -> Any:
        entry = _Entry(fn, self.graphed)
        if not self.graphed:
            with self._span(key):
                self.entries[key] = entry
            self._count_entry()
            with torch.inference_mode():
                return fn(*args)
        dev = self.device
        cuda = dev.type == "cuda"  # False only where a test stands in for the capture
        leaves, entry.spec = _flatten(args)
        off = sorted({str(t.device) for t in leaves if t.device.type != dev.type})
        if off:
            raise ValueError(f"a program captured on {dev} takes its tensors there, got tensors on {off}")
        entry.shapes = [(tuple(t.shape), t.dtype, t.device) for t in leaves]
        t0 = time.perf_counter()
        side = None
        if cuda:
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            side, main = self._stream, torch.cuda.current_stream(dev)
            side.wait_stream(main)
        with torch.inference_mode(), (torch.cuda.stream(side) if cuda else contextlib.nullcontext()):
            outputs = fn(*args)  # the warm-up: this call's result
        if cuda:
            main.wait_stream(side)
            for t in _flatten(outputs)[0]:
                if t.device.type == "cuda":
                    t.record_stream(main)  # used on the caller's stream from here on
            torch.cuda.synchronize(dev)
        entry.stats.warmup_s = time.perf_counter() - t0
        with torch.inference_mode():  # the buffers start as this call's inputs
            entry.static = [t.clone() for t in leaves]
        static_args = _unflatten(entry.spec, entry.static)
        with self._span(key):
            with torch.inference_mode():
                entry.captured = capture(fn, static_args, side)
            self.entries[key] = entry
        entry.stats.capture_s = entry.captured.capture_s
        entry.stats.instantiate_s = entry.captured.instantiate_s
        entry.stats.pool_bytes = entry.captured.pool_bytes
        self._count_entry()
        return outputs

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """``{str(key): EntryStats as a dict}`` of the graphed entries."""
        return {str(k): dataclasses.asdict(e.stats) for k, e in self.entries.items() if e.graphed}

    def drop(self, key: Hashable) -> None:
        """Drop one entry (see :meth:`clear`)."""
        del self.entries[key]
        if self.registry is not None:
            self.registry.gauge(self.gauge, len(self.entries))

    def clear(self) -> None:
        """Drop every entry (its graph, pool and buffers go with the last
        reference to its outputs)."""
        self.entries.clear()
        if self.registry is not None:
            self.registry.gauge(self.gauge, 0)
