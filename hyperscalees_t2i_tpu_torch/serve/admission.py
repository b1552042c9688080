"""Serving admission: refuse a geometry that would not fit the card before it
runs at full width (port of ``hyperscalees_t2i_tpu/serve/admission.py``).

The JAX engine reads a compiled program's ``memory_analysis`` peak. The
port's programs are eager PyTorch with ctypes kernels, captured as CUDA
graphs, and have no such analysis, so the peak is measured on smaller
versions of the same program:

- :func:`resolve_hbm_budget`: an override wins; else, on the card, its
  total memory (``torch.cuda.mem_get_info(device)[1]``), the source naming
  ``torch.cuda.get_device_name``; on the CPU the gate is unarmed and
  recorded as such, as the JAX package does for an unknown chip.
- :func:`program_bytes` measures what one built program holds above the
  resident base: under a graph, the allocated bytes its build left (static
  inputs, outputs) plus its private pool (the allocator's snapshot of the
  pool's segments); eager, the segments of a private memory pool that the
  build allocates into (its high-water mark, read without touching the
  process's peak statistics). On the CPU, which keeps no allocator
  statistics, its inputs and outputs (a lower bound).
- :func:`extrapolate` takes that quantity at fewer lanes than
  ``adapter_batch`` to ``adapter_batch`` lanes. From probes at 1 and 2
  lanes (``adapter_batch`` ≥ 3), linearly: ``p(A) = p(1) + (A −
  1)·(p(2) − p(1))``, exact for a linear program when one chunk holds
  every lane (``member_batch`` 0) or one lane (``member_batch`` 1), an
  over-estimate when ``1 < member_batch < adapter_batch``. From the probe
  at 1 lane alone (``adapter_batch`` 2): ``A·p(1)``, an upper bound for a
  program whose bytes are a fixed part plus a part per lane. At
  ``adapter_batch`` 1 nothing smaller exists: the gate measures the build
  instead of predicting it, and refuses after it.
- :func:`check_fit` compares the resident base plus the estimate with the
  budget and raises :class:`ServeAdmissionError` naming both numbers.
- :func:`analyze_serve_geometry` gives that answer for a rung's geometry
  before any engine serves it (``tools/preflight.py --serve``).

The engine runs the probes, checks, and only then builds the full-width
program; after it is built it records the same quantity measured beside the
estimate. Estimates are kept per backend and geometry
(:func:`remember_estimate`), so a second engine on the same backend decides
without running anything.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import torch


class ServeShedError(RuntimeError):
    """A submit refused by the overload layer (``serve/overload.py``):
    ``reason`` is ``deadline``, ``brownout_priority`` or ``breaker_open``.
    Its own type, so the load harness counts sheds apart from errors."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"request shed ({reason})" + (f": {detail}" if detail else ""))


class ServeAdmissionError(RuntimeError):
    """A serving geometry refused by the fit gate: its estimated peak exceeds
    the budget. Carries both numbers."""

    def __init__(self, label: str, peak_bytes: float, budget_bytes: float, budget_source: str):
        self.label = label
        self.peak_bytes = float(peak_bytes)
        self.budget_bytes = float(budget_bytes)
        self.budget_source = budget_source
        super().__init__(
            f"serve admission REFUSED for {label}: est peak device memory {peak_bytes / 1e9:.3f} GB > budget "
            f"{budget_bytes / 1e9:.3f} GB ({budget_source}) — shrink adapter_batch/images_per_request"
        )


def resolve_hbm_budget(override_bytes: Optional[float] = None,
                       device: Optional[torch.device] = None) -> Tuple[Optional[float], str]:
    """``(budget bytes or None, source)``: the override, else the card's
    total memory, else ``None`` (the gate is unarmed)."""
    if override_bytes is not None:
        return float(override_bytes), "configured hbm_budget_bytes"
    if device is not None and torch.device(device).type == "cuda":
        dev = torch.device(device)
        total = torch.cuda.mem_get_info(dev)[1]
        return float(total), f"device capacity ({torch.cuda.get_device_name(dev)}, torch.cuda.mem_get_info)"
    return None, "unknown (gate unarmed)"


def check_fit(label: str, peak_bytes: Optional[float], budget_bytes: Optional[float], budget_source: str) -> bool:
    """True when the gate armed and passed; False when it could not arm (no
    peak or no budget); raises :class:`ServeAdmissionError` on a no-fit."""
    if peak_bytes is None or budget_bytes is None:
        return False
    if peak_bytes > budget_bytes:
        raise ServeAdmissionError(label, peak_bytes, budget_bytes, budget_source)
    return True


def parse_serve_geometry(spec: str) -> Tuple[str, int, Optional[int]]:
    """``RUNG:ADAPTERS[:RANK]`` → ``(rung, adapter_batch, rank or None)``."""
    parts = [p.strip() for p in spec.split(":") if p.strip()]
    if not 2 <= len(parts) <= 3:
        raise ValueError(f"serve geometry must be RUNG:ADAPTERS[:RANK], got {spec!r}")
    rung = parts[0]
    try:
        adapters = int(parts[1])
        rank = int(parts[2]) if len(parts) == 3 else None
    except ValueError:
        raise ValueError(f"serve geometry ADAPTERS/RANK must be integers, got {spec!r}") from None
    if adapters < 1 or (rank is not None and rank < 1):
        raise ValueError(f"serve geometry values must be >= 1, got {spec!r}")
    return rung, adapters, rank


def probe_lanes(lanes: int) -> Tuple[int, ...]:
    """The lane counts probed for a geometry of ``lanes`` lanes: 1 and 2,
    each below ``lanes``."""
    return tuple(n for n in (1, 2) if n < int(lanes))


def extrapolate(probes: Dict[int, float], lanes: int) -> float:
    """``p(lanes)`` from the probes ``{1: p(1)[, 2: p(2)]}``: linearly
    through both (never below ``p(1)``), or ``lanes·p(1)`` from one."""
    p1 = float(probes[1])
    if 2 not in probes:
        return int(lanes) * p1
    return max(p1, p1 + (int(lanes) - 1) * (float(probes[2]) - p1))


def _tensor_bytes(tree: Any) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def resident_bytes(backend: Any, device: torch.device) -> int:
    """What is resident before a program is built: on the card, the
    allocator's allocated bytes; on the CPU, the backend's module buffers and
    tensors."""
    if device.type == "cuda":
        return int(torch.cuda.memory_allocated(device))
    total = 0
    for v in vars(backend).values():
        if isinstance(v, torch.nn.Module):
            total += sum(b.numel() * b.element_size() for b in v.buffers())
            total += sum(p.numel() * p.element_size() for p in v.parameters())
        elif isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
    return total


def program_bytes(build, args: Tuple[Any, ...], device: torch.device,
                  pool_bytes: Optional[Callable[[], int]] = None) -> Tuple[Any, int]:
    """``(outputs, bytes)``: ``build(*args)`` run once (the program's first
    call: warm-up, and capture under a graph) and what it holds above the
    resident base (see the module note). ``pool_bytes``, given for a graphed
    program, reads its pool after the build."""
    if device.type != "cuda":
        out = build(*args)
        return out, _tensor_bytes(args) + _tensor_bytes(out)
    torch.cuda.synchronize(device)
    if pool_bytes is None:
        # every allocation of this thread lands in the private pool; its
        # segments are the build's high-water mark (they stay reserved)
        from ..utils.graphs import pool_bytes as segment_bytes

        pool = torch.cuda.MemPool()
        with torch.cuda.device(device), torch.cuda.use_mem_pool(pool):
            out = build(*args)
            torch.cuda.synchronize(device)
            used = segment_bytes(pool.id)
        return out, int(used)
    base = torch.cuda.memory_allocated(device)
    out = build(*args)
    torch.cuda.synchronize(device)
    return out, int(torch.cuda.memory_allocated(device) - base) + int(pool_bytes())


def analyze_serve_geometry(rung: str, adapter_batch: int, images_per_request: Optional[int] = None,
                           rank: Optional[int] = None, member_batch: Optional[int] = None,
                           device: Optional[torch.device] = None, ledger: Any = None, seed: int = 0) -> Dict[str, Any]:
    """The admission gate's answer for one serving geometry, before an
    engine serves it: a rung's serving backend (``SERVE_PLAN``, random
    weights from ``seed``; ``rank`` overrides the LoRA rank) and an engine
    of ``adapter_batch`` lanes, whose program is measured at
    the lanes of :func:`probe_lanes` and extrapolated, as the engine's gate
    does (at ``adapter_batch`` 1, the build itself is measured). Returns the
    ``site="serve"`` record (``base_bytes``, ``program_bytes``, ``peak_bytes``
    their sum, ``probe_bytes``), written to ``ledger`` when given."""
    import dataclasses
    import time

    from ..backends.sana_backend import build_serve_backend
    from ..device import resolve_device
    from ..rungs import RUNG_BASE_QUANT, RUNG_PLAN, SERVE_PLAN, sana_rung_model
    from ..utils.mfu import device_kind
    from .engine import ServeConfig, ServeEngine

    if rung not in SERVE_PLAN:
        raise ValueError(f"unknown serving rung {rung!r} (have: {sorted(SERVE_PLAN)})")
    plan = SERVE_PLAN[rung]
    A = int(adapter_batch)
    B = int(images_per_request if images_per_request is not None else plan["images_per_request"])
    mb = int(member_batch if member_batch is not None else plan["member_batch"])
    base_quant = RUNG_BASE_QUANT[rung]
    dev = resolve_device(device)
    bcfg = sana_rung_model(RUNG_PLAN[rung][0])["bcfg"]
    if rank is not None:
        bcfg = dataclasses.replace(bcfg, lora_r=int(rank))
    t0 = time.perf_counter()
    backend = build_serve_backend(bcfg, base_quant, dev, seed=seed)
    engine = ServeEngine(backend, ServeConfig(adapter_batch=A, images_per_request=B, member_batch=mb, device=dev))
    base = resident_bytes(backend, dev)
    probes = {n: float(engine._probe(n, B, None)) for n in (probe_lanes(A) or (A,))}
    used = extrapolate(probes, A) if probe_lanes(A) else probes[A]
    rec = {"ts": time.time(), "site": "serve", "label": f"serve-{rung}-a{A}", "rung": rung,
           "platform": dev.type, "device_kind": device_kind(dev), "n_devices": 1,
           "geometry": {"rung": rung, "adapter_batch": A, "images_per_request": B, "member_batch": mb,
                        "lora_rank": rank, "base_quant": base_quant, "graph": engine.programs.graphed},
           "imgs_per_dispatch": A * B, "base_bytes": float(base), "probe_bytes": probes,
           "program_bytes": float(used), "peak_bytes": float(base + used),
           "build_s": time.perf_counter() - t0}
    del engine, backend
    if ledger is not None:
        ledger.write(rec)
    return rec


# backend -> {geometry: program bytes estimated at adapter_batch lanes}
_ESTIMATES: "weakref.WeakKeyDictionary[Any, Dict[Hashable, Dict[str, Any]]]" = weakref.WeakKeyDictionary()


def remembered_estimate(backend: Any, geometry: Hashable) -> Optional[Dict[str, Any]]:
    return _ESTIMATES.get(backend, {}).get(geometry)


def remember_estimate(backend: Any, geometry: Hashable, estimate: Dict[str, Any]) -> None:
    _ESTIMATES.setdefault(backend, {})[geometry] = estimate


__all__ = [
    "ServeAdmissionError",
    "analyze_serve_geometry",
    "ServeShedError",
    "check_fit",
    "extrapolate",
    "parse_serve_geometry",
    "probe_lanes",
    "program_bytes",
    "remember_estimate",
    "remembered_estimate",
    "resident_bytes",
    "resolve_hbm_budget",
]
