"""Device-time attribution from ``torch.profiler`` traces (the port's
counterpart of ``hyperscalees_t2i_tpu/obs/xplane.py``).

The trainer's profile window (``TrainConfig.profile_epochs``) and the
serving engine's (``ServeConfig.profile_dir``) export the Chrome-trace JSON
that ``torch.profiler.profile.export_chrome_trace`` writes: a
``traceEvents`` list of complete events (``"ph": "X"``) with ``ts`` and
``dur`` in microseconds on one clock for the host and the card. Each
dispatch runs inside a ``torch.profiler.record_function`` range named
``<site>/<label>`` (``train/es_step_m4r1``; the rung runner's
``bench/<rung>``), a host event of category ``user_annotation``; the
card's events are the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``.

Three layers, as in the reference:

- reading: :func:`find_trace_files`, :func:`load_trace`; a truncated or
  malformed file raises :class:`TraceParseError`, never a silently empty
  table;
- aggregation: :func:`program_durations` (device time per range: the union
  of the device intervals between the range's start and its end, the
  dispatch's read-back synchronize; a CUDA graph's replayed kernels carry
  no correlation to the host op that launched them, so they are attributed
  by time window, which is exact while one dispatch is in flight),
  :func:`op_durations` (device time per kernel name) and
  :func:`kernel_evidence` (K1-K4's launches found by their whole kernel
  names, :data:`WRAPPER_KERNELS`);
- attribution: :func:`join_ledger` matches ranges to ``programs.jsonl``
  records (``obs/program_cost.py``) by normalized name.

:func:`start_profile` and :func:`stop_profile` open and close a window
(the host's and, on the card, the device's activity) and write its trace.

:func:`live_events`, :func:`device_kernels` and :func:`profiled_launches`
read a live ``torch.profiler`` object the same way (``chip_smoke.py`` uses them).
:func:`build_trace` writes synthetic traces for tests. Stdlib-only at
import.
"""

from __future__ import annotations

import functools
import json
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

__all__ = [
    "DEVICE_CATEGORIES",
    "TraceParseError",
    "WRAPPER_KERNELS",
    "build_trace",
    "device_events",
    "device_kernels",
    "find_trace_files",
    "join_ledger",
    "kernel_evidence",
    "live_events",
    "load_trace",
    "normalize_program_name",
    "op_durations",
    "profiled_launches",
    "program_durations",
    "range_events",
    "start_profile",
    "stop_profile",
    "wrapper_of",
]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CATEGORY = "user_annotation"
PROGRAM_SITES = ("train/", "serve/", "bench/")
US_PER_S = 1e6

# the kernels each wrapper launches one of a call, by their names in csrc/
WRAPPER_KERNELS = {
    "int8_matmul": ("int8_mma_kernel", "f32_tile_kernel", "f32_rows_kernel"),
    "lora_chain": ("lora_chain_mma_kernel", "lora_chain_f32_kernel"),
    "fused_qlora": ("qlora_mma_kernel", "qlora_f32_tile_kernel", "qlora_f32_rows_kernel"),
    "decode_attention": ("decode_attention_mma_kernel", "decode_attention_f32_kernel"),
}
# each name whole, demangled or mangled (its length before it)
_WRAPPER_PATTERNS = {w: re.compile("|".join(rf"(?<!\w){n}(?!\w)|(?<!\d){len(n)}{n}" for n in names))
                     for w, names in WRAPPER_KERNELS.items()}


class TraceParseError(ValueError):
    """A trace file that is not a complete Chrome trace (a window cut short
    mid-write, a foreign file): loud, never a plausible empty table."""


def start_profile(device: Any) -> Any:
    """A started ``torch.profiler.profile`` recording the host and, for a
    CUDA ``device``, the card. A profiler that does not start raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof: Any, path: Union[str, Path]) -> Path:
    """Stop a window and write its Chrome trace to ``path`` (parents
    made)."""
    prof.stop()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path


def find_trace_files(root: Union[str, Path]) -> List[Path]:
    """Every ``*.trace.json`` under ``root``, sorted."""
    return sorted(Path(root).rglob("*.trace.json"))


def load_trace(path: Union[str, Path]) -> Dict[str, Any]:
    """A trace file → its JSON object (with a ``traceEvents`` list)."""
    try:
        doc = json.loads(Path(path).read_text())
    except json.JSONDecodeError as e:
        raise TraceParseError(f"{path}: not JSON ({e})") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise TraceParseError(f"{path}: no traceEvents list")
    return doc


def _complete(trace: Dict[str, Any]) -> Iterable[Dict[str, Any]]:
    for ev in trace.get("traceEvents", []):
        if isinstance(ev, dict) and ev.get("ph") == "X" and "ts" in ev:
            yield ev


def device_events(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The card's events (kernels, copies, memsets)."""
    return [ev for ev in _complete(trace) if ev.get("cat") in DEVICE_CATEGORIES]


def range_events(trace: Dict[str, Any], sites: Sequence[str] = PROGRAM_SITES) -> List[Dict[str, Any]]:
    """The host ``record_function`` ranges whose name starts with a site."""
    return [ev for ev in _complete(trace)
            if ev.get("cat") == RANGE_CATEGORY and str(ev.get("name", "")).startswith(tuple(sites))]


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def program_durations(trace: Dict[str, Any], sites: Sequence[str] = PROGRAM_SITES) -> Dict[str, Dict[str, Any]]:
    """Device time per range name: ``{name: {"count", "total_us",
    "avg_us"}}``, each occurrence the union of the device intervals clipped
    to the range's window. An occurrence with no device event in its window
    (a CPU trace has none) measures nothing and is left out."""
    devs = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0))) for ev in device_events(trace))
    out: Dict[str, Dict[str, Any]] = {}
    for rng in range_events(trace, sites):
        t0 = float(rng["ts"])
        t1 = t0 + float(rng.get("dur", 0))
        clipped = [(max(a, t0), min(b, t1)) for a, b in devs if b > t0 and a < t1]
        if not clipped:
            continue
        slot = out.setdefault(rng["name"], {"count": 0, "total_us": 0.0})
        slot["count"] += 1
        slot["total_us"] += _union_us(clipped)
    for slot in out.values():
        slot["avg_us"] = slot["total_us"] / max(slot["count"], 1)
    return out


def op_durations(trace: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Device time per kernel (copy, memset) name: ``{name: {"count",
    "total_us", "avg_us"}}``."""
    out: Dict[str, Dict[str, Any]] = {}
    for ev in device_events(trace):
        slot = out.setdefault(ev.get("name", "?"), {"count": 0, "total_us": 0.0})
        slot["count"] += 1
        slot["total_us"] += float(ev.get("dur", 0))
    for slot in out.values():
        slot["avg_us"] = slot["total_us"] / max(slot["count"], 1)
    return out


@functools.lru_cache(maxsize=4096)
def wrapper_of(name: str) -> Optional[str]:
    """The K1-K4 wrapper whose kernel ``name`` is (by its whole name in
    :data:`WRAPPER_KERNELS`, demangled or mangled), or None."""
    hits = [w for w, pat in _WRAPPER_PATTERNS.items() if pat.search(name)]
    if len(hits) > 1:
        raise AssertionError(f"the kernel {name!r} matches {hits}")
    return hits[0] if hits else None


def kernel_evidence(trace: Dict[str, Any], patterns: Sequence[str] = tuple(WRAPPER_KERNELS)) -> Dict[str, Dict[str, Any]]:
    """Did K1-K4 run on the card? Per wrapper of ``patterns``: ``{"pattern",
    "events", "total_us", "names"}`` over the kernel events found by their
    whole names. ``events == 0`` is the evidence that the kernel did not
    run."""
    evidence = {p: {"pattern": p, "events": 0, "total_us": 0.0, "names": []} for p in patterns}
    for ev in device_events(trace):
        name = str(ev.get("name", ""))
        w = wrapper_of(name)
        if w in evidence:
            slot = evidence[w]
            slot["events"] += 1
            slot["total_us"] += float(ev.get("dur", 0))
            if name not in slot["names"] and len(slot["names"]) < 8:
                slot["names"].append(name)
    return evidence


# the host ops that ``prof.events()`` leaves out
_FILTERED_EVENTS = frozenset(("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                              "profiler::_record_function_enter_new", "profiler::_record_function_exit",
                              "aten::is_leaf", "aten::output_nr", "aten::_version"))


def live_events(torch, prof, device_type=None) -> Iterable[Tuple[str, float]]:
    """``(name, ms)`` of each event of a finished live ``torch.profiler``
    run on ``device_type`` (default the CUDA device), named and timed as
    ``prof.events()`` names and times them (demangled). Read from the
    profiler's raw results: ``prof.events()`` builds an event tree first,
    which costs tens of µs an event (seconds for an epoch's 10⁵ kernels);
    where the raw results are missing, from ``prof.events()``."""
    dt = torch.autograd.DeviceType.CUDA if device_type is None else device_type
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        for e in prof.events():
            if e.device_type == dt:
                yield e.name, (e.time_range.end - e.time_range.start) / 1e3
        return
    names: Dict[str, str] = {}
    for e in raw.events():
        if e.device_type() != dt:
            continue
        name = e.name()
        if name in _FILTERED_EVENTS or (hasattr(e, "is_hidden_event") and e.is_hidden_event()):
            continue
        shown = names.get(name)
        if shown is None:
            shown = names[name] = ("ProfilerStep*" if name.startswith("ProfilerStep#") else
                                   torch._C._demangle(name) if len(name) > 1 else name)
        yield shown, (e.end_ns() - e.start_ns()) / 1e6


def device_kernels(torch, prof):
    """Device time and launches per kernel name of a live ``torch.profiler``
    run: ``({name: (ms, launches)}, busy ms, launches, the 12 largest as
    (ms, launches, name))``."""
    kernels = {}
    for name, dur in live_events(torch, prof):
        ms, n = kernels.get(name, (0.0, 0))
        kernels[name] = (ms + dur, n + 1)
    top = sorted(((ms, n, name[:100]) for name, (ms, n) in kernels.items()), reverse=True)[:12]
    return kernels, sum(ms for ms, _ in kernels.values()), sum(n for _, n in kernels.values()), top


def profiled_launches(kernels, what: int = 1):
    """K1-K4's launches on the device, from :func:`device_kernels`'s
    ``{name: (ms, launches)}``: each kernel found by its whole name,
    demangled or mangled. A CUDA graph's replays run the kernels without
    their wrappers, so this is where a replay's launches are counted.
    ``what=0`` sums their device ms instead."""
    out = {w: 0 for w in WRAPPER_KERNELS}
    for name, counts in kernels.items():
        w = wrapper_of(name)
        if w is not None:
            out[w] += counts[what]
    return out


def normalize_program_name(name: str) -> str:
    """A range name (``train/es_step_m2r1``) or a ledger label
    (``es_step_m2r1``) → a lowercase ``[a-z0-9_]`` stem, the site prefix
    dropped, so both sides meet."""
    s = str(name).strip().lower().rsplit("/", 1)[-1]
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in s).strip("_")


def join_ledger(programs: Dict[str, Dict[str, Any]], records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Attribute measured range durations to ledger records.

    ``programs`` is :func:`program_durations` output; ``records`` are
    ``programs.jsonl`` rows. A record ``site/label`` matches the range of
    that name, else a range whose normalized name equals the label's.
    Returns ``{"rows": [{site, label, key, program, measured_ns,
    measured_s, occurrences, measured_flops_per_s, measured_bytes_per_s}],
    "unmatched_records": [...], "unmatched_programs": [...]}``: the rates
    divide the record's counted FLOPs and bytes by the measured time."""
    rows: List[Dict[str, Any]] = []
    matched = set()
    unmatched_records: List[str] = []
    last: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        if rec.get("label"):
            last[f"{rec.get('site', '?')}/{rec['label']}"] = rec
    for key in sorted(last):
        rec = last[key]
        hit = key if key in programs else next(
            (name for name in programs if normalize_program_name(name) == normalize_program_name(rec["label"])
             and name not in matched), None)
        if hit is None:
            unmatched_records.append(key)
            continue
        matched.add(hit)
        agg = programs[hit]
        measured_s = agg["avg_us"] / US_PER_S
        flops, nbytes = rec.get("flops"), rec.get("bytes_accessed")
        rows.append({
            "site": rec.get("site"),
            "label": rec.get("label"),
            "key": key,
            "program": hit,
            "measured_ns": agg["avg_us"] * 1e3,
            "measured_s": measured_s,
            "occurrences": agg["count"],
            "measured_flops_per_s": (float(flops) / measured_s if isinstance(flops, (int, float)) and flops > 0
                                     and measured_s > 0 else None),
            "measured_bytes_per_s": (float(nbytes) / measured_s if isinstance(nbytes, (int, float)) and nbytes > 0
                                     and measured_s > 0 else None),
        })
    return {"rows": rows, "unmatched_records": unmatched_records,
            "unmatched_programs": sorted(set(programs) - matched)}


def build_trace(spec: Dict[str, Any]) -> str:
    """A synthetic Chrome trace as ``torch.profiler`` writes one.
    ``spec``::

        {"ranges": [{"name": "train/es_step_m2r1", "ts": 0, "dur": 100}],
         "kernels": [{"name": "int8_mma_kernel", "ts": 10, "dur": 5,
                      "cat": "kernel"}]}   # cat optional

    ``ts``/``dur`` in microseconds. Returns the JSON text."""
    events = []
    for r in spec.get("ranges", []):
        events.append({"ph": "X", "cat": RANGE_CATEGORY, "name": r["name"], "pid": 1, "tid": 1,
                       "ts": r["ts"], "dur": r["dur"]})
    for k in spec.get("kernels", []):
        events.append({"ph": "X", "cat": k.get("cat", "kernel"), "name": k["name"], "pid": 0, "tid": 7,
                       "ts": k["ts"], "dur": k["dur"]})
    return json.dumps({"schemaVersion": 1, "traceEvents": events})
