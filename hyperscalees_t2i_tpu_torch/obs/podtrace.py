"""Pod flight recorder: merge per-process trace segments into one timeline
(a copy of ``hyperscalees_t2i_tpu/obs/podtrace.py``; standard library only).

A launch writes one span timeline per process (``trace.jsonl`` on rank 0,
``trace.<i>.jsonl`` on rank *i*, ``obs/multihost.py``), each timed against
its own monotonic origin. This module merges them:

- **segment discovery** (:func:`discover_trace_segments`): every per-host
  trace file in a run dir, keyed by process index; a single-process run
  degrades to the one canonical file (and every stat below to a no-op
  merge);
- **clock alignment** (:func:`host_clock_offsets`): the trainer emits an
  ``epoch_anchor`` event per epoch spanning the cross-process fitness or
  agreement gather (``train/trainer.py``). The gather is a barrier, so every
  process leaves it at nearly the same true instant, and the per-host exit
  stamps of a common epoch differ by the clock offset. A host's offset is
  the median of those differences over the common epochs, keyed by epoch
  number. A replayed epoch (rollback) or duplicated anchor keeps the last
  emission; a resumed run's earlier tracer sessions are dropped per
  segment (their time base restarted);
- **straggler analytics** (:func:`straggler_stats`): barrier entry stamps
  in aligned time give each epoch's arrival order. The last to arrive is
  that epoch's straggler, and every other host's barrier wait is its gap
  to it. Aggregated: per-host mean barrier wait, critical-path share (the
  fraction of epochs the host arrived last), per-epoch spread;
- **per-phase skew** (:func:`pod_phase_stats`): span durations need no
  clock, so per-host phase tables include hosts that could not be aligned,
  plus a cross-host spread row per phase naming its slowest host.

Read by ``tools/trace_report.py`` (the Pod section and per-host tables),
``tools/run_report.py`` (the Pod panel) and the trainer (rank 0's merge
after the loop → ``pod_summary.json`` and the ``pod/*`` gauges on the
exporter). A "host" here is a process: the segments are per process.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from ..utils.stats import median, percentiles
from .trace import load_events

# the trainer's per-epoch barrier event (span of the cross-host gather)
ANCHOR_EVENT = "epoch_anchor"
POD_SUMMARY_FILE = "pod_summary.json"


def discover_trace_segments(run_dir: Union[str, Path]) -> Dict[int, Path]:
    """Per-host trace segments in a run dir, keyed by process index: the
    canonical ``trace.jsonl`` is host 0, ``trace.<i>.jsonl`` is host *i*.
    Non-numeric suffixes (``trace_chrome.json`` etc.) are ignored."""
    run_dir = Path(run_dir)
    out: Dict[int, Path] = {}
    canon = run_dir / "trace.jsonl"
    if canon.exists():
        out[0] = canon
    for p in run_dir.glob("trace.*.jsonl"):
        suffix = p.name[len("trace."):-len(".jsonl")]
        if suffix.isdigit():
            out[int(suffix)] = p
    return dict(sorted(out.items()))


def load_pod_events(run_dir: Union[str, Path]) -> List[Dict[str, Any]]:
    """Merged span events from every discovered segment, each tagged with
    its ``host`` (process index from the segment name — authoritative even
    when an old file lacks per-event ``process_index``). Per segment only
    the LATEST tracer session survives: a resumed run restarted its
    monotonic origin, and mixing time bases would corrupt every downstream
    stat (same discipline as ``trace_report.main``). Times stay in each
    host's own clock — alignment is a separate, anchor-exact step."""
    events: List[Dict[str, Any]] = []
    for host, path in discover_trace_segments(run_dir).items():
        try:
            evs = load_events(path)
        except OSError:
            continue
        if not evs:
            continue
        last = max(e["session"] for e in evs)
        for e in evs:
            if e["session"] != last:
                continue
            e = dict(e)
            e["host"] = host
            events.append(e)
    return events


def epoch_anchors(
    events: List[Dict[str, Any]],
) -> Dict[int, Dict[int, Tuple[float, float]]]:
    """``{host: {epoch: (entry_s, exit_s)}}`` from the ``epoch_anchor``
    events. Duplicate anchors for one epoch (a rollback replayed the epoch,
    or a preempt→resume incarnation re-traced its boundary) keep the LAST
    emission — the replay is the timeline that continued."""
    out: Dict[int, Dict[int, Tuple[float, float]]] = {}
    for e in events:
        if e.get("name") != ANCHOR_EVENT:
            continue
        ep = (e.get("attrs") or {}).get("epoch")
        if not isinstance(ep, (int, float)):
            continue
        host = int(e.get("host", e.get("process_index", 0)))
        t0 = float(e["t0_s"])
        out.setdefault(host, {})[int(ep)] = (t0, t0 + float(e["dur_s"]))
    return out


def host_clock_offsets(
    anchors: Dict[int, Dict[int, Tuple[float, float]]],
    reference: Optional[int] = None,
) -> Dict[int, Optional[float]]:
    """Per-host clock offset (seconds to ADD to a host's stamps to land on
    the reference host's timeline), from barrier-EXIT stamps of common
    epochs: every host leaves the gather at the same true instant, so the
    exit difference IS the clock offset (median over epochs suppresses the
    per-epoch RPC jitter). ``None`` for a host sharing no anchor epoch with
    the reference — it cannot be placed on the pod timeline and is excluded
    from arrival-order stats (its clock-free phase durations still count)."""
    hosts = sorted(anchors)
    if not hosts:
        return {}
    ref = hosts[0] if reference is None else reference
    ref_anchors = anchors.get(ref, {})
    offsets: Dict[int, Optional[float]] = {}
    for h in hosts:
        if h == ref:
            offsets[h] = 0.0
            continue
        common = sorted(set(ref_anchors) & set(anchors[h]))
        if not common:
            offsets[h] = None
            continue
        offsets[h] = median(
            [ref_anchors[e][1] - anchors[h][e][1] for e in common]
        )
    return offsets


def align_events(
    events: List[Dict[str, Any]], offsets: Dict[int, Optional[float]]
) -> List[Dict[str, Any]]:
    """Events shifted onto the reference timeline (``t0_s`` += offset).
    Events from unalignable hosts are dropped — a span that cannot be
    placed in pod time must not render at a fabricated position."""
    out = []
    for e in events:
        off = offsets.get(int(e.get("host", 0)))
        if off is None:
            continue
        e = dict(e)
        e["t0_s"] = float(e["t0_s"]) + off
        out.append(e)
    return out


def pod_phase_stats(
    events: List[Dict[str, Any]],
) -> Tuple[List[Dict[str, Any]], Dict[str, Dict[str, Any]]]:
    """Per-(phase, host) duration rows + a cross-host spread entry per phase
    seen on ≥2 hosts (mean/p95 spread between the fastest and slowest host,
    and which host is slowest by total time). Durations are clock-free, so
    unalignable hosts are fully represented here."""
    by: Dict[Tuple[str, int], List[float]] = {}
    for e in events:
        if e.get("name") == ANCHOR_EVENT:
            continue
        by.setdefault((e["name"], int(e.get("host", 0))), []).append(
            float(e["dur_s"])
        )
    rows = []
    for (phase, host), durs in sorted(by.items()):
        pcts = percentiles(durs)
        total = sum(durs)
        rows.append({
            "phase": phase, "host": host, "count": len(durs),
            "total_s": total, "mean_s": total / len(durs),
            "p50_s": pcts["p50"], "p95_s": pcts["p95"],
            "max_s": max(durs),
        })
    spread: Dict[str, Dict[str, Any]] = {}
    for phase in sorted({r["phase"] for r in rows}):
        sub = [r for r in rows if r["phase"] == phase]
        if len(sub) < 2:
            continue
        means = [r["mean_s"] for r in sub]
        p95s = [r["p95_s"] for r in sub]
        slowest = max(sub, key=lambda r: r["total_s"])
        spread[phase] = {
            "hosts": len(sub),
            "mean_spread_s": max(means) - min(means),
            "p95_spread_s": max(p95s) - min(p95s),
            "slowest_host": slowest["host"],
        }
    return rows, spread


def straggler_stats(
    anchors: Dict[int, Dict[int, Tuple[float, float]]],
    offsets: Dict[int, Optional[float]],
    min_spread_s: float = 0.0,
) -> Dict[str, Any]:
    """Arrival-order analytics over the aligned barrier-ENTRY stamps.

    Per common epoch: each aligned host's arrival, the last arrival (that
    epoch's straggler), every host's barrier wait (gap to the last arrival
    — the time it spent blocked in the gather on account of its peers), and
    the cross-host spread. An epoch whose spread is below ``min_spread_s``
    awards no critical-path win — arrival order inside the alignment jitter
    is noise, and counting coin-flip epochs would let a balanced pod mask a
    genuinely slow host on short runs. Aggregates: per-host mean wait +
    critical-path share (fraction of epochs the host arrived last), and the
    pod-level straggler attribution (the host most often on the critical
    path; ties break toward the smaller mean wait — the host others waited
    for)."""
    aligned = [h for h in sorted(anchors) if offsets.get(h) is not None]
    empty = {
        "n_epochs_aligned": 0, "straggler_host": None,
        "critical_path_share": {}, "barrier_wait_mean_s": {},
        "epoch_spread_mean_s": 0.0, "epoch_spread_total_s": 0.0,
        "per_epoch": [],
    }
    if len(aligned) < 2:
        return empty
    common = sorted(set.intersection(*(set(anchors[h]) for h in aligned)))
    if not common:
        return empty
    crit = {h: 0 for h in aligned}
    waits: Dict[int, List[float]] = {h: [] for h in aligned}
    per_epoch = []
    spreads = []
    for ep in common:
        arr = {h: anchors[h][ep][0] + offsets[h] for h in aligned}
        last_host = max(arr, key=lambda h: arr[h])
        last_t = arr[last_host]
        spread = last_t - min(arr.values())
        decisive = spread >= max(min_spread_s, 0.0)
        if decisive:
            crit[last_host] += 1
        ep_waits = {}
        for h in aligned:
            w = last_t - arr[h]
            waits[h].append(w)
            ep_waits[h] = w
        spreads.append(spread)
        per_epoch.append({
            "epoch": ep,
            "straggler": last_host if decisive else None,
            "spread_s": spread,
            "waits_s": ep_waits,
        })
    n = len(common)
    wait_mean = {h: sum(ws) / len(ws) for h, ws in waits.items()}
    straggler: Optional[int] = None
    if any(crit.values()):
        straggler = min(aligned, key=lambda h: (-crit[h], wait_mean[h]))
    return {
        "n_epochs_aligned": n,
        "straggler_host": straggler,
        "critical_path_share": {h: crit[h] / n for h in aligned},
        "barrier_wait_mean_s": wait_mean,
        "epoch_spread_mean_s": sum(spreads) / n,
        "epoch_spread_total_s": sum(spreads),
        "per_epoch": per_epoch,
    }


def pod_summary(
    run_dir: Union[str, Path],
    min_spread_s: float = 0.002,
    events: Optional[List[Dict[str, Any]]] = None,
) -> Optional[Dict[str, Any]]:
    """The full merge: segments → anchors → offsets → phase + straggler
    stats, as one JSON-serializable dict. ``None`` when the run dir has no
    trace segments at all; a single-process run returns a degenerate
    summary (``n_hosts`` 1, no straggler) rather than erroring — the no-op
    merge contract. ``min_spread_s`` (default 2 ms, ~the KV-gather RPC
    jitter on the local simulator) keeps noise-level epochs from awarding
    critical-path wins. ``events`` skips the disk re-read when the caller
    already holds :func:`load_pod_events` output (report tools parse large
    segment files once, not per consumer)."""
    if events is None:
        events = load_pod_events(run_dir)
    if not events:
        return None
    hosts = sorted({int(e.get("host", 0)) for e in events})
    anchors = epoch_anchors(events)
    offsets = host_clock_offsets(anchors)
    phase_rows, phase_spread = pod_phase_stats(events)
    summary: Dict[str, Any] = {
        "n_hosts": len(hosts),
        "hosts": hosts,
        "clock_offsets_s": {h: offsets.get(h) for h in hosts},
        # a host is unaligned when it shares no anchor epoch with the
        # reference OR never anchored at all (meaningful only in pods —
        # a lone host has nothing to align against)
        "unaligned_hosts": [
            h for h in hosts if offsets.get(h) is None
        ] if len(hosts) > 1 else [],
        "phase": phase_rows,
        "phase_spread": phase_spread,
    }
    summary.update(straggler_stats(anchors, offsets,
                                   min_spread_s=min_spread_s))
    return summary


def pod_gauges(summary: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten a summary into ``pod/*`` gauges for the live exporter and
    metrics payloads (sanitized to ``pod_*`` series on ``/metrics``)."""
    g: Dict[str, Any] = {
        "pod/hosts": summary.get("n_hosts", 0),
        "pod/epochs_aligned": summary.get("n_epochs_aligned", 0),
        "pod/barrier_wait_per_epoch_s": summary.get("epoch_spread_mean_s", 0.0),
        "pod/barrier_wait_total_s": summary.get("epoch_spread_total_s", 0.0),
    }
    strag = summary.get("straggler_host")
    if strag is not None:
        g["pod/straggler_host"] = strag
        g["pod/straggler_share"] = summary["critical_path_share"].get(strag, 0.0)
    offsets = summary.get("clock_offsets_s") or {}
    finite = [abs(v) for v in offsets.values() if isinstance(v, (int, float))]
    if finite:
        g["pod/clock_offset_max_s"] = max(finite)
    for h, share in (summary.get("critical_path_share") or {}).items():
        g[f"pod/host{h}/critical_share"] = share
    for h, w in (summary.get("barrier_wait_mean_s") or {}).items():
        g[f"pod/host{h}/barrier_wait_mean_s"] = w
    for h, off in offsets.items():
        if isinstance(off, (int, float)):
            g[f"pod/host{h}/clock_offset_s"] = off
    return g


def write_pod_summary(
    run_dir: Union[str, Path], summary: Dict[str, Any]
) -> Path:
    """Persist the merge beside the raw segments (atomic tmp→replace, like
    every other run-dir artifact writer)."""
    import os

    path = Path(run_dir) / POD_SUMMARY_FILE
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(summary, indent=2, default=str))
    os.replace(tmp, path)
    return path


__all__ = [
    "ANCHOR_EVENT",
    "POD_SUMMARY_FILE",
    "align_events",
    "discover_trace_segments",
    "epoch_anchors",
    "host_clock_offsets",
    "load_pod_events",
    "pod_gauges",
    "pod_phase_stats",
    "pod_summary",
    "straggler_stats",
    "write_pod_summary",
]
