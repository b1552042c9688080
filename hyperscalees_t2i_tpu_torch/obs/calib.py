"""Measured against predicted: the roofline's error per program (port of
``hyperscalees_t2i_tpu/obs/calib.py``).

The ledger (``obs/program_cost.py``) predicts each program's time from its
counted FLOPs and bytes over the card's peaks (``utils/mfu.py``). This
module takes the measured side, device time per program from a profile
window's traces (``obs/profile_trace.py``, ``measured_source ==
"profile"``) or, where no range matched, the host's wall time of the
latest dispatch (``"host_wall"``), joins it to the ledger and reports per
program

- ``error_ratio = measured_s / predicted_s`` (1.0: the roofline was
  exact);
- ``mfu_claimed`` (FLOPs over the host's wall time) beside
  ``mfu_measured`` (FLOPs over device time);
- the achieved FLOP and byte rates.

The payload carries the reference's keys, with ``measured_source``
``"profile"`` where the reference says ``"xplane"``, ``torch_version`` in
place of ``jax_version`` and ``trace_files`` in place of ``xplane_files``.
It lands as ``calib/*`` registry gauges (:func:`calib_gauges`, on
``/metrics`` and in ``metrics.jsonl``) and as ``CALIB_*.json``
(:func:`write_calib`). On the CPU there are no peaks: ``predicted_s`` is
None and rows carry the measurement alone.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

from . import profile_trace

CALIB_SCHEMA_VERSION = 1
KERNEL_PATTERNS = tuple(profile_trace.WRAPPER_KERNELS)  # K1-K4 engagement evidence

__all__ = [
    "CALIB_SCHEMA_VERSION",
    "KERNEL_PATTERNS",
    "calib_gauges",
    "calibrate_run",
    "load_calib",
    "predicted_step_time_s",
    "reconcile",
    "write_calib",
]


def _peaks_for_kind(kind: Optional[str]) -> Dict[str, Optional[float]]:
    """The card's peaks by device name (``utils/mfu.py``); None for the CPU
    and unknown cards."""
    from ..utils import mfu as _mfu

    if not kind:
        return {"peak_flops": None, "hbm_bw": None}
    return {"peak_flops": _mfu.peak_flops_for_kind(kind), "hbm_bw": _mfu.hbm_bw_for_kind(kind)}


def predicted_step_time_s(rec: Mapping[str, Any]) -> Optional[float]:
    """The roofline's predicted step time for one ledger record, from its
    own counted totals and its stamped ``device_kind``; None when the peaks
    are unknown (the CPU)."""
    from .program_cost import roofline

    peaks = _peaks_for_kind(rec.get("device_kind"))
    if peaks["peak_flops"] is None and peaks["hbm_bw"] is None:
        return None
    r = roofline(rec.get("flops"), rec.get("bytes_accessed"), None, peak_flops=peaks["peak_flops"],
                 hbm_bw=peaks["hbm_bw"], n_devices=int(rec.get("n_devices") or 1))
    return r.get("t_roofline_s")


def _mfu(flops: Any, step_s: Optional[float], peak: Optional[float], n_devices: int) -> Optional[float]:
    if not isinstance(flops, (int, float)) or flops <= 0 or peak is None or not step_s or step_s <= 0:
        return None
    return float(flops) / (step_s * peak * max(n_devices, 1))


def reconcile(
    records: Sequence[Mapping[str, Any]],
    measured: Mapping[str, Mapping[str, Any]],
    host_measured: Optional[Mapping[str, float]] = None,
) -> List[Dict[str, Any]]:
    """Per-record reconciliation rows.

    ``measured`` maps ``site/label`` keys to the trace join's rows
    (``profile_trace.join_ledger``); ``host_measured`` maps the same keys
    to the host's wall seconds of a dispatch, used where no trace range
    matched; ``measured_source`` says which. Records with neither are
    omitted."""
    host_measured = host_measured or {}
    rows: List[Dict[str, Any]] = []
    last: Dict[str, Mapping[str, Any]] = {}
    for rec in records:
        if rec.get("label"):
            last[f"{rec.get('site', '?')}/{rec['label']}"] = rec
    for key in sorted(last):
        rec = last[key]
        dev = measured.get(key)
        host_s = host_measured.get(key)
        if dev is None and host_s is None:
            continue
        measured_s = dev["measured_s"] if dev else float(host_s)
        predicted = predicted_step_time_s(rec)
        peaks = _peaks_for_kind(rec.get("device_kind"))
        n_dev = int(rec.get("n_devices") or 1)
        flops = rec.get("flops")
        rows.append({
            "key": key,
            "site": rec.get("site"),
            "label": rec.get("label"),
            "chip_kind": rec.get("device_kind"),
            "n_devices": n_dev,
            "measured_s": measured_s,
            "measured_source": "profile" if dev else "host_wall",
            "occurrences": dev.get("occurrences") if dev else None,
            "predicted_s": predicted,
            "error_ratio": measured_s / predicted if predicted and predicted > 0 else None,
            "mfu_claimed": _mfu(flops, host_s if host_s else measured_s, peaks["peak_flops"], n_dev),
            "mfu_measured": _mfu(flops, measured_s, peaks["peak_flops"], n_dev) if dev else None,
            "measured_flops_per_s": dev.get("measured_flops_per_s") if dev else None,
            "measured_bytes_per_s": dev.get("measured_bytes_per_s") if dev else None,
        })
    return rows


def _merge_program_durations(traces: Sequence[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    merged: Dict[str, Dict[str, Any]] = {}
    for trace in traces:
        for name, agg in profile_trace.program_durations(trace).items():
            slot = merged.setdefault(name, {"count": 0, "total_us": 0.0})
            slot["count"] += agg["count"]
            slot["total_us"] += agg["total_us"]
    for slot in merged.values():
        slot["avg_us"] = slot["total_us"] / max(slot["count"], 1)
    return merged


def _merge_kernel_evidence(traces: Sequence[Dict[str, Any]], patterns: Sequence[str]) -> Dict[str, Dict[str, Any]]:
    merged = {p: {"pattern": p, "events": 0, "total_us": 0.0, "names": []} for p in patterns}
    for trace in traces:
        for p, ev in profile_trace.kernel_evidence(trace, patterns).items():
            slot = merged[p]
            slot["events"] += ev["events"]
            slot["total_us"] += ev["total_us"]
            for n in ev["names"]:
                if n not in slot["names"] and len(slot["names"]) < 8:
                    slot["names"].append(n)
    return merged


def calibrate_run(
    run_dir: Union[str, Path],
    *,
    host_measured: Optional[Mapping[str, float]] = None,
    records: Optional[Sequence[Mapping[str, Any]]] = None,
    registry: Any = None,
    kernel_patterns: Sequence[str] = KERNEL_PATTERNS,
    note: str = "",
) -> Dict[str, Any]:
    """Reconcile one run dir end to end → the CALIB payload.

    Reads ``programs.jsonl`` (unless ``records`` is given), every
    ``*.trace.json`` under the dir (the trainer's ``profile/``), joins the
    ranges' device time to the ledger, falls back to ``host_measured`` for
    unjoined records and, with ``registry``, publishes the ``calib/*``
    gauges. Unreadable traces are listed under ``parse_errors``."""
    run_dir = Path(run_dir)
    if records is None:
        from .program_cost import load_programs

        records = load_programs(run_dir)
    traces: List[Dict[str, Any]] = []
    parse_errors: List[Dict[str, str]] = []
    files = profile_trace.find_trace_files(run_dir)
    for f in files:
        try:
            traces.append(profile_trace.load_trace(f))
        except (profile_trace.TraceParseError, OSError) as e:
            parse_errors.append({"file": str(f), "error": str(e)})
    join = profile_trace.join_ledger(_merge_program_durations(traces), list(records))
    measured = {row["key"]: row for row in join["rows"]}
    rows = reconcile(records, measured, host_measured)
    kinds = [r.get("device_kind") for r in records if r.get("device_kind")]
    chip_kind = max(set(kinds), key=kinds.count) if kinds else None
    ratios = [r["error_ratio"] for r in rows if isinstance(r.get("error_ratio"), (int, float))]
    payload: Dict[str, Any] = {
        "mode": "calib",
        "schema_version": CALIB_SCHEMA_VERSION,
        "run_dir": str(run_dir),
        "chip_kind": chip_kind,
        "rows": rows,
        "headline": {
            "rows": len(rows),
            "device_rows": sum(1 for r in rows if r["measured_source"] == "profile"),
            "max_error_ratio": max(ratios) if ratios else None,
            "median_error_ratio": sorted(ratios)[len(ratios) // 2] if ratios else None,
        },
        "kernel_evidence": _merge_kernel_evidence(traces, kernel_patterns),
        "trace_files": [str(f) for f in files],
        "parse_errors": parse_errors,
        "unmatched_records": join["unmatched_records"],
        "unmatched_programs": join["unmatched_programs"],
        "note": note,
        "ts": time.time(),
    }
    try:
        import torch

        payload["torch_version"] = str(torch.__version__)
    except Exception:
        payload["torch_version"] = None
    if registry is not None:
        calib_gauges(payload, registry)
    return payload


def calib_gauges(payload: Mapping[str, Any], registry: Any) -> None:
    """Publish the reconciliation as ``calib/*`` registry gauges."""
    head = payload.get("headline", {})
    registry.gauge("calib/rows", head.get("rows", 0))
    if head.get("max_error_ratio") is not None:
        registry.gauge("calib/max_error_ratio", head["max_error_ratio"])
    if head.get("median_error_ratio") is not None:
        registry.gauge("calib/median_error_ratio", head["median_error_ratio"])
    for p, ev in (payload.get("kernel_evidence") or {}).items():
        registry.gauge(f"calib/kernel/{p}/events", ev.get("events", 0))
    for row in payload.get("rows", []):
        base = f"calib/{row['key']}"
        registry.gauge(f"{base}/measured_s", row["measured_s"])
        for field in ("predicted_s", "error_ratio", "mfu_claimed", "mfu_measured"):
            if isinstance(row.get(field), (int, float)):
                registry.gauge(f"{base}/{field}", row[field])


def write_calib(payload: Mapping[str, Any], out: Union[str, Path]) -> Path:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp")
    tmp.write_text(json.dumps(payload, indent=2, default=str) + "\n")
    os.replace(tmp, out)
    return out


def load_calib(path: Union[str, Path]) -> Optional[Dict[str, Any]]:
    """The parsed CALIB document, or None when the file is not one (a
    ``{"parsed": {...}}`` wrapper is unwrapped)."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if isinstance(doc, dict) and doc.get("mode") == "calib":
        return doc
    if isinstance(doc, dict):
        inner = doc.get("parsed")
        if isinstance(inner, dict) and inner.get("mode") == "calib":
            return inner
    return None
