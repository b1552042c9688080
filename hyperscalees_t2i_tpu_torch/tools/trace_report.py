"""Per-phase time table and Chrome export from a run's ``trace.jsonl`` (port
of ``hyperscalees_t2i_tpu/tools/trace_report.py``).

Usage::

    python -m hyperscalees_t2i_tpu_torch.tools.trace_report <run_dir|trace.jsonl>
    python -m hyperscalees_t2i_tpu_torch.tools.trace_report runs/my_run --chrome
    python -m hyperscalees_t2i_tpu_torch.tools.trace_report runs/my_run --chrome out.json

Aggregates the span events of ``obs/trace.py`` into one row per phase name:
count, total, mean, nearest-rank p50/p95/p99 (``utils/stats.py``), max and
share of wall clock; a coverage line (the union of top-level spans over the
wall clock: how much of the run the timeline explains); and a Serving
section (latency percentiles, queue and occupancy means) from the
``serve/request`` spans the serving engine writes. ``--chrome`` also writes
Chrome trace-event JSON (default ``trace_chrome.json`` beside the input).

A run dir is read through the pod flight recorder (``obs/podtrace.py``):
every per-process segment is found (``trace.<i>.jsonl``, a dir of segments
only included, e.g. when rank 0 died), and with more than one the report
gives the pooled and per-host tables and a Pod section with the
anchor-aligned straggler analytics (clock offsets, the slowest host, each
host's barrier wait, critical-path share); ``--chrome`` then writes the
pod-aligned timeline. One segment, or a bare file, keeps the one-host
report.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..obs import podtrace
from ..obs.trace import load_events, to_chrome
from ..utils.stats import percentiles


def latest_session(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The events of the last tracer session: a resumed run appends a
    session whose ``t0_s`` restarts at about 0, and mixing time bases would
    corrupt wall clock and coverage."""
    if not events:
        return []
    last = max(e["session"] for e in events)
    return [e for e in events if e["session"] == last]


def wall_clock_s(events: List[Dict[str, Any]]) -> float:
    """First span start to last span end."""
    if not events:
        return 0.0
    t0 = min(e["t0_s"] for e in events)
    t1 = max(e["t0_s"] + e["dur_s"] for e in events)
    return max(t1 - t0, 0.0)


def coverage(events: List[Dict[str, Any]]) -> float:
    """The share of wall clock covered by the union of top-level (depth 0)
    spans; nested spans are left out so overlap cannot inflate it."""
    wall = wall_clock_s(events)
    if wall <= 0:
        return 0.0
    ivs = sorted((e["t0_s"], e["t0_s"] + e["dur_s"]) for e in events if e.get("depth", 0) == 0)
    covered = 0.0
    cur_a = cur_b = None
    for a, b in ivs:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                covered += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        covered += cur_b - cur_a
    return min(covered / wall, 1.0)


def aggregate(events: List[Dict[str, Any]], wall: Optional[float] = None) -> List[Dict[str, Any]]:
    """One row per phase name, by total time descending. ``pct_wall`` may
    sum past 100 across rows: nested spans count in their parent's row too."""
    if wall is None:
        wall = wall_clock_s(events)
    by_name: Dict[str, List[float]] = {}
    for ev in events:
        by_name.setdefault(ev["name"], []).append(float(ev["dur_s"]))
    rows = []
    for name, durs in by_name.items():
        total = sum(durs)
        pcts = percentiles(durs)
        rows.append({"phase": name, "count": len(durs), "total_s": total, "mean_s": total / len(durs),
                     "p50_s": pcts["p50"], "p95_s": pcts["p95"], "p99_s": pcts["p99"], "max_s": max(durs),
                     "pct_wall": 100.0 * total / wall if wall > 0 else 0.0})
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def render(rows: List[Dict[str, Any]]) -> str:
    head = "| phase | count | total s | mean s | p50 s | p95 s | p99 s | max s | % wall |\n|---|---|---|---|---|---|---|---|---|"
    body = "\n".join(
        "| {phase} | {count} | {total_s:.4f} | {mean_s:.4f} | {p50_s:.4f} | {p95_s:.4f} | {p99_s:.4f} | {max_s:.4f} "
        "| {pct_wall:.1f} |".format(**r) for r in rows)
    return head + "\n" + body


def serving_summary(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Latency percentiles and the queue/assembly/dispatch/occupancy means of
    the ``serve/request`` spans; ``None`` without serving traffic."""
    reqs = [e for e in events if e["name"] == "serve/request"]
    if not reqs:
        return None
    durs = [float(e["dur_s"]) for e in reqs]
    attrs = [e.get("attrs", {}) for e in reqs]

    def _mean(key: str) -> Optional[float]:
        vals = [float(a[key]) for a in attrs if isinstance(a.get(key), (int, float))]
        return sum(vals) / len(vals) if vals else None

    return {"requests": len(reqs), **{f"latency_{k}_s": v for k, v in percentiles(durs).items()},
            "queue_wait_mean_s": _mean("queue_wait_s"), "dispatch_mean_s": _mean("dispatch_s"),
            "assembly_mean_s": _mean("assembly_s"), "occupancy_mean": _mean("occupancy")}


def render_pod_section(summary: Dict[str, Any]) -> List[str]:
    """Text lines of the Pod section (the straggler analytics of the
    anchor-aligned merge)."""
    lines = ["\n## pod"]
    hosts = summary.get("hosts", [])
    lines.append(f"{summary.get('n_hosts', 0)} hosts ({', '.join(map(str, hosts))}); "
                 f"{summary.get('n_epochs_aligned', 0)} anchor-aligned epochs")
    offs = summary.get("clock_offsets_s") or {}
    if offs:
        lines.append("clock offsets vs reference host: " + "  ".join(
            f"host{h}={offs[h]:+.4f}s" if isinstance(offs.get(h), (int, float)) else f"host{h}=UNALIGNED"
            for h in sorted(offs)))
    strag = summary.get("straggler_host")
    if strag is not None:
        share = summary["critical_path_share"].get(strag, 0.0)
        lines.append(f"straggler: host {strag} (on the critical path {100.0 * share:.0f}% of epochs; cross-host "
                     f"spread {summary['epoch_spread_mean_s'] * 1e3:.1f} ms/epoch mean, "
                     f"{summary['epoch_spread_total_s']:.3f}s total barrier wait)")
        waits = summary.get("barrier_wait_mean_s") or {}
        lines.append("mean barrier wait (time spent waiting on peers): "
                     + "  ".join(f"host{h}={waits[h] * 1e3:.1f}ms" for h in sorted(waits)))
    spread = summary.get("phase_spread") or {}
    if spread:
        lines.append("\n| phase | hosts | mean spread s | p95 spread s | slowest host |\n|---|---|---|---|---|")
        for phase in sorted(spread):
            sp = spread[phase]
            lines.append(f"| {phase} | {sp['hosts']} | {sp['mean_spread_s']:.4f} | {sp['p95_spread_s']:.4f} "
                         f"| {sp['slowest_host']} |")
    return lines


def _pod_main(src: Path, segments: Dict[int, Path], args) -> int:
    """A dir of several segments: pooled and per-host tables and the Pod
    section."""
    events = podtrace.load_pod_events(src)
    if not events:
        print(f"no span events in the segments of {src}", file=sys.stderr)
        return 1
    hosts = sorted(segments)
    by_host = {h: [e for e in events if e["host"] == h] for h in hosts}
    print(f"# pod trace report: {src}")
    print(f"{len(hosts)} host segments: " + ", ".join(f"host{h}={segments[h].name}" for h in hosts))
    total_wall = 0.0
    for h in hosts:
        evs = by_host[h]
        if not evs:
            print(f"host {h}: no span events")
            continue
        wall = wall_clock_s(evs)
        total_wall += wall
        print(f"host {h}: wall clock {wall:.3f}s over {len(evs)} spans, top-level coverage "
              f"{100.0 * coverage(evs):.1f}%")

    print("\n## pooled (all hosts; % wall is share of summed host time)")
    print(render(aggregate(events, wall=total_wall or None)))
    for h in hosts:
        if not by_host[h]:
            continue
        print(f"\n## host {h}")
        print(render(aggregate(by_host[h])))

    summary = podtrace.pod_summary(src, events=events)
    if summary is not None:
        print("\n".join(render_pod_section(summary)))

    serving = serving_summary(events)
    if serving:
        print("\n## serving (pooled)")
        print(f"{serving['requests']} requests — latency p50 {serving['latency_p50_s']:.4f}s / "
              f"p95 {serving['latency_p95_s']:.4f}s / p99 {serving['latency_p99_s']:.4f}s")

    if args.chrome is not None:
        # on the reference host's clock; hosts that cannot be aligned are
        # dropped, not drawn at made-up positions
        anchors = podtrace.epoch_anchors(events)
        aligned = podtrace.align_events(events, podtrace.host_clock_offsets(anchors))
        out = Path(args.chrome) if args.chrome else src / "trace_chrome.json"
        out.write_text(json.dumps(to_chrome(aligned)))
        print(f"\nchrome trace → {out} (pod-aligned; load in chrome://tracing or Perfetto)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="run dir holding trace segment(s), or a trace.jsonl file itself")
    ap.add_argument("--chrome", nargs="?", const="", default=None, metavar="OUT",
                    help="also write Chrome trace-event JSON (default: trace_chrome.json beside the input)")
    args = ap.parse_args(argv)

    path = Path(args.path)
    if path.is_dir():
        segments = podtrace.discover_trace_segments(path)
        if not segments:
            print(f"no trace file at {path / 'trace.jsonl'}", file=sys.stderr)
            return 1
        if len(segments) > 1:
            return _pod_main(path, segments, args)
        # one segment, even a bare trace.<i>.jsonl: the one-host report
        path = next(iter(segments.values()))
    if not path.exists():
        print(f"no trace file at {path}", file=sys.stderr)
        return 1
    events = load_events(path)
    if not events:
        print(f"no span events in {path}", file=sys.stderr)
        return 1
    last = max(e["session"] for e in events)
    dropped = sum(1 for e in events if e["session"] != last)
    events = latest_session(events)

    wall = wall_clock_s(events)
    print(f"# trace report: {path}")
    if dropped:
        print(f"NOTE: {dropped} spans from {last} earlier trace session(s) (resumed run) ignored — only the latest "
              "session is reported")
    print(f"wall clock: {wall:.3f}s over {len(events)} spans")
    print(f"top-level span coverage: {100.0 * coverage(events):.1f}% of wall clock")
    print()
    print(render(aggregate(events)))

    serving = serving_summary(events)
    if serving:
        print("\n## serving")
        print(f"{serving['requests']} requests — latency p50 {serving['latency_p50_s']:.4f}s / "
              f"p95 {serving['latency_p95_s']:.4f}s / p99 {serving['latency_p99_s']:.4f}s")
        detail = [(k, serving[k]) for k in ("queue_wait_mean_s", "assembly_mean_s", "dispatch_mean_s",
                                             "occupancy_mean") if serving[k] is not None]
        if detail:
            print("  " + "  ".join(f"{k}={v:.4f}" for k, v in detail))

    if args.chrome is not None:
        out = Path(args.chrome) if args.chrome else path.parent / "trace_chrome.json"
        out.write_text(json.dumps(to_chrome(events)))
        print(f"\nchrome trace → {out} (load in chrome://tracing or Perfetto)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
