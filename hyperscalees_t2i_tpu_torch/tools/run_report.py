"""Self-contained HTML run report: one file, no dependencies, no network
(port of ``hyperscalees_t2i_tpu/tools/run_report.py``).

Usage::

    python -m hyperscalees_t2i_tpu_torch.tools.run_report <run_dir>
    python -m hyperscalees_t2i_tpu_torch.tools.run_report <run_dir> -o report.html

Renders one static HTML file (inline SVG charts, inline CSS, no external
assets) from a run dir's artifacts:

- stat tiles (epochs, final and Δ reward, throughput);
- the reward curve (the mean emphasized, best and worst as gray context);
- update geometry (‖Δθ‖, ‖θ‖, the update direction's cosine, each its own
  chart);
- the caps' engagement (``es/cap_step_scale``, ``es/cap_theta_scale``: a
  value held below 1.0 means a cap rescales every update);
- ES health (finite-member share, antithetic pair asymmetry);
- the per-LoRA-target ‖Δθ‖ table (last epoch, top targets);
- the roofline panel and a table of the programs in ``programs.jsonl`` (the
  ledger ``obs/program_cost.py`` writes per ES plan: counted FLOPs and
  bytes, warm-up, capture and pool bytes);
- resilience (``resilience/*`` counters, the ``preempted.json`` and
  ``halted.json`` markers);
- Serving (from the ``serve/request`` spans of ``trace.jsonl``: latency
  percentiles, queue depth, batch occupancy);
- Capacity (``CAPACITY*.json`` of ``tools/loadgen.py --sweep``);
- predicted against measured (``CALIB*.json``, ``obs/calib.py``): roofline
  and profiled step times, their ratio, MFU claimed and measured, the
  hand-written kernels' device events;
- Quality (``QUALITY*.json``, ``quality.jsonl``, per-term and per-prompt
  rewards, ``snapshots/*.png``);
- Fleet (the ``job<j>/…`` streams of ``train/fleet.py``'s ``metrics.jsonl``);
- the phase table of ``tools/trace_report.py`` (count, total, mean,
  p50/p95/p99, max, % wall).

- the Pod panel of a multi-process run's per-host trace segments
  (``obs/podtrace.py``): straggler tiles, the per-host phase waterfall,
  the per-epoch barrier-wait timeline and the phase-spread table; the
  Resilience panel also holds the membership transitions (``elastic.json``)
  and the per-host table of ``resilience.host<i>.json``.

Series colors have fixed slots, text never wears a series color, a chart of
one series names it in its title, a chart of several has a legend, and every
point carries a native ``<title>`` tooltip.
"""

from __future__ import annotations

import argparse
import html
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

Num = float
Series = Tuple[str, List[Tuple[Num, Num]]]  # (label, [(x, y), ...])

# Fixed categorical slots (validated palette; identity never cycles).
_SLOT = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]
_CONTEXT = "#898781"  # de-emphasis gray for context series

_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 2rem auto; max-width: 1000px; padding: 0 1rem;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: var(--page); color: var(--ink);
  --page: #f9f9f7; --surface: #fcfcfb; --ink: #0b0b0b; --ink-2: #52514e;
  --muted: #898781; --grid: #e1e0d9; --baseline: #c3c2b7;
  --border: rgba(11,11,11,0.10); --good: #006300;
}
@media (prefers-color-scheme: dark) {
  body {
    --page: #0d0d0d; --surface: #1a1a19; --ink: #ffffff; --ink-2: #c3c2b7;
    --muted: #898781; --grid: #2c2c2a; --baseline: #383835;
    --border: rgba(255,255,255,0.10); --good: #0ca30c;
  }
}
h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 2rem; }
.sub { color: var(--ink-2); font-size: 0.85rem; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; margin: 1rem 0; }
.tile {
  background: var(--surface); border: 1px solid var(--border);
  border-radius: 8px; padding: 10px 14px; min-width: 130px;
}
.tile .label { font-size: 0.75rem; color: var(--ink-2); }
.tile .value { font-size: 1.5rem; font-weight: 600; }
.tile .delta { font-size: 0.8rem; color: var(--good); }
figure { margin: 1rem 0; background: var(--surface); border: 1px solid var(--border);
         border-radius: 8px; padding: 12px; }
figcaption { font-size: 0.9rem; margin-bottom: 6px; }
.legend { font-size: 0.78rem; color: var(--ink-2); margin: 2px 0 6px; }
.legend .key { display: inline-block; width: 14px; height: 3px;
               border-radius: 2px; vertical-align: middle; margin-right: 4px; }
.legend span.item { margin-right: 14px; }
table { border-collapse: collapse; font-size: 0.85rem; background: var(--surface); }
th, td { border: 1px solid var(--grid); padding: 4px 10px; text-align: right; }
th:first-child, td:first-child { text-align: left; }
th { color: var(--ink-2); font-weight: 600; }
td { font-variant-numeric: tabular-nums; }
svg text { fill: var(--muted); font-size: 10px;
           font-family: system-ui, -apple-system, "Segoe UI", sans-serif; }
"""


def _fmt(v: Any, digits: int = 4) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return html.escape(str(v))
    if not math.isfinite(f):
        return "—"
    if f != 0 and (abs(f) >= 10000 or abs(f) < 1e-3):
        return f"{f:.3g}"
    return f"{f:.{digits}f}".rstrip("0").rstrip(".") or "0"


def load_metrics(path: Path) -> List[Dict[str, Any]]:
    """Epoch rows from metrics.jsonl, file order; unparseable lines skipped."""
    rows = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "epoch" in row:
            rows.append(row)
    return rows


def series_of(rows: Sequence[Dict[str, Any]], key: str) -> List[Tuple[Num, Num]]:
    pts = []
    for row in rows:
        v = row.get(key)
        if isinstance(v, (int, float)) and math.isfinite(float(v)) \
                and isinstance(row.get("epoch"), (int, float)):
            pts.append((float(row["epoch"]), float(v)))
    return pts


def _ticks(lo: float, hi: float, n: int = 4) -> List[float]:
    """Clean-ish tick values covering [lo, hi]."""
    if hi <= lo:
        return [lo]
    span = hi - lo
    step = 10 ** math.floor(math.log10(span / max(n, 1)))
    for mult in (1, 2, 5, 10):
        if span / (step * mult) <= n:
            step *= mult
            break
    t0 = math.ceil(lo / step) * step
    out = []
    t = t0
    while t <= hi + 1e-12:
        out.append(round(t, 10))
        t += step
    return out or [lo]


def svg_line_chart(
    series: List[Series],
    colors: List[str],
    width: int = 460,
    height: int = 190,
    y_range: Optional[Tuple[float, float]] = None,
    zero_line: bool = False,
    x_name: str = "epoch",
) -> str:
    """One SVG line chart: hairline gridlines, 2px round-capped lines,
    ≥8px end markers with a surface ring, native <title> tooltips per point.
    Colors are text-free — identity lives in the HTML legend/caption."""
    series = [(lab, pts) for lab, pts in series if pts]
    if not series:
        return '<p class="sub">no data</p>'
    pad_l, pad_r, pad_t, pad_b = 46, 14, 8, 22
    xs = [x for _, pts in series for x, _ in pts]
    ys = [y for _, pts in series for _, y in pts]
    x0, x1 = min(xs), max(xs)
    if y_range is not None:
        y0, y1 = y_range
    else:
        y0, y1 = min(ys), max(ys)
        if y0 == y1:
            y0, y1 = y0 - 0.5, y1 + 0.5
        else:  # 5% headroom so curves don't kiss the frame
            m = 0.05 * (y1 - y0)
            y0, y1 = y0 - m, y1 + m
    if x0 == x1:
        x0, x1 = x0 - 0.5, x1 + 0.5

    def X(x: float) -> float:
        return pad_l + (x - x0) / (x1 - x0) * (width - pad_l - pad_r)

    def Y(y: float) -> float:
        return pad_t + (y1 - y) / (y1 - y0) * (height - pad_t - pad_b)

    out = [f'<svg viewBox="0 0 {width} {height}" width="100%" role="img">']
    for t in _ticks(y0, y1):
        yy = Y(t)
        out.append(
            f'<line x1="{pad_l}" y1="{yy:.1f}" x2="{width - pad_r}" y2="{yy:.1f}"'
            ' stroke="var(--grid)" stroke-width="1"/>'
            f'<text x="{pad_l - 5}" y="{yy + 3:.1f}" text-anchor="end">{_fmt(t, 3)}</text>'
        )
    if zero_line and y0 < 0 < y1:
        out.append(
            f'<line x1="{pad_l}" y1="{Y(0):.1f}" x2="{width - pad_r}" y2="{Y(0):.1f}"'
            ' stroke="var(--baseline)" stroke-width="1"/>'
        )
    # x axis: baseline + first/last epoch labels
    out.append(
        f'<line x1="{pad_l}" y1="{height - pad_b}" x2="{width - pad_r}"'
        f' y2="{height - pad_b}" stroke="var(--baseline)" stroke-width="1"/>'
        f'<text x="{pad_l}" y="{height - 6}" text-anchor="start">{_fmt(x0, 0)}</text>'
        f'<text x="{width - pad_r}" y="{height - 6}" text-anchor="end">{_fmt(x1, 0)}</text>'
    )
    for i, (label, pts) in enumerate(series):
        color = colors[i % len(colors)]
        path = " ".join(f"{X(x):.1f},{Y(y):.1f}" for x, y in pts)
        out.append(
            f'<polyline points="{path}" fill="none" stroke="{color}"'
            ' stroke-width="2" stroke-linejoin="round" stroke-linecap="round"/>'
        )
        # end marker: ≥8px with a 2px surface ring
        ex, ey = pts[-1]
        out.append(
            f'<circle cx="{X(ex):.1f}" cy="{Y(ey):.1f}" r="4" fill="{color}"'
            ' stroke="var(--surface)" stroke-width="2"/>'
        )
        for x, y in pts:  # invisible hit targets carrying native tooltips
            out.append(
                f'<circle cx="{X(x):.1f}" cy="{Y(y):.1f}" r="7" fill="transparent">'
                f"<title>{html.escape(label)} — {html.escape(x_name)} "
                f"{_fmt(x, 2 if x_name != 'epoch' else 0)}: {_fmt(y, 6)}</title>"
                "</circle>"
            )
    out.append("</svg>")
    return "".join(out)


def _legend(entries: List[Tuple[str, str]]) -> str:
    items = "".join(
        f'<span class="item"><span class="key" style="background:{c}"></span>'
        f"{html.escape(lab)}</span>"
        for lab, c in entries
    )
    return f'<div class="legend">{items}</div>'


def _figure(caption: str, body: str, legend: str = "") -> str:
    return (
        f"<figure><figcaption>{html.escape(caption)}</figcaption>"
        f"{legend}{body}</figure>"
    )


def _tile(label: str, value: str, delta: str = "") -> str:
    d = f'<div class="delta">{html.escape(delta)}</div>' if delta else ""
    return (
        f'<div class="tile"><div class="label">{html.escape(label)}</div>'
        f'<div class="value">{value}</div>{d}</div>'
    )


def _table(headers: List[str], rows: List[List[str]]) -> str:
    head = "".join(f"<th>{html.escape(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in r) + "</tr>" for r in rows
    )
    return f"<table><thead><tr>{head}</tr></thead><tbody>{body}</tbody></table>"


def _bytes_fmt(v: Any) -> str:
    """Human byte scale for table cells (GB above 1e9, MB above 1e6)."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "—"
    if f >= 1e9:
        return f"{f / 1e9:.2f} GB"
    if f >= 1e6:
        return f"{f / 1e6:.1f} MB"
    return f"{f / 1e3:.0f} kB"


def _serving_panel(events: List[Dict[str, Any]]) -> str:
    """Latency percentile tiles + queue-depth timeline + occupancy curve
    from the per-request trace spans. Empty string when the trace carries
    no serve traffic (training-only runs)."""
    from .trace_report import serving_summary

    serving = serving_summary(events)
    if not serving:
        return ""
    parts = ["<h2>Serving</h2>"]
    tiles = [_tile("Requests", str(serving["requests"]))]
    for key, label in (
        ("latency_p50_s", "Latency p50 (s)"),
        ("latency_p95_s", "Latency p95 (s)"),
        ("latency_p99_s", "Latency p99 (s)"),
        ("queue_wait_mean_s", "Queue wait mean (s)"),
        ("occupancy_mean", "Occupancy mean"),
    ):
        if isinstance(serving.get(key), (int, float)):
            tiles.append(_tile(label, _fmt(serving[key])))
    parts.append(f'<div class="tiles">{"".join(tiles)}</div>')

    # queue-depth timeline: depth after each enqueue (serve/submit spans,
    # queue_position + 1) and at each coalesce (serve/coalesce spans)
    depth_pts: List[Tuple[Num, Num]] = []
    occ_pts: List[Tuple[Num, Num]] = []
    for ev in events:
        a = ev.get("attrs", {})
        if ev["name"] == "serve/submit" and isinstance(
                a.get("queue_position"), (int, float)):
            depth_pts.append((float(ev["t0_s"]), float(a["queue_position"]) + 1))
        elif ev["name"] == "serve/coalesce" and isinstance(
                a.get("queue_depth"), (int, float)):
            depth_pts.append((float(ev["t0_s"]), float(a["queue_depth"])))
        if ev["name"] == "serve/batch" and isinstance(
                a.get("occupancy"), (int, float)):
            occ_pts.append((float(ev["t0_s"]), float(a["occupancy"])))
    depth_pts.sort()
    occ_pts.sort()
    if depth_pts:
        parts.append(_figure(
            "Queue depth over the session (requests pending at each "
            "enqueue/coalesce)",
            svg_line_chart([("queue depth", depth_pts)], [_SLOT[0]],
                           x_name="t (s)"),
        ))
    if occ_pts:
        parts.append(_figure(
            "Batch occupancy per dispatch (real requests ÷ adapter slots — "
            "1.0 = no padded lanes)",
            svg_line_chart([("occupancy", occ_pts)], [_SLOT[1]],
                           y_range=(0.0, 1.05), x_name="t (s)"),
        ))
    return "".join(parts)


def _capacity_panel(capacity_docs: List[Tuple[str, Dict[str, Any]]]) -> str:
    """The capacity-curve panel (``tools/loadgen.py --sweep`` artifacts in
    the run dir): headline tiles, the latency-vs-offered-load
    curve with the SLO line and the detected knee marked, and the
    hot-adapter + store-churn tables. Empty string when no CAPACITY*.json
    sits in the run dir."""
    parts = []
    for name, doc in capacity_docs:
        steps = [s for s in (doc.get("steps") or []) if isinstance(s, dict)]
        if not steps:
            continue
        parts.append("<h2>Capacity</h2>")
        parts.append(
            f'<p class="sub">{html.escape(name)} — '
            f"{html.escape(str(doc.get('headline', '')))}</p>"
        )
        knee = doc.get("knee") or {}
        tiles = [_tile("Capacity (req/s)", _fmt(doc.get("capacity_rps"))),
                 _tile("Goodput (req/s)", _fmt(doc.get("goodput_rps")))]
        if knee:
            tiles.append(_tile("Knee", f"{_fmt(knee.get('rate_rps'))} req/s",
                               str(knee.get("reason", ""))))
        else:
            tiles.append(_tile("Knee", "none", "ladder never saturated"))
        tiles.append(_tile("SLO p99 (s)", _fmt(doc.get("slo_p99_s"))))
        tiles.append(_tile("Zipf s / adapters",
                           f"{_fmt(doc.get('zipf_s'))} / "
                           f"{_fmt(doc.get('population'))}"))
        parts.append(f'<div class="tiles">{"".join(tiles)}</div>')

        # the capacity curve: open-loop p99 (emphasis) + completed-only p50
        # (context) against offered load, the SLO as a flat context line,
        # and the knee as a point marker on the p99 curve
        p99 = [(float(s["offered_rps"]), float(s["p99_open_s"]))
               for s in steps if isinstance(s.get("p99_open_s"), (int, float))]
        p50 = [(float(s["offered_rps"]), float(s["p50_s"]))
               for s in steps if isinstance(s.get("p50_s"), (int, float))]
        slo = doc.get("slo_p99_s")
        rates = [float(s["offered_rps"]) for s in steps]
        series: List[Series] = []
        colors: List[str] = []
        legend = []
        if isinstance(slo, (int, float)) and rates:
            series.append(("SLO p99",
                           [(min(rates), float(slo)), (max(rates), float(slo))]))
            colors.append(_CONTEXT)
            legend.append(("SLO", _CONTEXT))
        if p50:
            series.append(("p50 (completed)", p50))
            colors.append(_SLOT[2])
            legend.append(("p50 completed", _SLOT[2]))
        if p99:
            series.append(("p99 (open-loop)", p99))
            colors.append(_SLOT[0])
            legend.append(("p99 open-loop", _SLOT[0]))
        if knee and isinstance(knee.get("rate_rps"), (int, float)) \
                and isinstance(knee.get("p99_open_s"), (int, float)):
            series.append(("knee", [(float(knee["rate_rps"]),
                                     float(knee["p99_open_s"]))]))
            colors.append(_SLOT[1])
            legend.append(("knee", _SLOT[1]))
        if series:
            parts.append(_figure(
                "Latency vs offered load (open-loop: censored waits of "
                "rejected/still-queued requests are in the p99)",
                svg_line_chart(series, colors, x_name="offered req/s"),
                _legend(legend),
            ))

        srows = [[_fmt(s.get("offered_rps")), str(s.get("arrivals", "—")),
                  str(s.get("completed", "—")), str(s.get("rejected", "—")),
                  str(s.get("abandoned", "—")), _fmt(s.get("p99_open_s")),
                  _fmt(s.get("goodput_rps")), _fmt(s.get("store_hit_rate")),
                  str(s.get("store_evictions", "—")),
                  str(s.get("queue_end_depth", "—"))]
                 for s in steps]
        parts.append(_table(
            ["offered req/s", "arrivals", "completed", "rejected",
             "abandoned", "p99 open s", "goodput", "store hit rate",
             "evictions", "end queue"],
            srows,
        ))

        hot = doc.get("adapter_hotness") or []
        if hot:
            parts.append("<h3>Hot adapters</h3>")
            total = sum(int(h.get("requests", 0)) for h in hot) or 1
            parts.append(_table(
                ["adapter", "requests", "share of top-K"],
                [[html.escape(str(h.get("adapter", "?"))),
                  str(h.get("requests", "—")),
                  _fmt(100.0 * int(h.get("requests", 0)) / total, 1) + "%"]
                 for h in hot],
            ))
    return "".join(parts)


def _calib_panel(calib_docs: List[Tuple[str, Dict[str, Any]]]) -> str:
    """The measured-vs-model panel (``CALIB_*.json`` from ``obs/calib.py``):
    per reconciled program the roofline-predicted step time next to the
    profiler's device time or the host's wall clock, the error
    ratio, and MFU-claimed vs MFU-measured — the report stops presenting
    the analytical roofline as ground truth the moment real device time
    exists. Empty string when no CALIB*.json sits in the run dir."""
    parts = []
    for name, doc in calib_docs:
        rows = [r for r in (doc.get("rows") or []) if isinstance(r, dict)]
        if not rows:
            continue
        parts.append("<h2>Predicted vs measured</h2>")
        head = doc.get("headline") or {}
        chip = doc.get("chip_kind") or "unknown chip"
        parts.append(
            f'<p class="sub">{html.escape(name)} — roofline model vs '
            f"profiler device time on {html.escape(str(chip))}; "
            "error ratio = measured / predicted (1.0 = the model is "
            "honest)</p>"
        )
        tiles = [
            _tile("Programs reconciled", str(head.get("rows", len(rows)))),
            _tile("Device-timed", str(head.get("device_rows", 0)),
                  "rest fall back to host wall"),
        ]
        if isinstance(head.get("max_error_ratio"), (int, float)):
            tiles.append(_tile("Max error ratio",
                               _fmt(head["max_error_ratio"])))
        if isinstance(head.get("median_error_ratio"), (int, float)):
            tiles.append(_tile("Median error ratio",
                               _fmt(head["median_error_ratio"])))
        kev = doc.get("kernel_evidence") or {}
        for pat, ev in sorted(kev.items()):
            n = int(ev.get("events", 0)) if isinstance(ev, dict) else 0
            tiles.append(_tile(f"{pat} kernels", str(n),
                               "device events of the hand-written kernel"
                               if n else "NOT engaged in this capture"))
        parts.append(f'<div class="tiles">{"".join(tiles)}</div>')

        trows = [[html.escape(str(r.get("key", "?"))),
                  html.escape(str(r.get("measured_source", "?"))),
                  _fmt(r.get("measured_s"), 6), _fmt(r.get("predicted_s"), 6),
                  _fmt(r.get("error_ratio")),
                  _fmt(r.get("mfu_claimed")), _fmt(r.get("mfu_measured")),
                  _fmt((r.get("measured_flops_per_s") or 0) / 1e12
                       if isinstance(r.get("measured_flops_per_s"),
                                     (int, float)) else None),
                  _fmt((r.get("measured_bytes_per_s") or 0) / 1e9
                       if isinstance(r.get("measured_bytes_per_s"),
                                     (int, float)) else None)]
                 for r in rows]
        parts.append(_table(
            ["program", "source", "measured s", "predicted s", "error ratio",
             "MFU claimed", "MFU measured", "TFLOP/s", "GB/s"],
            trows,
        ))
        unmatched = doc.get("unmatched_programs") or []
        if unmatched:
            parts.append(
                f'<p class="sub">unmatched device programs (no ledger '
                f"record): {html.escape(', '.join(map(str, unmatched[:8])))}"
                f"{' …' if len(unmatched) > 8 else ''}</p>"
            )
    return "".join(parts)


def _quality_panel(run_dir: Path, rows: List[Dict[str, Any]],
                   quality_docs: List[Tuple[str, Dict[str, Any]]],
                   ledger_rows: List[Dict[str, Any]]) -> str:
    """The model-quality panel (``obs/quality.py``): sample-
    efficiency tiles + curve from the ``QUALITY_*.json`` artifact, the
    per-term reward decomposition and per-prompt small multiples from the
    in-step attribution vectors in metrics.jsonl, the hardest-prompts
    table from the quality.jsonl ledger, and any ``--snapshot_every``
    decoded-image grids embedded inline (base64 — the report stays
    self-contained). Empty string when the run carries no quality data."""
    import base64

    parts: List[str] = []

    # ---- sample-efficiency headline (QUALITY_*.json) ----------------------
    for name, doc in quality_docs:
        parts.append("<h2>Quality</h2>")
        parts.append(
            f'<p class="sub">{html.escape(name)} — combined reward vs '
            "cumulative images generated; device-seconds "
            f"{html.escape(str(doc.get('device_s_source', '?')))} "
            "(higher-is-better: the direction the quality sentry gates)</p>"
        )
        tiles = [_tile("Final reward", _fmt(doc.get("final_reward")))]
        if isinstance(doc.get("first_reward"), (int, float)) and \
                isinstance(doc.get("final_reward"), (int, float)):
            d = float(doc["final_reward"]) - float(doc["first_reward"])
            tiles[0] = _tile("Final reward", _fmt(doc["final_reward"]),
                             f"{'+' if d >= 0 else ''}{_fmt(d)} vs first")
        tiles += [
            _tile("AUC / images", _fmt(doc.get("auc_over_images"))),
            _tile("Images → 90% gain",
                  _fmt(doc.get("images_to_threshold"))
                  if doc.get("images_to_threshold") is not None
                  else "—"),
            _tile("Reward / device-s", _fmt(doc.get("reward_per_device_s"))),
            _tile("Images total", _fmt(doc.get("images_total"), 0)),
        ]
        parts.append(f'<div class="tiles">{"".join(tiles)}</div>')
        curve = [c for c in (doc.get("curve") or [])
                 if isinstance(c, dict)
                 and isinstance(c.get("images_cum"), (int, float))
                 and isinstance(c.get("combined"), (int, float))]
        pts = [(float(c["images_cum"]), float(c["combined"])) for c in curve]
        if len(pts) >= 2:
            parts.append(_figure(
                "Sample efficiency: combined reward vs cumulative images",
                svg_line_chart([("combined", pts)], [_SLOT[0]],
                               x_name="images generated"),
            ))
        dpts = [(float(c["device_s_cum"]), float(c["combined"]))
                for c in curve
                if isinstance(c.get("device_s_cum"), (int, float))]
        if len(dpts) >= 2 and dpts[-1][0] > 0:
            parts.append(_figure(
                "Combined reward vs cumulative device-seconds "
                f"({doc.get('device_s_source', '?')})",
                svg_line_chart([("combined", dpts)], [_SLOT[2]],
                               x_name="device seconds"),
            ))
        break  # one headline artifact; later files add nothing new

    # ---- per-term decomposition (reward/*_mean series) --------------------
    term_series: List[Series] = []
    for k in ("clip_aesthetic", "clip_text", "no_artifacts", "pickscore"):
        s = series_of(rows, f"reward/{k}_mean")
        if s:
            term_series.append((k, s))
    if term_series:
        if not parts:
            parts.append("<h2>Quality</h2>")
        colors = [_SLOT[i % len(_SLOT)] for i in range(len(term_series))]
        parts.append(_figure(
            "Per-term reward decomposition (population mean per epoch) — "
            "a term falling while combined rises is the reward-hacking "
            "signature the ledger alerts on",
            svg_line_chart(term_series, colors),
            _legend([(lab, colors[i])
                     for i, (lab, _) in enumerate(term_series)]),
        ))

    # ---- per-prompt small multiples (in-step attribution vectors) ---------
    prompt_curves: Dict[int, List[Tuple[Num, Num]]] = {}
    labels: Dict[int, str] = {}
    for row in rows:
        vec = row.get("quality/combined/prompt_mean")
        if not isinstance(vec, list):
            vec = row.get("per_prompt_mean")
        if not isinstance(vec, list) or \
                not isinstance(row.get("epoch"), (int, float)):
            continue
        texts = row.get("prompts")
        for j, v in enumerate(vec):
            if isinstance(v, (int, float)) and math.isfinite(float(v)):
                prompt_curves.setdefault(j, []).append(
                    (float(row["epoch"]), float(v)))
            if isinstance(texts, list) and j < len(texts):
                labels[j] = str(texts[j])
    multiples = [(j, pts) for j, pts in sorted(prompt_curves.items())
                 if len(pts) >= 2]
    if multiples:
        if not parts:
            parts.append("<h2>Quality</h2>")
        figs = []
        for j, pts in multiples[:8]:
            lab = labels.get(j, f"prompt {j}")
            figs.append(_figure(
                f"“{lab[:60]}” — combined mean per epoch",
                svg_line_chart([(lab, pts)], [_SLOT[j % len(_SLOT)]]),
            ))
        parts.append(
            '<p class="sub">per-prompt reward curves (in-step attribution; '
            "prompt identity = the last logged generation's sampled "
            "prompts)</p>" + "".join(figs)
        )
        if len(multiples) > 8:
            parts.append(f'<p class="sub">… {len(multiples) - 8} more '
                         "prompt(s) not shown</p>")

    # ---- hardest prompts (quality.jsonl, last row) ------------------------
    hardest = ledger_rows[-1].get("hardest") if ledger_rows else None
    if isinstance(hardest, list) and hardest:
        parts.append(_table(
            ["hardest prompts (last logged generation)", "idx", "mean"],
            [[html.escape(str(h.get("prompt", "?"))), str(h.get("idx", "?")),
              _fmt(h.get("mean"))]
             for h in hardest if isinstance(h, dict)],
        ))

    # ---- decoded-image snapshots (--snapshot_every) -----------------------
    snap_dir = run_dir / "snapshots"
    snaps = sorted(snap_dir.glob("*.png")) if snap_dir.is_dir() else []
    if snaps:
        if not parts:
            parts.append("<h2>Quality</h2>")
        imgs = []
        shown = snaps[-6:]  # the latest grids; older ones stay on disk
        for p in shown:
            try:
                b64 = base64.b64encode(p.read_bytes()).decode("ascii")
            except OSError:
                continue
            imgs.append(_figure(
                p.name,
                f'<img src="data:image/png;base64,{b64}" '
                f'alt="{html.escape(p.name)}" '
                'style="max-width:100%;height:auto">',
            ))
        if imgs:
            parts.append(
                '<p class="sub">decoded-image grids (best member, one row '
                "per repeat × one column per prompt — --snapshot_every)</p>"
                + "".join(imgs)
            )
            if len(snaps) > len(shown):
                parts.append(f'<p class="sub">… {len(snaps) - len(shown)} '
                             "earlier snapshot(s) in snapshots/</p>")
    return "".join(parts)


def _fleet_panel(rows: List[Dict[str, Any]]) -> str:
    """The fleet panel (``train/fleet.py`` scheduler): one table
    row per concurrent job from the ``job<j>/…`` namespaced streams the
    scheduler writes into metrics.jsonl (one line per fused tick, all
    jobs), plus per-job reward curves against the fleet tick. Empty string
    for non-fleet runs (no ``job<j>/`` keys)."""
    import re

    pat = re.compile(r"^job(\d+)/(.+)$")
    last_by_job: Dict[int, Dict[str, Any]] = {}
    reward_series: Dict[int, List[Tuple[Num, Num]]] = {}
    widths: List[Tuple[Num, Num]] = []
    for row in rows:
        tick = row.get("fleet_tick", row.get("epoch"))
        if isinstance(row.get("fleet_width"), (int, float)) and \
                isinstance(tick, (int, float)):
            widths.append((float(tick), float(row["fleet_width"])))
        for k, v in row.items():
            m = pat.match(k)
            if not m:
                continue
            j, sub = int(m.group(1)), m.group(2)
            last_by_job.setdefault(j, {})[sub] = v
            if sub == "opt_score_mean" and isinstance(v, (int, float)) \
                    and isinstance(tick, (int, float)):
                reward_series.setdefault(j, []).append((float(tick), float(v)))
    if not last_by_job:
        return ""
    parts = ["<h2>Fleet</h2>"]
    parts.append(
        '<p class="sub">concurrent ES jobs advanced by ONE compiled '
        "(job, member)-batched step against the resident base — per-job "
        "streams are the <code>job&lt;j&gt;/…</code> keys in "
        "metrics.jsonl</p>"
    )
    tiles = [_tile("Jobs seen", str(len(last_by_job)))]
    if widths:
        tiles.append(_tile("Fleet width (last tick)", _fmt(widths[-1][1], 0)))
    parts.append(f'<div class="tiles">{"".join(tiles)}</div>')

    trows = []
    for j in sorted(last_by_job):
        d = last_by_job[j]
        sha = str(d.get("reward_rows_sha256", ""))
        trows.append([
            html.escape(str(d.get("job_id", f"job{j}"))),
            str(j),
            _fmt(d.get("epoch"), 0),
            _fmt(d.get("opt_score_mean")),
            _fmt(d.get("reward/combined_mean")),
            _fmt(d.get("delta_norm"), 6),
            html.escape(sha[:12]) if sha else "—",
        ])
    parts.append(_table(
        ["job", "lane", "epoch", "opt score", "combined reward", "‖Δθ‖",
         "reward rows sha"],
        trows,
    ))
    series = [(f"job{j}", pts) for j, pts in sorted(reward_series.items())
              if len(pts) >= 2]
    if series:
        colors = [_SLOT[i % len(_SLOT)] for i in range(len(series))]
        parts.append(_figure(
            "Per-job reward (opt score mean) per fleet tick — fair-share "
            "interleaving means every active job advances each tick",
            svg_line_chart(series, colors, x_name="fleet tick"),
            _legend([(lab, colors[i]) for i, (lab, _) in enumerate(series)]),
        ))
    return "".join(parts)


def _pod_panel(pod: Dict[str, Any]) -> str:
    """The flight-recorder panel (obs/podtrace.py summary): straggler
    tiles, a per-host phase waterfall (stacked totals), the per-epoch
    barrier-wait timeline, and the cross-host phase-spread table. Empty
    string for single-host summaries — the no-op merge renders nothing."""
    if not pod or pod.get("n_hosts", 1) < 2:
        return ""
    parts = ["<h2>Pod</h2>"]
    tiles = [
        _tile("Hosts", str(pod["n_hosts"])),
        _tile("Aligned epochs", str(pod.get("n_epochs_aligned", 0))),
    ]
    strag = pod.get("straggler_host")
    if strag is not None:
        share = pod["critical_path_share"].get(strag, 0.0)
        tiles.append(_tile("Straggler host", str(strag),
                           f"{100.0 * share:.0f}% of epochs on the critical path"))
        tiles.append(_tile("Barrier wait / epoch",
                           f"{pod['epoch_spread_mean_s'] * 1e3:.1f} ms"))
    offs = [abs(v) for v in (pod.get("clock_offsets_s") or {}).values()
            if isinstance(v, (int, float))]
    if offs:
        tiles.append(_tile("Max clock offset", f"{max(offs):.3f} s"))
    if pod.get("unaligned_hosts"):
        tiles.append(_tile("Unaligned hosts",
                           ", ".join(map(str, pod["unaligned_hosts"]))))
    parts.append(f'<div class="tiles">{"".join(tiles)}</div>')

    # per-host phase waterfall: one stacked bar of phase totals per host —
    # the at-a-glance answer to "where did each host's wall clock go"
    phase_rows = pod.get("phase") or []
    hosts = pod.get("hosts") or []
    if phase_rows and hosts:
        pod_totals: Dict[str, float] = {}
        for r in phase_rows:
            pod_totals[r["phase"]] = pod_totals.get(r["phase"], 0.0) + r["total_s"]
        top = [p for p, _ in sorted(pod_totals.items(), key=lambda kv: -kv[1])][:4]
        per_host: Dict[Any, Dict[str, float]] = {h: {} for h in hosts}
        for r in phase_rows:
            key = r["phase"] if r["phase"] in top else "other"
            per_host[r["host"]][key] = per_host[r["host"]].get(key, 0.0) + r["total_s"]
        segments = top + (["other"] if any("other" in d for d in per_host.values()) else [])
        colors = {p: (_SLOT[i] if i < len(_SLOT) else _CONTEXT)
                  for i, p in enumerate(segments)}
        max_total = max((sum(d.values()) for d in per_host.values()), default=0.0)
        bar_h, gap, pad_l, width = 18, 10, 52, 460
        height = len(hosts) * (bar_h + gap) + 8
        svg = [f'<svg viewBox="0 0 {width} {height}" width="100%" role="img">']
        for i, h in enumerate(hosts):
            y = 4 + i * (bar_h + gap)
            svg.append(f'<text x="{pad_l - 6}" y="{y + bar_h - 5}" '
                       f'text-anchor="end">host {h}</text>')
            x = float(pad_l)
            for p in segments:
                v = per_host[h].get(p, 0.0)
                if v <= 0 or max_total <= 0:
                    continue
                w = (width - pad_l - 10) * v / max_total
                svg.append(
                    f'<rect x="{x:.1f}" y="{y}" width="{max(w, 0.5):.1f}" '
                    f'height="{bar_h}" fill="{colors[p]}">'
                    f"<title>host {h} — {html.escape(p)}: {v:.3f}s</title></rect>"
                )
                x += w
        svg.append("</svg>")
        parts.append(_figure(
            "Per-host phase waterfall (total seconds per phase; bars share "
            "one scale)",
            "".join(svg),
            _legend([(p, colors[p]) for p in segments]),
        ))

    # straggler timeline: per-epoch barrier wait per host (ms) — the host
    # pinned at ~0 is the one everyone else waits for
    per_epoch = pod.get("per_epoch") or []
    if per_epoch:
        wait_hosts = sorted(per_epoch[0].get("waits_s", {}))
        series = [
            (f"host {h}", [(float(e["epoch"]), 1e3 * float(e["waits_s"][h]))
                           for e in per_epoch if h in e.get("waits_s", {})])
            for h in wait_hosts
        ]
        parts.append(_figure(
            "Straggler timeline — per-epoch barrier wait (ms): a host near "
            "zero arrived last (the straggler), its peers show the wait it "
            "caused",
            svg_line_chart(series, _SLOT),
            _legend([(f"host {h}", _SLOT[i % len(_SLOT)])
                     for i, h in enumerate(wait_hosts)]),
        ))

    spread = pod.get("phase_spread") or {}
    if spread:
        parts.append(_table(
            ["phase", "hosts", "mean spread s", "p95 spread s", "slowest host"],
            [[html.escape(p), str(s["hosts"]), _fmt(s["mean_spread_s"]),
              _fmt(s["p95_spread_s"]), str(s["slowest_host"])]
             for p, s in sorted(spread.items())],
        ))
    return "".join(parts)


def render_report(run_dir: Path, rows: List[Dict[str, Any]],
                  trace_rows: Optional[List[Dict[str, Any]]],
                  coverage_pct: Optional[float],
                  programs: Optional[List[Dict[str, Any]]] = None,
                  trace_events: Optional[List[Dict[str, Any]]] = None,
                  pod: Optional[Dict[str, Any]] = None,
                  capacity: Optional[List[Tuple[str, Dict[str, Any]]]] = None,
                  calib: Optional[List[Tuple[str, Dict[str, Any]]]] = None,
                  quality: Optional[List[Tuple[str, Dict[str, Any]]]] = None,
                  quality_ledger: Optional[List[Dict[str, Any]]] = None,
                  ) -> str:
    last = rows[-1] if rows else {}
    first = rows[0] if rows else {}
    parts: List[str] = []
    parts.append(f"<h1>Run report — {html.escape(run_dir.name)}</h1>")
    parts.append(
        f'<p class="sub">{len(rows)} logged epochs · generated from '
        "metrics.jsonl + trace.jsonl by tools/run_report.py — self-contained, "
        "no network</p>"
    )

    # ---- stat tiles -------------------------------------------------------
    tiles = [_tile("Epochs logged", str(len(rows)))]
    if "opt_score_mean" in last:
        delta = ""
        if isinstance(first.get("opt_score_mean"), (int, float)) and \
                isinstance(last.get("opt_score_mean"), (int, float)):
            d = float(last["opt_score_mean"]) - float(first["opt_score_mean"])
            delta = f"{'+' if d >= 0 else ''}{_fmt(d)} vs first epoch"
        tiles.append(_tile("Reward (mean)", _fmt(last["opt_score_mean"]), delta))
    for key, label in (
        ("images_per_sec", "Images/sec"),
        ("es/finite_frac", "Finite members"),
        ("es/update_cosine", "Update cosine"),
    ):
        if isinstance(last.get(key), (int, float)):
            tiles.append(_tile(label, _fmt(last[key])))
    parts.append(f'<div class="tiles">{"".join(tiles)}</div>')

    # ---- reward curve (emphasis: mean in slot 1, best/worst as context) ---
    mean_s = series_of(rows, "opt_score_mean")
    best_s = series_of(rows, "opt_score_best")
    worst_s = series_of(rows, "opt_score_worst")
    if mean_s:
        series = [("best", best_s), ("worst", worst_s), ("mean", mean_s)]
        colors = [_CONTEXT, _CONTEXT, _SLOT[0]]
        legend = _legend([("mean", _SLOT[0]), ("best / worst", _CONTEXT)])
        parts.append("<h2>Reward</h2>")
        parts.append(_figure(
            "Population reward per epoch (prompt-normalized opt score)",
            svg_line_chart(series, colors), legend,
        ))

    # ---- update geometry: separate charts, never a dual axis --------------
    geo = ""
    delta_s = series_of(rows, "delta_norm") or series_of(rows, "es/delta_norm")
    theta_s = series_of(rows, "theta_norm") or series_of(rows, "es/theta_norm")
    cos_s = series_of(rows, "es/update_cosine")
    if delta_s:
        geo += _figure("Update norm ‖Δθ‖ per epoch",
                       svg_line_chart([("‖Δθ‖", delta_s)], [_SLOT[0]]))
    if theta_s:
        geo += _figure("Parameter norm ‖θ‖ per epoch",
                       svg_line_chart([("‖θ‖", theta_s)], [_SLOT[0]]))
    if cos_s:
        geo += _figure(
            "Update direction cosine(Δθ_t, Δθ_{t−1}) — ≈+1 steady descent, "
            "≈−1 oscillation, ≈0 noise-dominated",
            svg_line_chart([("update cosine", cos_s)], [_SLOT[0]],
                           y_range=(-1.05, 1.05), zero_line=True),
        )
    if geo:
        parts.append("<h2>Update geometry</h2>")
        parts.append(geo)

    # ---- cap engagement timeline ------------------------------------------
    step_cap = series_of(rows, "es/cap_step_scale")
    theta_cap = series_of(rows, "es/cap_theta_scale")
    if step_cap or theta_cap:
        engaged = sum(1 for _, v in step_cap + theta_cap if v < 1.0)
        parts.append("<h2>Norm-cap engagement</h2>")
        parts.append(_figure(
            f"Applied rescale factor per epoch (1.0 = cap not engaged; "
            f"{engaged} engaged points)",
            svg_line_chart(
                [("cap_step_scale", step_cap), ("cap_theta_scale", theta_cap)],
                [_SLOT[0], _SLOT[1]], y_range=(0.0, 1.05),
            ),
            _legend([("step cap", _SLOT[0]), ("θ cap", _SLOT[1])]),
        ))

    # ---- ES health ---------------------------------------------------------
    es_figs = ""
    finite_s = series_of(rows, "es/finite_frac")
    zero_s = series_of(rows, "es/fitness_zero")
    if finite_s or zero_s:
        es_figs += _figure(
            "Finite-member fraction and degenerate (all-zero-fitness) epochs",
            svg_line_chart(
                [("finite_frac", finite_s), ("fitness_zero", zero_s)],
                [_SLOT[0], _SLOT[1]], y_range=(-0.05, 1.1),
            ),
            _legend([("finite members ÷ pop", _SLOT[0]),
                     ("fitness all-zero", _SLOT[1])]),
        )
    pair_s = series_of(rows, "es/pair_asym")
    if pair_s:
        es_figs += _figure(
            "Antithetic pair asymmetry |r(+ε)−r(−ε)| / reward std — "
            "≈0 means pairs stopped disagreeing (no usable signal)",
            svg_line_chart([("pair_asym", pair_s)], [_SLOT[0]]),
        )
    if es_figs:
        parts.append("<h2>ES health</h2>")
        parts.append(es_figs)

    # ---- per-LoRA-target ‖Δθ‖ (last epoch, table: >8 targets fold) --------
    leaf = sorted(
        (
            (k[len("es/leaf_delta_norm/"):], float(v))
            for k, v in last.items()
            if k.startswith("es/leaf_delta_norm/") and isinstance(v, (int, float))
        ),
        key=lambda kv: -kv[1],
    )
    if leaf:
        shown = leaf[:8]
        rest = leaf[8:]
        trows = [[html.escape(name), _fmt(v, 6)] for name, v in shown]
        if rest:
            trows.append([
                f"(+{len(rest)} more targets)",
                _fmt(sum(v * v for _, v in rest) ** 0.5, 6),
            ])
        parts.append("<h2>Per-target ‖Δθ‖ (last epoch)</h2>")
        parts.append(_table(["LoRA target", "‖Δθ‖"], trows))

    # ---- roofline panel + per-program table (programs.jsonl) --------------
    roof_parts = ""
    bound = last.get("roofline/bound")
    if isinstance(bound, str):
        tiles = [_tile("Step bound by", html.escape(bound))]
        for key, label in (
            ("roofline/t_compute_s", "Compute floor (s)"),
            ("roofline/t_bandwidth_s", "Bandwidth floor (s)"),
            ("step_time_s", "Measured step (s)"),
            ("roofline/intensity", "Intensity (FLOP/B)"),
        ):
            if isinstance(last.get(key), (int, float)):
                tiles.append(_tile(label, _fmt(last[key])))
        roof_parts += f'<div class="tiles">{"".join(tiles)}</div>'
        roof_parts += (
            '<p class="sub">bound = compute/bandwidth: the larger hardware '
            "floor; latency: measured step &gt; 2× both floors (dispatch/RTT "
            "overhead)</p>"
        )
    if programs:
        prows = []
        for p in programs:
            g = p.get("geometry") or {}
            geom = " ".join(
                f"{k}={g[k]}" for k in ("m", "r", "pop", "member_batch") if k in g
            )
            prows.append([
                html.escape(str(p.get("label", "?"))),
                html.escape(str(p.get("site", "?"))),
                html.escape(geom or "—"),
                str(p.get("chain", 1)),
                _fmt((p.get("flops") or 0) / 1e12, 3) if p.get("flops") else "—",
                _bytes_fmt(p.get("bytes_accessed")),
                _fmt(p.get("intensity"), 2),
                _bytes_fmt(p.get("peak_bytes")),
                _bytes_fmt(p.get("pool_bytes")),
                _fmt(p.get("warmup_s"), 2),
                _fmt(p.get("capture_s"), 2),
                str(sum(int(k.get("calls", 0)) for k in p["kernels"].values()))
                if p.get("kernels") else "—",
            ])
        roof_parts += _table(
            ["program", "site", "geometry", "chain", "TFLOP", "bytes moved",
             "FLOP/B", "peak bytes", "graph pool", "warm-up s", "capture s",
             "kernel calls"],
            prows,
        )
        roof_parts += (
            '<p class="sub">FLOPs and bytes counted over each program\'s '
            "warm-up (obs/program_cost.py), not a compiler's estimate; peak "
            "bytes only on preflight records</p>"
        )
    if roof_parts:
        parts.append("<h2>Roofline &amp; programs</h2>")
        parts.append(roof_parts)

    # ---- resilience panel (resilience/* counters + markers) ---------------
    res_parts = ""
    markers = []
    for mname, blurb in (("preempted.json", "preempted — checkpointed and exited cleanly"),
                         ("halted.json", "HALTED by the rollback policy")):
        mpath = run_dir / mname
        if mpath.exists():
            try:
                payload = json.loads(mpath.read_text())
            except (OSError, json.JSONDecodeError):
                payload = {}
            markers.append(
                f'<p class="sub"><strong>{html.escape(blurb)}</strong> at epoch '
                f"{_fmt(payload.get('epoch'), 0)}"
                + (f" — {html.escape(str(payload['reason']))}" if payload.get("reason") else "")
                + (f" ({html.escape(str(payload['policy']))} policy)" if payload.get("policy") else "")
                + "</p>"
            )
    res_last = {k: v for k, v in last.items() if k.startswith("resilience/")}
    if markers or res_last:
        res_parts += "".join(markers)
        tile_keys = (
            ("resilience/rollbacks", "Rollbacks"),
            ("resilience/retries", "I/O retries"),
            ("resilience/restore_rejected", "Slots rejected"),
            ("resilience/faults_injected", "Faults injected"),
            ("resilience/last_good_epoch", "Last good epoch"),
            ("resilience/last_saved_epoch", "Last saved epoch"),
        )
        tiles = [
            _tile(label, _fmt(res_last[key], 0))
            for key, label in tile_keys
            if isinstance(res_last.get(key), (int, float))
        ]
        if tiles:
            res_parts += f'<div class="tiles">{"".join(tiles)}</div>'
        rb_s = series_of(rows, "resilience/rollbacks")
        if any(v > 0 for _, v in rb_s):
            res_parts += _figure(
                "Cumulative rollbacks per epoch (each step = one non-finite/"
                "diverged θ rolled back to the last good slot)",
                svg_line_chart([("rollbacks", rb_s)], [_SLOT[1]]),
            )
        # only what the tiles don't already show (per-site retry counters &c)
        tiled = {key for key, _ in tile_keys}
        extra = sorted(
            (k, v) for k, v in res_last.items()
            if isinstance(v, (int, float)) and k not in tiled
        )
        if extra:
            res_parts += _table(
                ["counter / gauge", "value"],
                [[html.escape(k), _fmt(v, 0)] for k, v in extra],
            )
    # membership transitions (elastic.json, resilience/elastic.py): every
    # roll-call verdict (hard-failed hosts voted out) and reshard restore
    # (relaunch at a new process count) this run dir accumulated — the
    # elastic-topology half of the panel
    elastic_path = run_dir / "elastic.json"
    if elastic_path.exists():
        try:
            transitions = json.loads(elastic_path.read_text())
        except (OSError, json.JSONDecodeError):
            transitions = []
        trows = []
        for t in transitions if isinstance(transitions, list) else []:
            if t.get("kind") == "reshard_restore":
                frm = (t.get("from") or {}).get("process_count", "?")
                to = (t.get("to") or {}).get("process_count", "?")
                detail = f"{frm} → {to} process(es)"
            else:
                detail = (f"dead {t.get('dead')} → survivors "
                          f"{t.get('survivors')}")
            trows.append([
                html.escape(str(t.get("kind", "?"))),
                _fmt(t.get("epoch"), 0),
                html.escape(detail),
                html.escape(str(t.get("action", "—"))),
                (_fmt(float(t["detect_s"]) * 1e3, 0) + " ms")
                if isinstance(t.get("detect_s"), (int, float)) else "—",
                html.escape(str(t.get("incarnation", "—"))),
            ])
        if trows:
            res_parts += "<h3>Membership transitions</h3>"
            res_parts += _table(
                ["kind", "epoch", "membership", "action", "detection",
                 "incarnation"],
                trows,
            )
    # per-host rows (resilience.host<i>.json — written by EVERY process at
    # save boundaries and exit, since metrics.jsonl is master-only and a
    # pod's non-master counters would otherwise be invisible)
    host_rows = []
    # numeric host order (lexicographic filename sort puts host10 before
    # host2 — wrong for exactly the pod sizes the panel exists for)
    for hp in sorted(
        run_dir.glob("resilience.host*.json"),
        key=lambda p: (int(p.stem[len("resilience.host"):])
                       if p.stem[len("resilience.host"):].isdigit()
                       else 1 << 30, p.name),
    ):
        try:
            payload = json.loads(hp.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        host_rows.append([
            str(payload.get("process_index", hp.name)),
            _fmt(payload.get("epoch"), 0),
            _fmt(payload.get("resilience/preempt_requests", 0), 0),
            _fmt(payload.get("resilience/rollbacks", 0), 0),
            _fmt(payload.get("resilience/desync", 0), 0),
            _fmt(payload.get("resilience/retries", 0), 0),
            _fmt(payload.get("resilience/ckpt_commits", 0), 0),
            _fmt(payload.get("resilience/ckpt_commit_failed", 0), 0),
            _fmt(payload.get("resilience/faults_injected", 0), 0),
            {True: "yes", False: "—"}.get(bool(payload.get("preempted")), "—"),
            {True: "yes", False: "—"}.get(bool(payload.get("halted")), "—"),
        ])
    if host_rows:
        res_parts += "<h3>Per-host resilience</h3>"
        res_parts += _table(
            ["host", "epoch", "preempt req", "rollbacks", "desync", "retries",
             "commits", "commit fails", "faults", "preempted", "halted"],
            host_rows,
        )
    if res_parts:
        parts.append("<h2>Resilience</h2>")
        parts.append(res_parts)

    # ---- Pod panel (flight recorder, obs/podtrace.py) ----------
    if pod:
        parts.append(_pod_panel(pod))

    # ---- Serving panel (per-request trace spans) ----
    if trace_events:
        parts.append(_serving_panel(trace_events))

    # ---- Capacity panel (CAPACITY*.json from loadgen --sweep) ----
    if capacity:
        parts.append(_capacity_panel(capacity))

    # ---- Predicted-vs-measured panel (CALIB*.json, obs/calib) -------------------
    if calib:
        parts.append(_calib_panel(calib))

    # ---- Quality panel (QUALITY*.json + quality.jsonl, obs/quality — 18) --
    qp = _quality_panel(run_dir, rows, quality or [], quality_ledger or [])
    if qp:
        parts.append(qp)

    # ---- Fleet panel (job<j>/ streams from train/fleet.py) ----------------------
    fp = _fleet_panel(rows)
    if fp:
        parts.append(fp)

    # ---- per-phase time table (trace.jsonl, reusing trace_report) ---------
    if trace_rows:
        parts.append("<h2>Host-side phase times (trace.jsonl)</h2>")
        if coverage_pct is not None:
            parts.append(
                f'<p class="sub">top-level span coverage: {coverage_pct:.1f}% '
                "of wall clock</p>"
            )
        parts.append(_table(
            ["phase", "count", "total s", "mean s", "p50 s", "p95 s",
             "p99 s", "max s", "% wall"],
            [
                [html.escape(str(r["phase"])), str(r["count"]), _fmt(r["total_s"]),
                 _fmt(r["mean_s"]), _fmt(r["p50_s"]), _fmt(r["p95_s"]),
                 _fmt(r["p99_s"]), _fmt(r["max_s"]),
                 _fmt(r["pct_wall"], 1)]
                for r in trace_rows
            ],
        ))

    # ---- last-epoch scalar table (the no-chart fallback view) -------------
    scalar_rows = [
        [html.escape(k), _fmt(v, 6)]
        for k, v in sorted(last.items())
        if isinstance(v, (int, float)) and not k.startswith("hist/")
    ]
    if scalar_rows:
        parts.append("<h2>All scalars (last epoch)</h2>")
        parts.append(_table(["metric", "value"], scalar_rows))

    body = "\n".join(parts)
    return (
        "<!doctype html>\n<html lang=\"en\"><head><meta charset=\"utf-8\">"
        f"<title>run report — {html.escape(run_dir.name)}</title>"
        f"<style>{_CSS}</style></head>\n<body>\n{body}\n</body></html>\n"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="run dir containing metrics.jsonl (+ trace.jsonl)")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: <run_dir>/run_report.html)")
    args = ap.parse_args(argv)

    run_dir = Path(args.run_dir)
    metrics_path = run_dir / "metrics.jsonl"
    # capacity sweeps (tools/loadgen.py --run_dir) produce a run dir with
    # CAPACITY*.json + trace.jsonl but no training metrics — still a report
    capacity = []
    for cp in sorted(run_dir.glob("CAPACITY*.json")):
        try:
            doc = json.loads(cp.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(doc, dict) and doc.get("mode") == "capacity":
            capacity.append((cp.name, doc))
    # calibration artifacts (obs/calib.py) — the
    # Predicted-vs-measured panel; also a valid report on their own
    calib = []
    from ..obs.calib import load_calib

    for cp in sorted(run_dir.glob("CALIB*.json")):
        try:
            doc = load_calib(cp)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and doc.get("mode") == "calib" \
                and doc.get("rows"):
            calib.append((cp.name, doc))
    # quality artifacts + ledger (obs/quality.py) — the Quality panel
    quality = []
    from ..obs.quality import load_quality

    for qp in sorted(run_dir.glob("QUALITY*.json")):
        doc = load_quality(qp)
        if doc is not None:
            quality.append((qp.name, doc))
    quality_ledger = []
    if (run_dir / "quality.jsonl").exists():
        from ..utils.jsonl import read_jsonl_rows

        quality_ledger = read_jsonl_rows(run_dir / "quality.jsonl")
    rows = load_metrics(metrics_path) if metrics_path.exists() else []
    if not rows and not capacity and not calib:
        print(f"no epoch rows in {metrics_path} and no CAPACITY*.json / "
              f"CALIB*.json in {run_dir}", file=sys.stderr)
        return 1

    from ..obs.program_cost import load_programs

    programs = load_programs(run_dir)  # [] when no programs.jsonl

    trace_rows = coverage_pct = None
    trace_events = None
    pod = None
    from ..obs.podtrace import discover_trace_segments, load_pod_events, pod_summary
    from ..obs.trace import load_events
    from .trace_report import aggregate, coverage, latest_session

    segments = discover_trace_segments(run_dir)
    if len(segments) > 1:
        # every segment parsed once: the merge reads them all, and the lowest
        # rank's slice feeds the phase table and the Serving panel
        pod_events = load_pod_events(run_dir)
        pod = pod_summary(run_dir, events=pod_events)
        events = [e for e in pod_events if e["host"] == min(segments)]
        if events:
            trace_rows = aggregate(events)
            coverage_pct = 100.0 * coverage(events)
            trace_events = events
    elif (run_dir / "trace.jsonl").exists():
        events = latest_session(load_events(run_dir / "trace.jsonl"))
        if events:
            trace_rows = aggregate(events)
            coverage_pct = 100.0 * coverage(events)
            trace_events = events  # the Serving panel reads the raw spans

    out = Path(args.out) if args.out else run_dir / "run_report.html"
    out.write_text(render_report(run_dir, rows, trace_rows, coverage_pct,
                                 programs, trace_events, pod,
                                 capacity=capacity, calib=calib,
                                 quality=quality,
                                 quality_ledger=quality_ledger))
    print(f"run report → {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
