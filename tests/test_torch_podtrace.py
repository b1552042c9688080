"""The pod flight recorder of the port (``obs/podtrace.py``) and the pod
surfaces of its reports, against the JAX package on the same run dirs.

The segments are ``tests/test_podtrace.py``'s synthetic pods (controlled
clock offsets, per-epoch straggles, stale sessions, duplicate anchors, a
host that cannot be aligned, a segment-only dir, one process). On each:

- every public function of ``obs.podtrace`` returns what the JAX one does
  (the summary, the gauges and ``pod_summary.json`` exactly; each
  difference measured is 0);
- ``tools/trace_report`` prints the JAX report's text (the pooled and
  per-host tables and the Pod section) and writes the same pod-aligned
  Chrome trace;
- ``tools/run_report`` writes the JAX report's HTML byte for byte: the Pod
  panel, and the Resilience panel's membership transitions
  (``elastic.json``) and per-host table (``resilience.host<i>.json``).
"""

import json

import pytest
import torch

from hyperscalees_t2i_tpu.obs import podtrace as jpodtrace
from hyperscalees_t2i_tpu.tools import run_report as jrun_report
from hyperscalees_t2i_tpu.tools import trace_report as jtrace_report
from hyperscalees_t2i_tpu_torch.obs import podtrace
from hyperscalees_t2i_tpu_torch.tools import run_report, trace_report

from test_podtrace import write_segment

torch.set_num_threads(1)

# (name, [(host, write_segment kwargs), ...])
PODS = [
    ("straggler", [(0, {"offset": 3.0}), (1, {"offset": -2.0, "delays": {2: 0.2, 3: 0.2, 4: 0.2}})]),
    ("far_offset", [(0, {}), (1, {"offset": 1000.0})]),
    ("segments_only", [(1, {"offset": 4.0}), (2, {"offset": 8.0, "delays": {1: 0.25, 3: 0.25}})]),
    ("stale_sessions", [(0, {"sessions": 2}), (1, {"sessions": 3, "delays": {1: 0.1}})]),
    ("duplicate_anchor", [(0, {"dup_epoch": 2}), (1, {"dup_epoch": 2, "delays": {4: 0.3}})]),
    ("unalignable", [(0, {}), (1, {"delays": {1: 0.2}}), (2, {"anchor_epochs": []})]),
    ("three_hosts", [(0, {}), (1, {"delays": {e: 0.15 for e in range(6)}}), (10, {"offset": 7.0})]),
    ("one_process", [(0, {})]),
]


def _pod(tmp_path, hosts):
    tmp_path.mkdir(parents=True, exist_ok=True)
    for h, kw in hosts:
        write_segment(tmp_path, h, **kw)
    return tmp_path


def _plain(x):
    """JSON's view (int keys become strings), for comparing nested results."""
    return json.loads(json.dumps(x, sort_keys=True, default=str))


@pytest.mark.parametrize("name, hosts", PODS, ids=[p[0] for p in PODS])
def test_every_function_equals_jax(tmp_path, name, hosts):
    d = _pod(tmp_path, hosts)
    assert podtrace.discover_trace_segments(d) == jpodtrace.discover_trace_segments(d)
    events, jevents = podtrace.load_pod_events(d), jpodtrace.load_pod_events(d)
    assert events == jevents
    anchors = podtrace.epoch_anchors(events)
    assert anchors == jpodtrace.epoch_anchors(jevents)
    offsets = podtrace.host_clock_offsets(anchors)
    assert offsets == jpodtrace.host_clock_offsets(anchors)
    for ref in sorted(anchors):
        assert podtrace.host_clock_offsets(anchors, ref) == jpodtrace.host_clock_offsets(anchors, ref)
    assert podtrace.align_events(events, offsets) == jpodtrace.align_events(jevents, offsets)
    assert podtrace.pod_phase_stats(events) == jpodtrace.pod_phase_stats(jevents)
    for min_spread in (0.0, 0.002, 0.05):
        assert podtrace.straggler_stats(anchors, offsets, min_spread) == \
            jpodtrace.straggler_stats(anchors, offsets, min_spread)
    summary, jsummary = podtrace.pod_summary(d), jpodtrace.pod_summary(d)
    assert summary == jsummary
    assert podtrace.pod_summary(d, events=events) == summary
    assert podtrace.pod_gauges(summary) == jpodtrace.pod_gauges(jsummary)
    ours = podtrace.write_pod_summary(d, summary).read_bytes()
    theirs = jpodtrace.write_pod_summary(d, jsummary).read_bytes()
    assert ours == theirs
    err = max([abs(a - b) for a, b in zip(_plain(summary).get("epoch_spread_s") or [],
                                           _plain(jsummary).get("epoch_spread_s") or [])], default=0.0)
    print(f"{name}: largest gap in the epoch spreads {err}")
    assert err == 0.0


def test_empty_dir_has_no_summary(tmp_path):
    assert podtrace.pod_summary(tmp_path) is None and jpodtrace.pod_summary(tmp_path) is None
    assert podtrace.discover_trace_segments(tmp_path) == {}


@pytest.mark.parametrize("name, hosts", PODS, ids=[p[0] for p in PODS])
def test_trace_report_pod_section_equals_jax(tmp_path, capsys, name, hosts):
    d = _pod(tmp_path, hosts)
    assert jtrace_report.main([str(d), "--chrome", str(tmp_path / "j.json")]) == 0
    theirs = capsys.readouterr().out
    assert trace_report.main([str(d), "--chrome", str(tmp_path / "p.json")]) == 0
    ours = capsys.readouterr().out
    assert ours.replace("p.json", "j.json") == theirs
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads((tmp_path / "j.json").read_text())
    if len(hosts) > 1:
        assert "## pod" in ours and "## pooled" in ours
        summary = podtrace.pod_summary(d)
        assert trace_report.render_pod_section(summary) == jtrace_report.render_pod_section(summary)
    else:
        assert "# trace report:" in ours and "## pod" not in ours


def _resilience_files(d):
    (d / "elastic.json").write_text(json.dumps([
        {"kind": "rollcall", "round": "g7", "epoch": 3, "dead": [1], "survivors": [0, 2], "action": "continue",
         "incarnation": 0, "detect_s": 10.412},
        {"kind": "reshard_restore", "epoch": 3, "from": {"process_count": 2}, "to": {"process_count": 1},
         "action": "reshard", "incarnation": 3}]))
    for h in (0, 1, 10):
        (d / f"resilience.host{h}.json").write_text(json.dumps({
            "process_index": h, "epoch": 5, "resilience/rollbacks": h % 3, "resilience/ckpt_commits": 2,
            "resilience/faults_injected": 1 if h == 1 else 0, "preempted": h == 10, "halted": False}))


@pytest.mark.parametrize("name, hosts", PODS, ids=[p[0] for p in PODS])
def test_run_report_pod_panel_equals_jax(tmp_path, capsys, name, hosts):
    d = _pod(tmp_path / "run", hosts)
    with (d / "metrics.jsonl").open("w") as f:
        for e in range(3):
            f.write(json.dumps({"epoch": e, "opt_score_mean": 0.1 * e, "step_time_s": 0.1,
                                "resilience/rollbacks": 0}) + "\n")
    _resilience_files(d)
    assert jrun_report.main([str(d), "--out", str(tmp_path / "j.html")]) == 0
    assert run_report.main([str(d), "--out", str(tmp_path / "p.html")]) == 0
    capsys.readouterr()
    ours, theirs = (tmp_path / "p.html").read_text(), (tmp_path / "j.html").read_text()
    assert ours == theirs
    assert "<h3>Membership transitions</h3>" in ours and "<h3>Per-host resilience</h3>" in ours
    assert ("<h2>Pod</h2>" in ours) == (len(hosts) > 1)
    summary = podtrace.pod_summary(d)
    assert run_report._pod_panel(summary) == jrun_report._pod_panel(summary)
