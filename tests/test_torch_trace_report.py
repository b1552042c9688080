"""``tools/trace_report.py`` and ``obs/trace.to_chrome`` of the port against
the JAX package's on the same events.

- Parity: ``aggregate``, ``coverage``, ``wall_clock_s``, ``serving_summary``
  and ``to_chrome`` are equal to the JAX functions on the same events
  (synthetic ones, a resumed trace, served requests, and the trace of a port
  ``run_training``); the CLI prints the same report.
- Cross-reading: the JAX ``trace_report`` exits 0 on a run dir that the
  port's trainer wrote (tiny Sana, ``trace=True``) and prints the port's
  phase table.
- Ported from ``tests/test_obs.py``: the Chrome export's shape, the traced
  training run (coverage ≥ 90%, ``--chrome``), the aggregation math, the
  latest session of a resumed run, nearest-rank p95, coverage with gaps.
  Not ported: ``_p95`` itself (the port calls ``utils.stats.nearest_rank``
  directly; the case is kept on it), the decorator and global tracer of
  ``test_disabled_tracer_is_noop_and_decorator_resolves_late`` (the port's
  tracer is passed, not global), the multi-host segment test (ROADMAP item
  7: a dir with segments raises, below).
"""

import json
import re

import pytest
import torch

from hyperscalees_t2i_tpu.obs.trace import load_events as jload_events
from hyperscalees_t2i_tpu.obs.trace import to_chrome as jto_chrome
from hyperscalees_t2i_tpu.tools import trace_report as jtrace_report
from hyperscalees_t2i_tpu_torch.obs.trace import Tracer, load_events, to_chrome
from hyperscalees_t2i_tpu_torch.tools import trace_report
from hyperscalees_t2i_tpu_torch.utils.stats import nearest_rank

torch.set_num_threads(1)


def _write(path, lines):
    path.write_text("\n".join(json.dumps(e) for e in lines) + "\n")
    return path


SYNTHETIC = [
    {"name": "epoch", "t0_s": 0.0, "dur_s": 4.0, "depth": 0, "parent": None},
    {"name": "dispatch", "t0_s": 0.5, "dur_s": 3.0, "depth": 1, "parent": "epoch", "attrs": {"epochs": 1}},
    {"name": "epoch", "t0_s": 4.0, "dur_s": 4.0, "depth": 0, "parent": None},
    {"name": "dispatch", "t0_s": 4.5, "dur_s": 1.0, "depth": 1, "parent": "epoch"},
]
RESUMED = [
    {"meta": "trace_start", "wall_time": 1.0, "pid": 1},
    {"name": "epoch", "t0_s": 0.0, "dur_s": 100.0, "depth": 0},
    {"meta": "trace_start", "wall_time": 2.0, "pid": 2},
    {"name": "epoch", "t0_s": 0.0, "dur_s": 2.0, "depth": 0},
    {"name": "epoch", "t0_s": 2.0, "dur_s": 2.0, "depth": 0},
]
SERVED = [
    {"name": "serve/request", "t0_s": 0.1 * i, "dur_s": 0.05 + 0.01 * i, "depth": 0, "parent": None,
     "attrs": {"queue_wait_s": 0.01 * i, "dispatch_s": 0.04, "assembly_s": 0.002, "occupancy": 0.5 + 0.1 * (i % 3)}}
    for i in range(12)
] + [{"name": "serve/dispatch", "t0_s": 0.3, "dur_s": 0.04, "depth": 0, "parent": None}]
GAPS = [
    {"name": "a", "t0_s": 0.0, "dur_s": 1.0, "depth": 0},
    {"name": "b", "t0_s": 3.0, "dur_s": 1.0, "depth": 0},
    {"name": "c", "t0_s": 1.0, "dur_s": 2.0, "depth": 1},
]


@pytest.mark.parametrize("lines", [SYNTHETIC, RESUMED, SERVED, GAPS], ids=["synthetic", "resumed", "served", "gaps"])
def test_functions_match_jax(tmp_path, lines):
    path = _write(tmp_path / "trace.jsonl", lines)
    events = load_events(path)
    assert events == jload_events(path)
    assert trace_report.wall_clock_s(events) == jtrace_report.wall_clock_s(events)
    assert trace_report.coverage(events) == jtrace_report.coverage(events)
    assert trace_report.aggregate(events) == jtrace_report.aggregate(events)
    assert trace_report.aggregate(events, wall=3.0) == jtrace_report.aggregate(events, wall=3.0)
    assert trace_report.render(trace_report.aggregate(events)) == jtrace_report.render(jtrace_report.aggregate(events))
    assert trace_report.serving_summary(events) == jtrace_report.serving_summary(events)
    assert to_chrome(events) == jto_chrome(events)


@pytest.mark.parametrize("lines", [SYNTHETIC, RESUMED, SERVED], ids=["synthetic", "resumed", "served"])
def test_cli_prints_the_references_report(tmp_path, capsys, lines):
    path = _write(tmp_path / "trace.jsonl", lines)
    assert jtrace_report.main([str(path), "--chrome", str(tmp_path / "j.json")]) == 0
    want = capsys.readouterr().out.replace("j.json", "OUT")
    assert trace_report.main([str(path), "--chrome", str(tmp_path / "p.json")]) == 0
    assert capsys.readouterr().out.replace("p.json", "OUT") == want
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads((tmp_path / "j.json").read_text())


def test_chrome_export_is_loadable_trace_event_json(tmp_path):
    tracer = Tracer(tmp_path / "trace.jsonl")
    with tracer.span("a"):
        with tracer.span("b"):
            pass
    doc = json.loads(json.dumps(to_chrome(load_events(tmp_path))))
    evs = doc["traceEvents"]
    assert len(evs) == 2 and all(e["ph"] == "X" for e in evs)
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in evs)
    assert evs[0]["name"] == "a" and evs[1]["name"] == "b" and evs[1]["cat"] == "a"


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """Two epochs of the port's ``run_training`` on the tiny Sana backend of
    ``tests/test_torch_trainer.py``, traced."""
    from hyperscalees_t2i_tpu_torch.train import trainer
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from test_torch_trainer import brightness, port_backend

    root = tmp_path_factory.mktemp("traced")
    tc = TrainConfig(num_epochs=2, pop_size=4, sigma=0.05, egg_rank=2, promptnorm=False, prompts_per_gen=2,
                     member_batch=4, run_dir=str(root / "runs"), save_every=2, seed=3, trace=True, run_name="r")
    trainer.run_training(port_backend(), brightness, tc, device="cpu")
    return root / "runs" / "r"


def test_traced_training_run_and_trace_report(traced_run, capsys):
    events = load_events(traced_run)
    names = {e["name"] for e in events}
    assert {"setup", "epoch", "plan", "dispatch", "log", "checkpoint"} <= names
    assert sum(1 for e in events if e["name"] == "epoch") == 2
    assert sum(1 for e in events if e["name"] == "dispatch") == 2
    assert trace_report.coverage(events) >= 0.90
    assert trace_report.aggregate(events) == jtrace_report.aggregate(events)
    assert to_chrome(events) == jto_chrome(events)
    rows = [json.loads(line) for line in (traced_run / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["obs/dispatches"] == 2 and rows[-1]["obs/compiles"] >= 1

    assert trace_report.main([str(traced_run), "--chrome"]) == 0
    out = capsys.readouterr().out
    assert "| phase | count | total s" in out and "| dispatch |" in out and "| epoch |" in out
    cov = float(re.search(r"coverage: +([0-9.]+)% of wall clock", out).group(1))
    assert cov >= 90.0
    chrome = json.loads((traced_run / "trace_chrome.json").read_text())
    assert chrome["traceEvents"] and all(e["ph"] == "X" for e in chrome["traceEvents"])


def test_jax_trace_report_reads_the_ports_run_dir(traced_run, capsys):
    assert jtrace_report.main([str(traced_run)]) == 0
    want = capsys.readouterr().out
    assert trace_report.main([str(traced_run)]) == 0
    got = capsys.readouterr().out
    table = lambda s: [line for line in s.splitlines() if line.startswith("|")]  # noqa: E731
    assert table(got) == table(want) and len(table(got)) > 4
    assert got == want


def test_trace_report_aggregation_math(tmp_path, capsys):
    trace = _write(tmp_path / "trace.jsonl", SYNTHETIC)
    events = load_events(trace)
    assert trace_report.wall_clock_s(events) == 8.0
    assert trace_report.coverage(events) == 1.0
    rows = {r["phase"]: r for r in trace_report.aggregate(events)}
    assert rows["epoch"]["count"] == 2 and rows["epoch"]["total_s"] == 8.0
    d = rows["dispatch"]
    assert d["count"] == 2 and d["total_s"] == 4.0 and d["mean_s"] == 2.0
    assert d["max_s"] == 3.0 and d["p95_s"] == 3.0 and d["pct_wall"] == 50.0
    assert [r["phase"] for r in trace_report.aggregate(events)] == ["epoch", "dispatch"]
    assert trace_report.main([str(trace)]) == 0
    assert "100.0% of wall clock" in capsys.readouterr().out
    assert trace_report.main([str(tmp_path / "nope")]) == 1
    assert trace_report.main([str(_write(tmp_path / "empty.jsonl", []))]) == 1


def test_trace_report_uses_only_latest_session_on_resume(tmp_path, capsys):
    trace = _write(tmp_path / "trace.jsonl", RESUMED)
    assert [e["session"] for e in load_events(trace)] == [0, 1, 1]
    assert trace_report.main([str(trace)]) == 0
    out = capsys.readouterr().out
    assert "1 spans from 1 earlier trace session(s)" in out and "wall clock: 4.000s" in out


def test_p95_nearest_rank():
    assert nearest_rank([float(i) for i in range(1, 21)], 0.95) == 19.0
    assert nearest_rank([1.0], 0.95) == 1.0
    assert nearest_rank([1.0, 2.0], 0.95) == 2.0
    assert nearest_rank([float(i) for i in range(1, 101)], 0.95) == 95.0


def test_trace_report_coverage_with_gaps():
    assert trace_report.wall_clock_s(GAPS) == 4.0
    assert trace_report.coverage(GAPS) == pytest.approx(0.5)


def test_serving_section(tmp_path, capsys):
    path = _write(tmp_path / "trace.jsonl", SERVED)
    s = trace_report.serving_summary(load_events(path))
    assert s["requests"] == 12 and s["latency_p50_s"] == pytest.approx(0.10)
    assert trace_report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "## serving" in out and "12 requests" in out and "queue_wait_mean_s=" in out


@pytest.mark.parametrize("segments", [("trace.1.jsonl",), ("trace.jsonl", "trace.1.jsonl", "trace.2.jsonl")])
def test_per_host_segments_raise_naming_item_7(tmp_path, segments):
    for name in segments:
        _write(tmp_path / name, SYNTHETIC)
    with pytest.raises(NotImplementedError, match="item 7"):
        trace_report.main([str(tmp_path)])
    # not a segment: a Chrome export beside the trace is ignored
    (tmp_path / "trace_chrome.json").write_text("{}")
    assert trace_report.trace_path(tmp_path / "trace.jsonl") == tmp_path / "trace.jsonl"
