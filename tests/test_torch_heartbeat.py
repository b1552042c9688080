"""The port's phase heartbeats and stall watchdog (``obs/heartbeat.py``)
against the JAX package's.

- ``emit_heartbeat`` prints the JAX line byte for byte (the same JSON
  object, one line, on the given stream, never stdout) and mirrors it onto
  the ``/healthz`` blackboard as the JAX one does.
- ``Heartbeat`` prints lines with the JAX keys while a phase runs, fires
  the stall callback once past the cap (the line gains ``stalled`` and the
  stall payload, ``/healthz`` reads ``stalled`` until the phase ends),
  survives a broken callback or gauge, and ``maybe_heartbeat`` is a no-op
  at interval 0. The thread's timing is the wall clock: the tests hold
  keys, counts and order, not the ``elapsed_s`` values.
- ``device_memory_gauges`` is ``{}`` on the CPU without calling anything of
  ``torch.cuda`` that reads the card (each such function is replaced by one
  that fails the test), and for a CPU device; the SLO evaluator's alert
  line now comes through this module.
"""

import io
import json
import threading
import time

import pytest
import torch

from hyperscalees_t2i_tpu.obs import exporter as jexporter
from hyperscalees_t2i_tpu.obs.heartbeat import Heartbeat as JHeartbeat
from hyperscalees_t2i_tpu.obs.heartbeat import emit_heartbeat as jemit
from hyperscalees_t2i_tpu_torch.obs import exporter
from hyperscalees_t2i_tpu_torch.obs.heartbeat import Heartbeat, device_memory_gauges, emit_heartbeat, maybe_heartbeat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_blackboards():
    exporter.reset_health()
    jexporter.reset_health()
    yield
    exporter.reset_health()
    jexporter.reset_health()


def _clockless(d):
    return {k: v for k, v in d.items() if k != "wall_time"}


@pytest.mark.parametrize("extra", [{}, dict(elapsed_s=12.5, bytes_in_use=7), dict(consecutive=3, path=None),
                                   dict(stalled=True, stall_action="checkpoint_exit", obj=object)],
                         ids=["bare", "gauges", "degenerate", "stalled"])
def test_emit_heartbeat_line_is_the_jax_line(extra, capsys):
    ours, theirs = io.StringIO(), io.StringIO()
    emit_heartbeat("train", "dispatch", stream=ours, **extra)
    jemit("train", "dispatch", stream=theirs, **extra)
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().count("\n") == 1
    assert json.loads(ours.getvalue())["process_index"] == 0
    assert _clockless(exporter.health_snapshot()["last_heartbeat"]) == \
        _clockless(jexporter.health_snapshot()["last_heartbeat"])
    assert ("last_stall" in exporter.health_snapshot()) == bool(extra.get("stalled"))
    assert capsys.readouterr().out == ""  # never stdout


def test_emit_heartbeat_defaults_to_stderr(capsys):
    emit_heartbeat("anomaly", "alert", kind="x")
    jemit("anomaly", "alert", kind="x")
    captured = capsys.readouterr()
    assert captured.out == ""
    lines = captured.err.splitlines()
    assert len(lines) == 2 and lines[0] == lines[1]


def _beat(cls, **kw):
    stream, fired = io.StringIO(), []
    with cls("train", "compile", interval_s=0.02, stream=stream, gauges=None,
             on_stall=lambda n, p, e: fired.append((n, p)), **kw) as hb:
        time.sleep(0.4)
        stalled_inside = hb.stalled
    return [json.loads(line) for line in stream.getvalue().splitlines()], fired, stalled_inside


@pytest.mark.parametrize("stall_cap_s", [0.0, 0.08], ids=["no_cap", "cap"])
def test_heartbeat_lines_and_stall_as_jax(stall_cap_s):
    payload = {"stall_action": "checkpoint_exit"}
    lines, fired, stalled = _beat(Heartbeat, stall_cap_s=stall_cap_s, stall_payload=payload)
    jlines, jfired, jstalled = _beat(JHeartbeat, stall_cap_s=stall_cap_s, stall_payload=payload)
    assert len(lines) >= 3 and len(jlines) >= 3
    assert {frozenset(ln) for ln in lines} == {frozenset(ln) for ln in jlines}
    assert all(ln["hb"] == "train" and ln["phase"] == "compile" for ln in lines)
    assert fired == jfired == ([("train", "compile")] if stall_cap_s else [])
    assert stalled == jstalled == bool(stall_cap_s)
    stalled_lines = [ln for ln in lines if ln.get("stalled")]
    assert len(stalled_lines) == (1 if stall_cap_s else 0)
    if stall_cap_s:
        assert stalled_lines[0]["stall_action"] == "checkpoint_exit"
        assert stalled_lines[0]["elapsed_s"] >= stall_cap_s - 0.05
        # the phase ended: /healthz is no longer stalled, the stall is kept
        assert exporter.health_snapshot()["stall_active"] is False
        assert exporter.health_snapshot()["last_stall"]["phase"] == "compile"


def test_stall_flags_healthz_while_the_phase_runs():
    exp = exporter.MetricsExporter(0)
    with Heartbeat("train", "dispatch", interval_s=5.0, stall_cap_s=0.05, gauges=None, stream=io.StringIO()):
        time.sleep(0.3)
        assert exp.healthz()["status"] == "stalled"
    assert exp.healthz()["status"] == "ok"


def test_broken_callback_and_gauges_keep_the_heartbeat():
    stream = io.StringIO()

    def boom(*a):
        raise RuntimeError("broken")

    with Heartbeat("train", "checkpoint", interval_s=0.02, stall_cap_s=0.03, on_stall=boom, gauges=boom,
                   stream=stream):
        time.sleep(0.3)
    lines = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert len(lines) >= 3 and sum(bool(ln.get("stalled")) for ln in lines) == 1


def test_maybe_heartbeat_is_a_no_op_at_interval_zero():
    before = threading.active_count()
    with maybe_heartbeat("train", "dispatch", 0.0, stall_cap_s=1.0) as hb:
        assert hb is None and threading.active_count() == before
    assert isinstance(maybe_heartbeat("train", "dispatch", 1.0), Heartbeat)


def test_device_memory_gauges_on_the_cpu_read_nothing_of_the_card(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("a heartbeat must not touch the card here")

    for name in ("memory_allocated", "max_memory_allocated", "memory_stats", "mem_get_info", "synchronize",
                 "current_device", "init", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    assert not torch.cuda.is_initialized()
    assert device_memory_gauges() == {}
    assert device_memory_gauges("cpu") == {} and device_memory_gauges(torch.device("cpu")) == {}
    assert device_memory_gauges(0) == {} and device_memory_gauges("cuda") == {}
    assert not torch.cuda.is_initialized()
    # the default gauges of a heartbeat on the CPU: no memory keys
    stream = io.StringIO()
    with Heartbeat("train", "compile", interval_s=0.02, stream=stream):
        time.sleep(0.15)
    lines = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert lines and all(set(ln) == {"hb", "phase", "process_index", "elapsed_s"} for ln in lines)


def test_slo_alerts_come_through_the_heartbeat_path():
    from hyperscalees_t2i_tpu_torch.obs.metrics import MetricsRegistry
    from hyperscalees_t2i_tpu_torch.obs.slo import build_trainer_evaluator

    reg, res = MetricsRegistry(), MetricsRegistry(prefix="resilience/")
    now = [0.0]
    stream = io.StringIO()
    ev = build_trainer_evaluator("latency_p95=1ms", reg, res, clock=lambda: now[0], stream=stream)
    for _ in range(30):
        reg.observe("train_step_time_seconds", 1.0)
        now[0] += 10.0
        ev.tick()
    lines = [ln for ln in stream.getvalue().splitlines() if ln.startswith("{")]
    assert any(json.loads(ln)["phase"] == "burn_alert" for ln in lines)
    assert exporter.health_snapshot()["last_heartbeat"]["hb"] == "slo"
