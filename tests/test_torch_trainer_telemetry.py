"""The port's ``run_training`` live telemetry against the JAX package's.

- The anomaly watchdog is on by default in both packages. One tiny run of
  each (the Sana backend of ``tests/test_trainer.py``, every weight and
  draw from the seed, nothing injected; 10 epochs with the θ cap engaged so
  ``cap_theta_saturation`` fires; the anomaly settings at their defaults),
  with the exporter (a free port on 127.0.0.1), SLOs and heartbeats on:
  both run dirs hold ``anomalies.jsonl`` with the same events (kind,
  metric, epoch, state, severity, window, changepoint; value and baseline
  within 3e-4, measured 0 on the engaged cap), and each watchdog ticked
  once per logged dispatch (its ``observe`` counted). The ``anomaly/*``
  gauges of every row agree within 3e-4; the ``slo/*`` names agree (their
  values read wall-clock step times). ``/metrics`` and ``/healthz`` are
  scraped from ``on_epoch_end`` while each run is live: the same
  ``/healthz`` keys with the same ``topology`` and ``membership``, and the
  port's ``/metrics`` holds the run's counters, its phase and step
  histograms, the last row's ``es_*`` numbers and the SLO and anomaly
  gauges. Heartbeat lines carry the JAX keys; the port also beats around
  its checkpoints.
- Port-only: the stall watchdog (``warn`` counts ``stalls`` and says so on
  stderr; ``checkpoint_exit`` saves at the next boundary and ends the run
  as preempted, and the resume runs on), ``anomaly_detect=False`` writes
  no file and no gauges, the telemetry settings are no longer refused, and
  the CLI's telemetry flags parse to the JAX CLI's values.
"""

import json
import socket
import urllib.request

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.obs import anomaly as janomaly
from hyperscalees_t2i_tpu.train.cli import build_parser as jbuild_parser
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import run_training as jrun_training
from hyperscalees_t2i_tpu_torch.obs import anomaly
from hyperscalees_t2i_tpu_torch.obs.exporter import parse_prometheus_text
from hyperscalees_t2i_tpu_torch.train import cli, trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig, unported_settings
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows

from test_torch_trainer import _jax_backend, brightness, jax_brightness, port_backend

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
EPOCHS = 10
# the θ cap below θ₀'s norm: cap_theta_scale < 1 every epoch, so the default
# watchdog (8 epochs of history, 2 confirming ticks) fires on saturation
RUN = dict(num_epochs=EPOCHS, pop_size=4, sigma=0.05, lr_scale=1.0, egg_rank=2, prompts_per_gen=2, member_batch=2,
           theta_max_norm=5.0, save_every=5, seed=3, run_name="telemetry", metrics_host="127.0.0.1",
           slo="latency_p95=30s,availability=99", heartbeat_interval_s=0.05)
EVENT_KEYS = ("phase", "kind", "metric", "epoch", "state", "severity", "window", "changepoint_index")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def _run_with_scrapes(run, watchdog_cls, tc, scrape_epoch=8):
    """``run(tc, on_epoch_end)`` with the watchdog's ticks counted and
    ``/metrics`` + ``/healthz`` scraped at the end of ``scrape_epoch``."""
    ticks, scraped = [], {}
    observe = watchdog_cls.observe

    def counting(self, epoch, scalars):
        ticks.append(epoch)
        return observe(self, epoch, scalars)

    def on_epoch_end(epoch, scalars):
        if epoch == scrape_epoch:
            scraped["metrics"] = _get(tc.metrics_port, "/metrics")
            scraped["healthz"] = json.loads(_get(tc.metrics_port, "/healthz"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(watchdog_cls, "observe", counting)
        run(tc, on_epoch_end)
    return ticks, scraped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("telemetry")
    out = {}
    jtc = JTrainConfig(run_dir=str(root / "jax"), metrics_port=_free_port(), **RUN)
    jb = _jax_backend(root)
    out["jax"] = _run_with_scrapes(lambda tc, cb: jrun_training(jb, jax_brightness, tc, on_epoch_end=cb),
                                   janomaly.AnomalyWatchdog, jtc)
    tc = TrainConfig(run_dir=str(root / "port"), metrics_port=_free_port(), **RUN)
    out["port"] = _run_with_scrapes(
        lambda tc, cb: trainer.run_training(port_backend(), brightness, tc, on_epoch_end=cb, device="cpu"),
        anomaly.AnomalyWatchdog, tc)
    for side in ("jax", "port"):
        run_dir = root / side / "telemetry"
        out[side] += (read_jsonl_rows(run_dir / "metrics.jsonl"), run_dir)
    return out


def test_anomaly_watchdog_runs_by_default_as_in_jax(runs):
    """The repair: the default ``anomaly_detect`` writes the file and ticks
    once per logged dispatch, in both packages."""
    assert TrainConfig().anomaly_detect and JTrainConfig().anomaly_detect
    for side in ("jax", "port"):
        ticks, _, rows, run_dir = runs[side]
        assert len(rows) == EPOCHS and ticks == [r["epoch"] for r in rows] == list(range(EPOCHS)), side
        assert (run_dir / "anomalies.jsonl").exists(), side
    jev = janomaly.load_anomalies(runs["jax"][3])
    ev = anomaly.load_anomalies(runs["port"][3])
    assert [e["kind"] for e in ev] == ["cap_theta_saturation"]
    assert [{k: e.get(k) for k in EVENT_KEYS} for e in ev] == [{k: e.get(k) for k in EVENT_KEYS} for e in jev]
    for a, b in zip(ev, jev):
        np.testing.assert_allclose([a["value"], a["baseline"], a["z"]], [b["value"], b["baseline"], b["z"]], **TOL)


def test_anomaly_and_slo_gauges_in_every_row_match_jax(runs):
    jrows, rows = runs["jax"][2], runs["port"][2]
    for jr, r in zip(jrows, rows):
        jan = {k: v for k, v in jr.items() if k.startswith("anomaly/")}
        an = {k: v for k, v in r.items() if k.startswith("anomaly/")}
        assert an.keys() == jan.keys(), r["epoch"]
        for k in an:
            np.testing.assert_allclose(an[k], jan[k], err_msg=k, **TOL)
        assert {k for k in r if k.startswith("slo/")} == {k for k in jr if k.startswith("slo/")}
    assert any(k.startswith("anomaly/") for k in rows[-1]) and any(k.startswith("slo/") for k in rows[-1])
    assert rows[-1]["anomaly/alerts"] == 1 and rows[-1]["anomaly/cap_theta_saturation_active"] == 1


def test_healthz_scraped_during_the_run_matches_jax(runs):
    jh, h = runs["jax"][1]["healthz"], runs["port"][1]["healthz"]
    shared = {"backend", "run_dir", "topology", "membership", "resilience", "queue", "status",
              "last_completed_epoch", "process_index"}
    assert shared <= set(h) and shared <= set(jh)
    assert set(h) - {"last_heartbeat", "anomalies", "slo_alerts", "stall_active", "last_stall"} <= set(jh)
    assert h["topology"] == jh["topology"] and h["membership"] == jh["membership"]
    assert h["membership"] == {"incarnation": "i0.n1", "live_ranks": [0], "transitions": []}
    assert h["queue"] is None and h["status"] == "ok" and h["last_completed_epoch"] == 8
    assert h["resilience"]["process_index"] == 0 and "resilience/last_good_epoch" in h["resilience"]
    assert h["run_dir"].endswith("port/telemetry") and h["backend"] == jh["backend"]


def test_metrics_scraped_during_the_run(runs):
    families = parse_prometheus_text(runs["port"][1]["metrics"])
    jfamilies = parse_prometheus_text(runs["jax"][1]["metrics"])
    for name in ("obs_dispatches", "obs_epochs_dispatched", "es_update_cosine", "opt_score_mean",
                 "train_step_time_seconds_count", "phase_dispatch_seconds_count", "phase_compile_seconds_count",
                 "resilience_last_good_epoch"):
        assert name in families, name
    assert families["obs_dispatches"] == [({}, 9.0)]
    assert families["opt_score_mean"][0][1] == pytest.approx(runs["port"][2][8]["opt_score_mean"])
    assert families["anomaly_alerts"] == [({}, 1.0)]
    assert any(n.startswith("slo_") for n in families) and any(n.startswith("anomaly_") for n in families)
    shared = {n for n in jfamilies if n.startswith(("es_", "reward_", "slo_", "anomaly_"))}
    assert shared <= set(families)


def test_heartbeats_of_the_run(tmp_path, capfd):
    state, _ = _port_run(tmp_path, heartbeat_interval_s=0.001, save_every=1, num_epochs=2)
    lines = [json.loads(ln) for ln in capfd.readouterr().err.splitlines() if ln.startswith('{"hb"')]
    phases = {ln["phase"] for ln in lines if ln["hb"] == "train"}
    assert {"compile", "dispatch", "checkpoint"} <= phases
    assert all({"hb", "phase", "process_index", "elapsed_s"} <= set(ln) for ln in lines if ln["hb"] == "train")


def _port_run(tmp_path, **kw):
    base = dict(num_epochs=3, pop_size=4, sigma=0.05, egg_rank=2, prompts_per_gen=2, member_batch=4,
                run_dir=str(tmp_path / "runs"), save_every=1, run_name="r", seed=5)
    history = []
    state = trainer.run_training(port_backend(), brightness, TrainConfig(**{**base, **kw}),
                                 on_epoch_end=lambda e, s: history.append(s), device="cpu")
    return state, history


def test_stall_warn_counts_and_says_so(tmp_path, capfd):
    state, history = _port_run(tmp_path, heartbeat_interval_s=0.001, stall_cap_s=1e-4)
    err = capfd.readouterr().err
    assert not state.preempted and state.epoch == 3
    assert history[-1]["obs/stalls"] >= 1 and "[obs] WATCHDOG: train/" in err
    assert any(json.loads(ln).get("stalled") for ln in err.splitlines() if ln.startswith('{"hb"'))


def test_stall_checkpoint_exit_saves_and_ends_as_preempted(tmp_path, capfd):
    state, history = _port_run(tmp_path, num_epochs=4, save_every=0, heartbeat_interval_s=0.001,
                               stall_cap_s=1e-4, stall_action="checkpoint_exit")
    assert state.preempted and state.epoch == 1 and len(history) == 1
    marker = json.loads((tmp_path / "runs/r/preempted.json").read_text())
    assert marker["epoch"] == 1 and "stall escalation" in marker["reason"]
    assert (tmp_path / "runs/r/ckpt/step_00000001").is_dir()
    state, history = _port_run(tmp_path, num_epochs=4, save_every=0)  # the resume runs on, unwatched
    assert not state.preempted and state.epoch == 4 and [h["epoch"] for h in history] == [1, 2, 3]


def test_anomaly_detect_off_writes_nothing(tmp_path):
    state, history = _port_run(tmp_path, anomaly_detect=False, anomaly_min_epochs=1, theta_max_norm=1.0,
                               num_epochs=5)
    assert not (tmp_path / "runs/r/anomalies.jsonl").exists()
    assert not any(k.startswith("anomaly/") for h in history for k in h)


@pytest.mark.parametrize("field, value", [("metrics_port", 0), ("slo", "latency_p95=2s"),
                                          ("heartbeat_interval_s", 5.0), ("stall_cap_s", 30.0),
                                          ("stall_action", "checkpoint_exit"), ("metrics_linger_s", 0.5)])
def test_telemetry_settings_are_accepted(field, value):
    assert unported_settings(TrainConfig(**{field: value})) == []


def test_cli_telemetry_flags_parse_as_jax():
    flags = ["--metrics_port", "--metrics_host", "--slo", "--heartbeat_interval_s", "--stall_cap_s",
             "--stall_action", "--anomaly_detect", "--anomaly_window", "--anomaly_min_epochs", "--anomaly_z",
             "--metrics_linger_s"]
    ours = {a.dest: a for a in cli.build_parser()._actions}
    theirs = {a.dest: a for a in jbuild_parser()._actions}
    for f in flags:
        d = f[2:]
        assert ours[d].default == theirs[d].default and ours[d].choices == theirs[d].choices, d
        assert ours[d].option_strings == theirs[d].option_strings, d
    argv = ["--backend", "sana_one_step", "--metrics_port", "9101", "--metrics_host", "127.0.0.1", "--slo",
            "latency_p95=2s", "--heartbeat_interval_s", "5", "--stall_cap_s", "60", "--stall_action",
            "checkpoint_exit", "--anomaly_detect", "false", "--anomaly_window", "16", "--anomaly_min_epochs", "4",
            "--anomaly_z", "6", "--metrics_linger_s", "1.5"]
    a, b = vars(cli.build_parser().parse_args(argv)), vars(jbuild_parser().parse_args(argv))
    assert all(a[f[2:]] == b[f[2:]] for f in flags)
    tc = cli.train_config(cli.build_parser().parse_args(argv))
    assert (tc.metrics_port, tc.metrics_host, tc.slo, tc.heartbeat_interval_s, tc.stall_cap_s, tc.stall_action,
            tc.anomaly_detect, tc.anomaly_window, tc.anomaly_min_epochs, tc.anomaly_z, tc.metrics_linger_s) == (
        9101, "127.0.0.1", "latency_p95=2s", 5.0, 60.0, "checkpoint_exit", False, 16, 4, 6.0, 1.5)
    assert unported_settings(tc) == []
