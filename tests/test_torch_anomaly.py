"""The port's ES-health anomaly watchdog (``obs/anomaly.py``) against the
JAX package's on the same scripted scalar streams.

Each scenario feeds both watchdogs the same per-epoch scalars (numbers made
with numpy from a seed) and holds, exactly: the events each tick returns
(ALERT and CLEAR, their epochs, values, z, severity, changepoint), the rows
of ``anomalies.jsonl`` (read back with each package's ``load_anomalies``),
the stderr text, the ``anomaly/*`` registry snapshot after every tick and
the ``/healthz`` blackboard's anomaly ring. The arithmetic is host-side
float64 in both (``utils.stats``), so the tolerance is 0; measured
difference 0.
"""

import io

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.obs import exporter as jexporter
from hyperscalees_t2i_tpu.obs.anomaly import AnomalyWatchdog as JWatchdog
from hyperscalees_t2i_tpu.obs.anomaly import load_anomalies as jload_anomalies
from hyperscalees_t2i_tpu_torch.obs import exporter
from hyperscalees_t2i_tpu_torch.obs.anomaly import (ANOMALIES_FILE, DEFAULT_RULES, DEFAULT_SATURATION_RULES,
                                                     AnomalyWatchdog, load_anomalies)

torch.set_num_threads(1)


def _stream(scenario: str, seed: int):
    """Per-epoch scalar dicts of one scenario."""
    rng = np.random.default_rng(seed)
    n = 40
    cos = 0.8 + 0.01 * rng.uniform(-1, 1, n)
    std = 0.5 + 0.02 * rng.uniform(-1, 1, n)
    asym = 0.1 + 0.01 * rng.uniform(-1, 1, n)
    cap = np.ones(n)
    if scenario == "cosine_collapse_and_clear":
        cos[20:26] = 0.0
    elif scenario == "reward_std_collapse":
        std[25:] = 1e-6
    elif scenario == "pair_asym_spike":
        asym[18:22] = 5.0
    elif scenario == "cap_saturation":
        cap[5:] = 0.5
    elif scenario == "everything":
        cos[12:30] = -0.2
        std[30:] = 0.0
        asym[15:17] = 3.0
        cap[8:] = 0.7
    rows = []
    for e in range(n):
        row = {"es/update_cosine": float(cos[e]), "es/reward_std": float(std[e]), "es/pair_asym": float(asym[e]),
               "es/cap_step_scale": float(cap[e]), "es/cap_theta_scale": 1.0, "epoch": e, "prompts": ["x"]}
        if scenario == "missing_and_text" and e % 3 == 0:
            row.pop("es/update_cosine")
            row["es/pair_asym"] = "n/a"
        rows.append(row)
    return rows


SCENARIOS = ["clean", "cosine_collapse_and_clear", "reward_std_collapse", "pair_asym_spike", "cap_saturation",
             "everything", "missing_and_text"]


def _run(cls, run_dir, rows, reset, **kw):
    reset()
    err = io.StringIO()
    wd = cls(run_dir=run_dir, stream=err, **kw)
    events, snaps = [], []
    for e, row in enumerate(rows):
        events.append(wd.observe(e, row))
        snaps.append(wd.registry.snapshot())
    return wd, events, snaps, err.getvalue()


def _strip_clock(rows):
    return [{k: v for k, v in r.items() if k != "wall_time"} for r in rows]


@pytest.mark.parametrize("kw", [{}, dict(window=8, min_history=4, z_thresh=4.0), dict(consecutive=1, clear_after=1)],
                         ids=["defaults", "short_window", "no_confirmation"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_watchdog_fires_and_clears_as_jax(tmp_path, scenario, kw):
    rows = _stream(scenario, seed=SCENARIOS.index(scenario))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jwd, jevents, jsnaps, jerr = _run(JWatchdog, tmp_path / "jax", rows, jexporter.reset_health, **kw)
    jhealth = jexporter.health_snapshot().get("anomalies", [])
    wd, events, snaps, err = _run(AnomalyWatchdog, tmp_path / "port", rows, exporter.reset_health, **kw)
    health = exporter.health_snapshot().get("anomalies", [])
    assert events == jevents
    assert snaps == jsnaps
    assert err == jerr
    assert wd.active.keys() == jwd.active.keys()
    assert _strip_clock(load_anomalies(tmp_path / "port")) == _strip_clock(jload_anomalies(tmp_path / "jax"))
    assert _strip_clock(health) == _strip_clock(jhealth)
    fired = [e for tick in events for e in tick]
    assert (tmp_path / "port" / ANOMALIES_FILE).exists() == bool(fired)
    if scenario == "cosine_collapse_and_clear" and not kw:
        assert [e["state"] for e in fired] == ["ALERT", "CLEAR"]
    if scenario == "clean":
        assert fired == []


def test_rules_are_the_jax_rules():
    from hyperscalees_t2i_tpu.obs.anomaly import DEFAULT_RULES as JRULES
    from hyperscalees_t2i_tpu.obs.anomaly import DEFAULT_SATURATION_RULES as JSAT

    assert [vars(r) for r in DEFAULT_RULES] == [vars(r) for r in JRULES]
    assert [vars(r) for r in DEFAULT_SATURATION_RULES] == [vars(r) for r in JSAT]


def test_load_anomalies_of_a_missing_or_torn_file(tmp_path):
    assert load_anomalies(tmp_path) == [] == jload_anomalies(tmp_path)
    (tmp_path / ANOMALIES_FILE).write_text('{"kind": "a", "state": "ALERT"}\nnot json\n{"kind": "b"')
    assert load_anomalies(tmp_path) == jload_anomalies(tmp_path) == [{"kind": "a", "state": "ALERT"}]


def test_no_run_dir_writes_no_file_but_keeps_gauges(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = _stream("cosine_collapse_and_clear", seed=1)
    wd, events, snaps, err = _run(AnomalyWatchdog, None, rows, exporter.reset_health)
    assert any(events) and "[anomaly] ALERT" in err
    assert snaps[-1]["anomaly/alerts"] == 1
    assert list(tmp_path.iterdir()) == []
