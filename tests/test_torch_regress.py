"""``obs/regress.py`` and ``utils/stats.py`` of the port against the JAX
package's on the same fixture files.

Every fixture is a file the test writes in the on-disk shapes of a run dir
(``metrics.jsonl``, ``programs.jsonl``) or of an artifact (``BENCH_*``,
``CAPACITY_*``, ``DEGRADE_*``, ``CALIB_*``, ``WINDOW_r*``, ``QUALITY_*``,
``FLEET_*``). Held exactly: the observations (metric, key, value, source,
device), the baselines (center, MAD, n, device), the verdicts' bounds,
breaches and skips. Left aside: the version stamp (``jax_version`` against
``torch_version``) and what hangs on the StableHLO sha, which the port's
ledger does not carry (``sha_changes``, and the reference's rule that a
matching sha gates under another jax: no counterpart).

Ported from ``tests/test_sentry.py`` (the module-level cases; the CLI cases
are in ``tests/test_torch_sentry.py``): the robust-statistics helpers, the
SLO burn on the shared window math, every ingest shape, baselines, the
incarnation fold, calibration and chip keying, the manifest's device round
trip. Not ported: ``test_matching_sha_gates_even_under_different_jax`` (no
sha in the port's ledger).
"""

import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from hyperscalees_t2i_tpu.obs import regress as jregress
from hyperscalees_t2i_tpu.utils import stats as jstats
from hyperscalees_t2i_tpu_torch.obs import regress
from hyperscalees_t2i_tpu_torch.utils import stats

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# fixtures: files in the real on-disk shapes
# ---------------------------------------------------------------------------

def make_run(root: Path, name: str, *, step=0.10, bytes_=6.5e9, flops=1.5e11, peak=1.0e9, reward0=0.10, epochs=10,
             chip=None) -> Path:
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    with (d / "metrics.jsonl").open("w") as f:
        for e in range(epochs):
            f.write(json.dumps({"ts": 0.0, "epoch": e, "step_time_s": step, "opt_score_mean": reward0 + 0.01 * e})
                    + "\n")
    rec = {"site": "train", "label": "es_step_m2r1", "flops": flops, "bytes_accessed": bytes_, "peak_bytes": peak,
           "compile_s": 20.0}
    if chip:
        rec["device_kind"] = chip
    (d / "programs.jsonl").write_text(json.dumps(rec) + "\n")
    return d


def make_elastic_run(root: Path, name: str, *, step=0.10) -> Path:
    """Two incarnation segments: epochs 0-3, then a resume from the epoch-2
    slot replaying 2-5, each with a fresh ``obs/compiles`` counter."""
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    with (d / "metrics.jsonl").open("w") as f:
        for e in range(4):
            f.write(json.dumps({"epoch": e, "incarnation": 0, "step_time_s": 30.0 if e == 0 else step,
                                "opt_score_mean": 0.10 + 0.01 * e, "obs/compiles": 2}) + "\n")
        for e in range(2, 6):
            f.write(json.dumps({"epoch": e, "incarnation": 2, "step_time_s": 30.0 if e == 2 else step,
                                "opt_score_mean": 0.10 + 0.01 * e, "obs/compiles": 1}) + "\n")
    return d


def make_calib_artifact(path: Path, *, measured=0.004, predicted=0.002, chip="NVIDIA H100 80GB HBM3") -> Path:
    path.write_text(json.dumps({
        "mode": "calib", "schema_version": 1, "chip_kind": chip,
        "rows": [{"key": "train/es_step_m4r1", "site": "train", "label": "es_step_m4r1", "chip_kind": chip,
                  "measured_s": measured, "measured_source": "profile", "predicted_s": predicted,
                  "error_ratio": measured / predicted}],
        "headline": {"rows": 1, "device_rows": 1, "max_error_ratio": measured / predicted,
                     "median_error_ratio": measured / predicted}}))
    return path


def write_artifacts(root: Path) -> dict:
    """One file of every ``*.json`` schema the sentry reads, keyed by kind."""
    root.mkdir(parents=True, exist_ok=True)
    rungs = {"tiny": {"step_time_s": 0.06, "compile_s": 30.0, "step_tflops": 0.5, "bytes_accessed": 1e9,
                      "peak_bytes_est": 2e9, "device_kind": "NVIDIA H100 80GB HBM3"}}
    files = {
        "bench_raw": ("BENCH_raw.json", {"rungs": rungs}),
        "bench_wrapped": ("BENCH_wrapped.json", {"rc": 0, "parsed": {"rungs": rungs}}),
        "capacity": ("CAPACITY_r01.json", {"mode": "capacity", "rung": "tiny", "capacity_rps": 12.5,
                                           "goodput_rps": 11.0, "knee_p99_s": 1.7}),
        "capacity_wrapped": ("CAPACITY_r02.json", {"parsed": {"mode": "capacity", "rung": "small",
                                                              "capacity_rps": 3.0, "goodput_rps": 2.5}}),
        "degrade": ("DEGRADE_r01.json", {"mode": "degrade", "rung": "tiny", "goodput_retention": 0.8}),
        "quality": ("QUALITY_train.json", {"mode": "quality", "final_reward": -0.25, "auc_over_images": 0.125,
                                           "images_to_threshold": 48, "chip_kind": "cpu"}),
        "fleet": ("FLEET_r01.json", {"mode": "fleet", "rung": "tiny", "device_kind": "NVIDIA H100 80GB HBM3",
                                     "widths": [{"width": 2, "fused_imgs_per_sec_chip": 9.5, "bytes_per_job": 3e8},
                                                {"width": 4, "fused_imgs_per_sec_chip": 17.0}]}),
    }
    out = {}
    for kind, (name, doc) in files.items():
        (root / name).write_text(json.dumps(doc))
        out[kind] = root / name
    cal = make_calib_artifact(root / "CALIB_r01.json")
    out["calib"] = cal
    w = root / "WINDOW_r01.json"
    w.write_text(json.dumps({"mode": "window", "schema_version": 1, "items": [], "calib": json.loads(cal.read_text())}))
    out["window"] = w
    empty = root / "WINDOW_r02.json"
    empty.write_text(json.dumps({"mode": "window", "calib": None}))
    out["window_empty"] = empty
    return out


def obs_tuples(obs):
    return sorted((o.metric, o.key, o.value, o.source, o.chip) for o in obs)


def base_tuples(bs):
    return [(b.metric, b.key, b.center, b.mad, b.n, b.chip) for b in bs]


def verdict_core(v):
    return {k: v[k] for k in ("schema", "pass", "checked", "breaches", "skipped")}


# ---------------------------------------------------------------------------
# utils/stats (the helpers the tools rely on)
# ---------------------------------------------------------------------------

SAMPLES = [[3, 1, 2], [4, 1, 2, 3], [1, 2, 3, 4, 100], [0.1, 0.11, 0.5], [2.5], list(range(17))]


@pytest.mark.parametrize("xs", SAMPLES)
def test_stats_match_jax(xs):
    assert stats.median(xs) == jstats.median(xs)
    assert stats.mad(xs) == jstats.mad(xs)
    assert stats.percentiles(xs) == jstats.percentiles(xs)
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert stats.nearest_rank(xs, q) == jstats.nearest_rank(xs, q)


def test_median_and_mad():
    assert stats.median([3, 1, 2]) == 2
    assert stats.median([4, 1, 2, 3]) == 2.5
    assert stats.mad([1, 2, 3, 4, 100]) == 1
    with pytest.raises(ValueError):
        stats.median([])


def test_robust_z():
    xs = [1.0, 1.1, 0.9, 1.05, 0.95]
    assert abs(stats.robust_z(1.0, xs)) < 1.0
    assert stats.robust_z(10.0, xs) > 8.0
    assert math.isinf(stats.robust_z(2.0, [1.0] * 5))
    assert stats.robust_z(2.0, [1.0] * 5, min_scale=0.05) == pytest.approx(20.0)
    assert stats.robust_z(1.0, [1.0] * 5) == 0.0
    assert stats.robust_z(5.0, []) == 0.0


def test_changepoint_split_recovers_shift_index():
    idx, score = stats.changepoint_split([1.0] * 10 + [0.0] * 5)
    assert idx == 10 and score > 50
    idx, _ = stats.changepoint_split([1, 1, 1, 9, 1, 1, 5, 5, 5, 5])
    assert idx == 6
    assert stats.changepoint_split([1, 2, 1, 2]) == (None, 0.0)
    assert stats.changepoint_split([1.0] * 12)[0] is None
    for xs in ([1.0] * 10 + [0.0] * 5, [1, 1, 1, 9, 1, 1, 5, 5, 5, 5], [1, 2, 1, 2]):
        assert stats.changepoint_split(xs) == jstats.changepoint_split(xs)


def test_window_anchor_index_matches_slo_semantics():
    ts = [1.0, 2.0, 3.0, 4.0]
    assert stats.window_anchor_index(ts, 2.5) == 1
    assert stats.window_anchor_index(ts, 0.0) == 0
    assert stats.window_anchor_index(ts, 9.0) == 3


def test_slo_still_burns_with_shared_window_math():
    from hyperscalees_t2i_tpu_torch.obs.slo import SloEvaluator, parse_slos

    clock = {"t": 0.0}
    bad = {"n": 0.0, "total": 0.0}
    with open("/dev/null", "w") as sink:
        ev = SloEvaluator(parse_slos("availability=99.9"), {"availability": lambda: (bad["n"], bad["total"])},
                          clock=lambda: clock["t"], stream=sink)
        for i in range(100):
            clock["t"] += 60.0
            bad["total"] += 10
            if i > 50:
                bad["n"] += 5
            ev.tick()
    assert ev.alerting["availability"]
    assert ev.registry.value("availability_burn_fast") > 14.4


# ---------------------------------------------------------------------------
# ingest: the same observations as the JAX module, source by source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bench_raw", "bench_wrapped", "capacity", "capacity_wrapped", "degrade", "quality",
                                  "fleet", "calib", "window", "window_empty"])
def test_ingest_artifact_matches_jax(tmp_path, kind):
    path = write_artifacts(tmp_path)[kind]
    got = regress.ingest(path)
    assert obs_tuples(got) == obs_tuples(jregress.ingest(path))
    assert bool(got) == (kind != "window_empty")


@pytest.mark.parametrize("make", ["plain", "elastic", "chip", "artifacts"])
def test_ingest_run_dir_matches_jax(tmp_path, make):
    if make == "plain":
        d = make_run(tmp_path, "r")
    elif make == "elastic":
        d = make_elastic_run(tmp_path, "r")
    elif make == "chip":
        d = make_run(tmp_path, "r", chip="NVIDIA H100 80GB HBM3")
    else:
        d = make_run(tmp_path, "r")
        arts = write_artifacts(d)
        for k in ("bench_raw", "bench_wrapped", "window", "window_empty", "capacity_wrapped"):
            arts[k].unlink()
    assert obs_tuples(regress.ingest(d)) == obs_tuples(jregress.ingest(d))
    ledger = d / "programs.jsonl"
    assert obs_tuples(regress.ingest(ledger)) == obs_tuples(jregress.ingest(ledger))


def test_ingest_run_dir_shapes(tmp_path):
    obs = {(o.metric, o.key): o for o in regress.ingest(make_run(tmp_path, "a"))}
    assert obs[("step_time_s", "run")].value == pytest.approx(0.10)
    assert obs[("epochs_logged", "run")].value == 10
    assert obs[("bytes_accessed", "train/es_step_m2r1")].value == 6.5e9
    assert ("reward_window", "w0") in obs and ("reward_window", "w1") in obs


def test_ingest_refuses_unknown_shape(tmp_path):
    with pytest.raises(ValueError):
        regress.ingest(tmp_path / "nope.txt")


def test_ingest_bench_artifact_raw_and_wrapped(tmp_path):
    arts = write_artifacts(tmp_path)
    for p in (arts["bench_raw"], arts["bench_wrapped"]):
        obs = {(o.metric, o.key): o for o in regress.ingest(p)}
        assert obs[("step_time_s", "bench/tiny")].value == 0.06
        assert obs[("flops", "bench/tiny")].value == 0.5e12


def test_ingest_steady_state_excludes_compile_epochs(tmp_path):
    d = tmp_path / "r"
    d.mkdir()
    with (d / "metrics.jsonl").open("w") as f:
        f.write(json.dumps({"epoch": 0, "step_time_s": 20.0, "obs/compiles": 1}) + "\n")
        for e in (1, 2, 3):
            f.write(json.dumps({"epoch": e, "step_time_s": 0.026, "obs/compiles": 1}) + "\n")
    obs = {(o.metric, o.key): o for o in regress.ingest_metrics(d / "metrics.jsonl")}
    assert obs[("step_time_s", "run")].value == pytest.approx(0.026)
    assert obs_tuples(regress.ingest_metrics(d / "metrics.jsonl")) == \
        obs_tuples(jregress.ingest_metrics(d / "metrics.jsonl"))


def test_ingest_folds_incarnation_segments(tmp_path):
    obs = {(o.metric, o.key): o for o in regress.ingest(make_elastic_run(tmp_path, "el"))}
    assert obs[("epochs_logged", "run")].value == 6
    assert obs[("step_time_s", "run")].value == pytest.approx(0.10)
    assert obs[("reward_window", "w0")].value == pytest.approx(sum(0.10 + 0.01 * e for e in range(5)) / 5)


def test_ingest_calib_artifact(tmp_path):
    obs = {(o.metric, o.key): o for o in regress.ingest(make_calib_artifact(tmp_path / "CALIB_r01.json"))}
    m = obs[("calib_measured_s", "calib/train/es_step_m4r1")]
    assert m.value == pytest.approx(0.004) and m.chip == "NVIDIA H100 80GB HBM3"
    assert obs[("calib_error_ratio", "calib/train/es_step_m4r1")].value == pytest.approx(2.0)


def test_ingest_window_rollup_delegates_to_embedded_calib(tmp_path):
    arts = write_artifacts(tmp_path)
    obs = {(o.metric, o.key): o for o in regress.ingest(arts["window"])}
    assert obs[("calib_measured_s", "calib/train/es_step_m4r1")].chip == "NVIDIA H100 80GB HBM3"
    assert regress.ingest(arts["window_empty"]) == []


def test_bench_and_ledger_chip_stamping_and_baseline_agreement(tmp_path):
    led = tmp_path / "programs.jsonl"
    led.write_text(json.dumps({"site": "train", "label": "es_step_m2r1", "compile_s": 20.0,
                               "device_kind": "NVIDIA H100 80GB HBM3"}) + "\n")
    (o,) = regress.ingest(led)
    assert o.chip == "NVIDIA H100 80GB HBM3"
    b = tmp_path / "BENCH_x.json"
    b.write_text(json.dumps({"rungs": {"tiny": {"step_time_s": 0.06, "device_kind": "NVIDIA H100 80GB HBM3"}}}))
    (ob,) = regress.ingest(b)
    assert ob.chip == "NVIDIA H100 80GB HBM3"
    mixed = regress.build_baselines([[regress.Observation("step_time_s", "run", 0.1, chip="NVIDIA H100 80GB HBM3")],
                                     [regress.Observation("step_time_s", "run", 0.1, chip="NVIDIA H100 PCIe")]])
    assert mixed[0].chip is None
    agree = regress.build_baselines([[regress.Observation("step_time_s", "run", 0.1, chip="NVIDIA H100 PCIe")]] * 2)
    assert agree[0].chip == "NVIDIA H100 PCIe"


def test_run_dir_backfills_metrics_chip_from_ledger(tmp_path):
    d = make_run(tmp_path, "r", chip="NVIDIA H100 80GB HBM3")
    obs = {(o.metric, o.key): o for o in regress.ingest(d)}
    assert obs[("step_time_s", "run")].chip == "NVIDIA H100 80GB HBM3"


def test_ingest_reads_a_port_ledger_record(tmp_path):
    """A ``programs.jsonl`` line as ``obs/program_cost.record_program`` writes
    it: counted FLOPs and bytes, no compile time or peak."""
    from hyperscalees_t2i_tpu_torch.obs.program_cost import ProgramLedger, record_program, set_ledger
    from hyperscalees_t2i_tpu_torch.utils.graphs import EntryStats

    set_ledger(ProgramLedger(tmp_path / "programs.jsonl"))
    try:
        record_program(site="train", label="es_step_m4r1", stats=EntryStats(),
                       cost={"flops": 3.0e12, "bytes_accessed": 2.0e10, "counted_ops": 9, "kernels": {}},
                       device="cpu", geometry={"m": 4, "r": 1})
    finally:
        set_ledger(None)
    got = regress.ingest(tmp_path)
    assert obs_tuples(got) == obs_tuples(jregress.ingest(tmp_path))
    assert {(o.metric, o.key, o.chip) for o in got} == {("flops", "train/es_step_m4r1", "cpu"),
                                                        ("bytes_accessed", "train/es_step_m4r1", "cpu")}


# ---------------------------------------------------------------------------
# baselines and verdicts
# ---------------------------------------------------------------------------

def test_build_baselines_median_mad(tmp_path):
    paths = [make_run(tmp_path, f"r{i}", step=s) for i, s in enumerate((0.10, 0.11, 0.50))]
    got = regress.build_baselines([regress.ingest(p) for p in paths])
    assert base_tuples(got) == base_tuples(jregress.build_baselines([jregress.ingest(p) for p in paths]))
    st = {(b.metric, b.key): b for b in got}[("step_time_s", "run")]
    assert st.center == pytest.approx(0.11) and st.n == 3


# (baseline runs' kwargs, candidate kwargs): clean, 2× step time and +20%
# bytes, a reward collapse, fewer epochs, a lost ledger, a resume
SCENARIOS = {
    "clean": ([{}, {"step": 0.104}], {"step": 0.102}),
    "regressed": ([{}, {"step": 0.104}], {"step": 0.21, "bytes_": 6.5e9 * 1.2}),
    "reward": ([{"reward0": 0.50}], {"reward0": 0.10}),
    "fewer_epochs": ([{"epochs": 10}], {"epochs": 4}),
    "lost_ledger": ([{}], "lost_ledger"),
    "elastic": ([{"epochs": 6}], "elastic"),
    "chip_mismatch": ([{"chip": "NVIDIA H100 80GB HBM3"}], {"chip": "NVIDIA H100 PCIe", "step": 0.4}),
}


def _scenario(tmp_path, name):
    priors, cand = SCENARIOS[name]
    paths = [make_run(tmp_path, f"prior{i}", **kw) for i, kw in enumerate(priors)]
    if cand == "lost_ledger":
        c = make_run(tmp_path, "cand")
        (c / "programs.jsonl").unlink()
    elif cand == "elastic":
        c = make_elastic_run(tmp_path, "cand")
    else:
        c = make_run(tmp_path, "cand", **cand)
    return paths, c


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_evaluate_matches_jax(tmp_path, name):
    paths, cand = _scenario(tmp_path, name)
    got = regress.evaluate(regress.build_baselines([regress.ingest(p) for p in paths]), regress.ingest(cand))
    want = jregress.evaluate(jregress.build_baselines([jregress.ingest(p) for p in paths]), jregress.ingest(cand))
    assert verdict_core(got) == verdict_core(want)
    breached = {b["metric"] for b in got["breaches"]}
    expect = {"clean": set(), "regressed": {"step_time_s", "bytes_accessed"}, "reward": {"reward_window"},
              "fewer_epochs": {"epochs_logged"}, "lost_ledger": set(), "elastic": set(), "chip_mismatch": set()}
    assert breached == expect[name]
    if name == "chip_mismatch":
        assert any("chip-kind mismatch" in s["reason"] for s in got["skipped"])
    if name == "lost_ledger":
        assert any(s["reason"] == "not observed in candidate" for s in got["skipped"])


def test_error_ratio_gate_is_up_only(tmp_path):
    base = regress.ingest(make_calib_artifact(tmp_path / "CALIB_base.json", measured=0.004, predicted=0.002))
    better = regress.ingest(make_calib_artifact(tmp_path / "CALIB_better.json", measured=0.002, predicted=0.002))
    verdict = regress.evaluate(regress.build_baselines([base]), better)
    assert not [b for b in verdict["breaches"] if b["metric"] == "calib_error_ratio"]


@pytest.mark.parametrize("metric", sorted(regress.METRIC_POLICY))
def test_tolerance_and_policy_match_jax(metric):
    p = regress.METRIC_POLICY[metric]
    jp = jregress.METRIC_POLICY[metric]
    assert {k: v for k, v in p.items() if k != "torch_sensitive"} == \
        {k: v for k, v in jp.items() if k != "jax_sensitive"}
    assert p["torch_sensitive"] == jp["jax_sensitive"]
    b = regress.Baseline(metric, "k", 2.0, 0.1, 3)
    jb = jregress.Baseline(metric, "k", 2.0, 0.1, 3)
    assert regress.tolerance(b, p) == jregress.tolerance(jb, jp)


def test_torch_sensitive_metrics_skip_under_another_torch(tmp_path):
    baselines = regress.build_baselines([regress.ingest(make_run(tmp_path, "good"))])
    bad = regress.ingest(make_run(tmp_path, "bad", bytes_=6.5e9 * 1.2, step=0.9))
    v = regress.evaluate(baselines, bad, torch_version=regress.running_torch_version(), baseline_torch="0.0.0-other")
    assert {b["metric"] for b in v["breaches"]} == {"step_time_s"}
    skipped = {s["metric"] for s in v["skipped"] if "torch-sensitive" in s["reason"]}
    assert skipped == {"bytes_accessed", "flops", "peak_bytes"}
    same = regress.evaluate(baselines, bad, torch_version="2.x", baseline_torch="2.x")
    assert {b["metric"] for b in same["breaches"]} == {"step_time_s", "bytes_accessed"}


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------

def test_manifest_round_trips_chip(tmp_path):
    b = regress.Baseline("calib_measured_s", "calib/train/es_step_m4r1", 0.004, 0.0, 1, chip="NVIDIA H100 PCIe")
    regress.write_manifest(tmp_path / "m.json", [b])
    doc = json.loads((tmp_path / "m.json").read_text())
    assert doc["gen_torch"] == torch.__version__ and "gen_jax" not in doc
    loaded = regress.load_manifest(tmp_path / "m.json")["baselines"]
    assert loaded == [b]
    del doc["entries"][0]["chip"]
    (tmp_path / "old.json").write_text(json.dumps(doc))
    assert regress.load_manifest(tmp_path / "old.json")["baselines"][0].chip is None


def test_a_jax_manifest_is_stamped_with_another_version(tmp_path):
    """A manifest the JAX package wrote loads with its entries (the sha
    dropped) and a stamp no torch version equals, so its program-shape
    baselines skip."""
    jb = jregress.build_baselines([jregress.ingest(make_run(tmp_path, "good"))])
    jregress.write_manifest(tmp_path / "jax.json", jb)
    m = regress.load_manifest(tmp_path / "jax.json")
    assert base_tuples(m["baselines"]) == base_tuples(jb)
    assert m["gen_torch"] == f"jax {jregress.running_jax_version()}"
    v = regress.evaluate(m["baselines"], regress.ingest(make_run(tmp_path, "cand")),
                         torch_version=regress.running_torch_version(), baseline_torch=m["gen_torch"])
    assert v["pass"] and {s["metric"] for s in v["skipped"]} == {"bytes_accessed", "flops", "peak_bytes"}


def test_manifest_schema_refusal(tmp_path):
    bad = tmp_path / "m.json"
    bad.write_text(json.dumps({"schema": 99, "entries": []}))
    with pytest.raises(ValueError):
        regress.load_manifest(bad)


def test_observation_fields_are_the_references_less_the_sha():
    names = [f.name for f in dataclasses.fields(regress.Observation)]
    jnames = [f.name for f in dataclasses.fields(jregress.Observation) if f.name != "sha"]
    assert names == jnames
