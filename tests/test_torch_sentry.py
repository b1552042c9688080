"""``tools/sentry.py`` of the port against the JAX package's CLI on the same
fixture files: the exit codes (0 pass, 1 usage or ingest error, 2 breach)
and the ``sentry_verdict.json`` documents are equal, the version stamps
(``jax_version``/``baseline_jax`` against ``torch_version``/
``baseline_torch``), the timestamp and the reference's ``sha_changes`` (no
sha in the port's ledger) aside.

Ported from ``tests/test_sentry.py`` (its CLI cases; the module-level ones
are in ``tests/test_torch_regress.py``): a clean re-run passes, an injected
regression breaches naming the metric, baseline and observed value, a
reward collapse and fewer epochs breach, the manifest round trip, the skip
of program-shape metrics under another version, a schema refusal, a lost
ledger is a skip, no baseline is a usage error, an elastic resume is not an
epoch regression, a doctored calibration trips and a chip-kind mismatch
skips by name. ``test_matching_sha_gates_even_under_different_jax`` has no
counterpart (the port's ledger has no StableHLO sha). The verdict lands
where the port's trainer reads it for ``/healthz``.
"""

import json
import socket

import pytest
import torch

from hyperscalees_t2i_tpu.tools import sentry as jsentry
from hyperscalees_t2i_tpu_torch.obs import regress
from hyperscalees_t2i_tpu_torch.tools import sentry
from test_torch_regress import make_calib_artifact, make_elastic_run, make_run

torch.set_num_threads(1)

_STAMPS = ("jax_version", "baseline_jax", "torch_version", "baseline_torch", "sha_changes", "ts")


def _doc(path):
    return {k: v for k, v in json.loads(path.read_text()).items() if k not in _STAMPS}


def _both(tmp_path, argv_of, verdict_of):
    """Run both CLIs on the same files; return the port's (rc, verdict) after
    checking them against the JAX CLI's."""
    out = []
    for tag, cli in (("jax", jsentry), ("port", sentry)):
        rc = cli.main(argv_of(tag))
        out.append((rc, _doc(verdict_of(tag)) if verdict_of(tag).exists() else None))
    assert out[0] == out[1]
    return out[1]


@pytest.mark.parametrize("name,priors,cand,want_rc,breached", [
    ("clean", [{}, {"step": 0.104}], {"step": 0.102}, 0, set()),
    ("regressed", [{}, {"step": 0.104}], {"step": 0.21, "bytes_": 6.5e9 * 1.2}, 2, {"step_time_s", "bytes_accessed"}),
    ("reward", [{"reward0": 0.50}], {"reward0": 0.10}, 2, {"reward_window"}),
    ("fewer_epochs", [{"epochs": 10}], {"epochs": 4}, 2, {"epochs_logged"}),
])
def test_check_matches_jax(tmp_path, name, priors, cand, want_rc, breached):
    paths = [make_run(tmp_path, f"prior{i}", **kw) for i, kw in enumerate(priors)]
    c = make_run(tmp_path, "cand", **cand)
    base = [a for p in paths for a in ("--baseline", str(p))]
    rc, doc = _both(tmp_path, lambda t: ["check", str(c), *base, "--out", str(tmp_path / f"v_{t}.json")],
                    lambda t: tmp_path / f"v_{t}.json")
    assert rc == want_rc
    assert {b["metric"] for b in doc["breaches"]} == breached
    assert doc["pass"] is (want_rc == 0) and doc["candidate"] == str(c)


def test_clean_rerun_passes(tmp_path, capsys):
    make_run(tmp_path, "prior1")
    make_run(tmp_path, "prior2", step=0.104)
    clean = make_run(tmp_path, "clean", step=0.102)
    rc = sentry.main(["check", str(clean), "--baseline", str(tmp_path / "prior1"),
                      "--baseline", str(tmp_path / "prior2")])
    assert rc == 0
    assert "VERDICT: pass" in capsys.readouterr().out
    v = json.loads((clean / regress.VERDICT_FILE).read_text())
    assert v["pass"] and v["checked"] >= 6 and v["breaches"] == []
    assert v["torch_version"] == v["baseline_torch"] == torch.__version__


def test_injected_regression_breaches_with_names(tmp_path, capsys):
    make_run(tmp_path, "prior1")
    make_run(tmp_path, "prior2", step=0.104)
    bad = make_run(tmp_path, "bad", step=0.21, bytes_=6.5e9 * 1.2)
    rc = sentry.main(["check", str(bad), "--baseline", str(tmp_path / "prior1"),
                      "--baseline", str(tmp_path / "prior2")])
    assert rc == sentry.EXIT_BREACH == 2
    out = capsys.readouterr().out
    assert "BREACH step_time_s[run]" in out and "0.21" in out
    assert "BREACH bytes_accessed[train/es_step_m2r1]" in out
    assert "VERDICT: FAIL" in out
    v = json.loads((bad / regress.VERDICT_FILE).read_text())
    assert not v["pass"]
    for b in v["breaches"]:
        assert b["baseline"] and b["observed"] and "bound" in b


def test_reward_regression_breaches_downward(tmp_path):
    make_run(tmp_path, "prior", reward0=0.50)
    worse = make_run(tmp_path, "worse", reward0=0.10)
    assert sentry.main(["check", str(worse), "--baseline", str(tmp_path / "prior")]) == sentry.EXIT_BREACH
    v = json.loads((worse / regress.VERDICT_FILE).read_text())
    assert any(b["metric"] == "reward_window" and b["direction"] == "lower" for b in v["breaches"])


def test_fewer_epochs_breaches(tmp_path):
    make_run(tmp_path, "prior", epochs=10)
    short = make_run(tmp_path, "short", epochs=4)
    assert sentry.main(["check", str(short), "--baseline", str(tmp_path / "prior")]) == sentry.EXIT_BREACH
    v = json.loads((short / regress.VERDICT_FILE).read_text())
    assert any(b["metric"] == "epochs_logged" for b in v["breaches"])


def test_manifest_roundtrip_and_check(tmp_path, capsys):
    make_run(tmp_path, "good1")
    make_run(tmp_path, "good2", step=0.105)
    for tag, cli in (("jax", jsentry), ("port", sentry)):
        assert cli.main(["baseline", "--out", str(tmp_path / f"m_{tag}.json"), str(tmp_path / "good1"),
                         str(tmp_path / "good2")]) == 0
    doc = json.loads((tmp_path / "m_port.json").read_text())
    jdoc = json.loads((tmp_path / "m_jax.json").read_text())
    assert doc["schema"] == regress.MANIFEST_SCHEMA and doc["gen_torch"] == regress.running_torch_version()
    assert [{k: v for k, v in e.items() if k != "sha"} for e in jdoc["entries"]] == doc["entries"]
    capsys.readouterr()
    clean = make_run(tmp_path, "clean")
    assert sentry.main(["check", str(clean), "--manifest", str(tmp_path / "m_port.json")]) == 0
    bad = make_run(tmp_path, "bad", step=0.5)
    assert sentry.main(["check", str(bad), "--manifest", str(tmp_path / "m_port.json")]) == sentry.EXIT_BREACH


def test_baseline_merge_and_exclude(tmp_path, capsys):
    make_run(tmp_path, "good1")
    out = tmp_path / "m.json"
    assert sentry.main(["baseline", "--out", str(out), str(tmp_path / "good1")]) == 0
    make_calib_artifact(tmp_path / "CALIB_r01.json")
    assert sentry.main(["baseline", "--out", str(out), "--merge", "--exclude", "step_time_s,compile_s",
                        str(tmp_path / "CALIB_r01.json")]) == 0
    metrics = {b.metric for b in regress.load_manifest(out)["baselines"]}
    assert {"calib_measured_s", "bytes_accessed", "epochs_logged"} <= metrics
    assert not metrics & {"step_time_s", "compile_s"}


def test_torch_sensitive_metrics_skip_under_different_torch(tmp_path):
    make_run(tmp_path, "good")
    manifest = tmp_path / "m.json"
    regress.write_manifest(manifest, regress.build_baselines([regress.ingest(tmp_path / "good")]))
    doc = json.loads(manifest.read_text())
    doc["gen_torch"] = "0.0.0-other"
    manifest.write_text(json.dumps(doc))
    bad_bytes = make_run(tmp_path, "bad_bytes", bytes_=6.5e9 * 1.2)
    assert sentry.main(["check", str(bad_bytes), "--manifest", str(manifest)]) == 0
    v = json.loads((bad_bytes / regress.VERDICT_FILE).read_text())
    assert any("torch-sensitive" in s["reason"] for s in v["skipped"])
    assert all(b["metric"] != "bytes_accessed" for b in v["breaches"])
    bad_step = make_run(tmp_path, "bad_step", step=0.9)
    assert sentry.main(["check", str(bad_step), "--manifest", str(manifest)]) == sentry.EXIT_BREACH


def test_manifest_schema_refusal(tmp_path):
    bad = tmp_path / "m.json"
    bad.write_text(json.dumps({"schema": 99, "entries": []}))
    assert sentry.main(["check", str(tmp_path), "--manifest", str(bad)]) == 1
    assert jsentry.main(["check", str(tmp_path), "--manifest", str(bad)]) == 1


def test_missing_candidate_metric_is_skip_not_breach(tmp_path):
    full = make_run(tmp_path, "full")
    partial = make_run(tmp_path, "partial")
    (partial / "programs.jsonl").unlink()
    rc, doc = _both(tmp_path, lambda t: ["check", str(partial), "--baseline", str(full), "--out",
                                         str(tmp_path / f"v_{t}.json")], lambda t: tmp_path / f"v_{t}.json")
    assert rc == 0
    assert any(s["reason"] == "not observed in candidate" for s in doc["skipped"])


def test_check_requires_some_baseline(tmp_path, capsys):
    d = make_run(tmp_path, "x")
    assert sentry.main(["check", str(d)]) == 1 == jsentry.main(["check", str(d)])
    assert "need --baseline" in capsys.readouterr().err


def test_ingest_error_is_a_usage_error(tmp_path, capsys):
    d = make_run(tmp_path, "x")
    assert sentry.main(["check", str(tmp_path / "nope.txt"), "--baseline", str(d)]) == 1
    assert jsentry.main(["check", str(tmp_path / "nope.txt"), "--baseline", str(d)]) == 1


def test_elastic_resume_is_not_an_epoch_regression(tmp_path):
    base = make_run(tmp_path, "base", epochs=6)
    cand = make_elastic_run(tmp_path, "cand")
    rc, doc = _both(tmp_path, lambda t: ["check", str(cand), "--baseline", str(base), "--out",
                                         str(tmp_path / f"v_{t}.json")], lambda t: tmp_path / f"v_{t}.json")
    assert not [b for b in doc["breaches"] if b["metric"] == "epochs_logged"]


def test_doctored_measured_time_trips_calib_sentry(tmp_path, capsys):
    base = make_calib_artifact(tmp_path / "CALIB_base.json")
    bad = make_calib_artifact(tmp_path / "CALIB_bad.json", measured=0.008, predicted=0.002)
    rc, _ = _both(tmp_path, lambda t: ["check", str(bad), "--baseline", str(base), "--out",
                                       str(tmp_path / f"v_{t}.json")], lambda t: tmp_path / f"v_{t}.json")
    assert rc == sentry.EXIT_BREACH
    out = capsys.readouterr().out
    assert "BREACH calib_measured_s[calib/train/es_step_m4r1]" in out
    assert "BREACH calib_error_ratio[calib/train/es_step_m4r1]" in out


def test_chip_kind_mismatch_skips_loudly(tmp_path, capsys):
    base = make_calib_artifact(tmp_path / "CALIB_base.json", chip="NVIDIA H100 80GB HBM3")
    cand = make_calib_artifact(tmp_path / "CALIB_cand.json", measured=0.016, chip="NVIDIA H100 PCIe")
    rc, doc = _both(tmp_path, lambda t: ["check", str(cand), "--baseline", str(base), "--out",
                                         str(tmp_path / f"v_{t}.json")], lambda t: tmp_path / f"v_{t}.json")
    assert rc == 0
    out = capsys.readouterr().out
    assert "chip-kind mismatch" in out and "NVIDIA H100 PCIe" in out
    assert any("chip-kind mismatch" in s["reason"] for s in doc["skipped"])


def test_no_default_manifest(tmp_path, monkeypatch, capsys):
    """A check with neither --baseline nor --manifest is a usage error even
    beside a ``SENTRY_BASELINE.json``: the port reads a manifest only when
    told to."""
    make_run(tmp_path, "good")
    regress.write_manifest(tmp_path / "SENTRY_BASELINE.json",
                           regress.build_baselines([regress.ingest(tmp_path / "good")]))
    monkeypatch.chdir(tmp_path)
    assert sentry.main(["check", str(tmp_path / "good")]) == 1
    with pytest.raises(SystemExit):
        sentry.main(["baseline", str(tmp_path / "good")])  # --out is required


def test_verdict_reaches_the_trainers_healthz(tmp_path):
    """``check`` writes the verdict into the candidate run dir, where
    ``run_training``'s ``/healthz`` reads it as ``sentry_verdict``."""
    import urllib.request

    from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_train_backend
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.train.trainer import run_training

    backend, reward = build_train_backend("tiny", "cpu", seed=0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tc = TrainConfig(num_epochs=2, pop_size=4, prompts_per_gen=2, member_batch=1, save_every=1,
                     run_dir=str(tmp_path), run_name="run", metrics_port=port, metrics_host="127.0.0.1")
    run_training(backend, reward, tc, device="cpu")
    run_dir = tmp_path / "run"
    assert sentry.main(["check", str(run_dir), "--baseline", str(run_dir)]) == 0
    seen = {}

    def scrape(epoch, _row):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            seen[epoch] = json.loads(r.read())

    run_training(backend, reward, TrainConfig(**{**tc.__dict__, "num_epochs": 3, "resume": True}),
                 on_epoch_end=scrape, device="cpu")
    hz = seen[2]["sentry_verdict"]
    assert hz["pass"] is True and hz["breaches"] == 0 and hz["path"] == str(run_dir / regress.VERDICT_FILE)
