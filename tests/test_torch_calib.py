"""The port's measured-against-predicted layer (``obs/calib.py``), its trace
reader (``obs/profile_trace.py``) and the profile windows of the trainer
and the serving engine, on the CPU.

- ``roofline`` equals the JAX ``obs/xla_cost.roofline`` on a grid of
  inputs, exactly.
- ``predicted_step_time_s`` and ``reconcile`` equal the reference's on the
  same records: CPU records (no peaks: both None) and records whose peaks
  are patched to the same values on both sides (the two peak tables share
  no device kind). The rows differ by design in ``measured_source``
  (``"profile"`` for the reference's ``"xplane"``) and in the reference's
  ``stablehlo_sha256``, which has no counterpart.
- ``calibrate_run`` over a synthetic trace (``build_trace``): device time
  per range as the union of its kernels, the host-wall fallback, parse
  errors collected, K1-K4 evidence; ``calib_gauges`` into a registry;
  ``write_calib``/``load_calib`` round trip.
- The trainer's ``profile_epochs`` window on the CPU writes a trace and a
  ``CALIB_train.json`` that takes the host-wall fallback (a CPU trace has
  no device events); the serving engine's ``profile_dir`` window writes
  one trace after ``profile_batches`` dispatches.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.obs import calib as jcalib
from hyperscalees_t2i_tpu.obs.xla_cost import roofline as jroofline
from hyperscalees_t2i_tpu.utils import mfu as jmfu
from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_serve_backend
from hyperscalees_t2i_tpu_torch.obs import calib, profile_trace
from hyperscalees_t2i_tpu_torch.obs.metrics import MetricsRegistry
from hyperscalees_t2i_tpu_torch.obs.program_cost import roofline
from hyperscalees_t2i_tpu_torch.rungs import sana_rung_model
from hyperscalees_t2i_tpu_torch.serve import ServeConfig, ServeEngine
from hyperscalees_t2i_tpu_torch.train import trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils import mfu
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows
from tests.test_torch_trainer import brightness, port_backend

torch.set_num_threads(1)


def test_roofline_matches_jax_on_a_grid():
    values = dict(flops=[None, 0.0, 3e9, 4e12], bytes_accessed=[None, 2e6, 5e9], measured=[None, 1e-4, 0.02, 3.0],
                  peak=[None, 989e12], bw=[None, 3.35e12], n=[1, 4], coll=[None, 1e8], ici=[None, 2e11])
    for f, b, t, p, w, n, c, i in itertools.product(*values.values()):
        kw = dict(peak_flops=p, hbm_bw=w, n_devices=n, collective_bytes=c, ici_bw=i)
        assert roofline(f, b, t, **kw) == jroofline(f, b, t, **kw), (f, b, t, kw)
    assert roofline(1e12, 1e9, 10.0, peak_flops=1e15, hbm_bw=1e12, latency_factor=1e6) == \
        jroofline(1e12, 1e9, 10.0, peak_flops=1e15, hbm_bw=1e12, latency_factor=1e6)


RECORDS = [
    {"site": "train", "label": "es_step_m4r1", "device_kind": "chip-x", "n_devices": 1, "flops": 4e12,
     "bytes_accessed": 2e10},
    {"site": "train", "label": "es_step_m2r1", "device_kind": "chip-x", "n_devices": 1, "flops": 1e9,
     "bytes_accessed": 5e10},
    {"site": "train", "label": "es_step_m4r1", "device_kind": "chip-x", "n_devices": 1, "flops": 5e12,
     "bytes_accessed": 2e10},  # re-recorded: the last record wins
    {"site": "train", "label": "es_step_m8r1", "device_kind": "cpu", "n_devices": 1, "flops": 1e9},
    {"site": "serve", "label": "unmeasured", "device_kind": "chip-x"},
]
MEASURED = {"train/es_step_m4r1": {"measured_s": 0.02, "occurrences": 3, "measured_flops_per_s": 2.5e14,
                                   "measured_bytes_per_s": 1e12}}
HOST = {"train/es_step_m2r1": 0.5, "train/es_step_m4r1": 0.03, "train/es_step_m8r1": 0.2}


@pytest.fixture()
def same_peaks(monkeypatch):
    """Peaks for "chip-x" on both sides; every other kind unknown."""
    table = {"peak_flops_for_kind": 500e12, "hbm_bw_for_kind": 2e12}
    for mod in (mfu, jmfu):
        for fn, v in table.items():
            monkeypatch.setattr(mod, fn, lambda kind, v=v: v if kind == "chip-x" else None)
    monkeypatch.setattr(jmfu, "ici_bw_for_kind", lambda kind: None)


def test_predicted_step_time_matches_jax(same_peaks):
    for rec in RECORDS:
        assert calib.predicted_step_time_s(rec) == jcalib.predicted_step_time_s(rec), rec
    assert calib.predicted_step_time_s(RECORDS[0]) == pytest.approx(max(4e12 / 500e12, 2e10 / 2e12))
    assert calib.predicted_step_time_s(RECORDS[3]) is None


def test_predicted_step_time_on_the_cpu_is_none():
    assert calib.predicted_step_time_s(RECORDS[3]) is None is jcalib.predicted_step_time_s(RECORDS[3])
    assert mfu.device_peak_flops("cpu") is None and mfu.mfu(1e12, 0.1, 1, device="cpu") is None


@pytest.mark.parametrize("peaks", [True, False])
def test_reconcile_matches_jax(request, peaks):
    if peaks:
        request.getfixturevalue("same_peaks")
    ours = calib.reconcile(RECORDS, MEASURED, HOST)
    ref = jcalib.reconcile(RECORDS, MEASURED, HOST)
    for row in ref:
        assert row.pop("stablehlo_sha256") is None
        row["measured_source"] = {"xplane": "profile"}.get(row["measured_source"], row["measured_source"])
    assert ours == ref
    assert [r["key"] for r in ours] == ["train/es_step_m2r1", "train/es_step_m4r1", "train/es_step_m8r1"]
    assert [r["measured_source"] for r in ours] == ["host_wall", "profile", "host_wall"]


def _trace(tmp_path, name="train.pt.trace.json"):
    spec = {"ranges": [{"name": "train/es_step_m4r1", "ts": 1000, "dur": 100},
                       {"name": "train/es_step_m4r1", "ts": 2000, "dur": 50},
                       {"name": "train/idle", "ts": 3000, "dur": 10}],
            "kernels": [{"name": "void hses::int8_mma_kernel<128, 128>(...)", "ts": 1010, "dur": 20},
                        {"name": "_ZN4hses16qlora_mma_kernelILi64EEEvv", "ts": 1020, "dur": 30},  # overlaps
                        {"name": "Memcpy HtoD", "ts": 1090, "dur": 40, "cat": "gpu_memcpy"},  # clipped at 1100
                        {"name": "elementwise_kernel", "ts": 2005, "dur": 10},
                        {"name": "int8_mma_kernel_v2", "ts": 2030, "dur": 5}]}
    path = tmp_path / "profile" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(profile_trace.build_trace(spec))
    return path


def test_trace_reader_attributes_by_window(tmp_path):
    trace = profile_trace.load_trace(_trace(tmp_path))
    durations = profile_trace.program_durations(trace)
    # 1010-1050 (two overlapping kernels) + 1090-1100 (the copy, clipped) = 50; then 10 + 5
    assert durations == {"train/es_step_m4r1": {"count": 2, "total_us": 65.0, "avg_us": 32.5}}
    evidence = profile_trace.kernel_evidence(trace)
    assert evidence["int8_matmul"]["events"] == 1 and evidence["fused_qlora"]["events"] == 1  # whole names only
    assert evidence["lora_chain"]["events"] == evidence["decode_attention"]["events"] == 0
    assert profile_trace.op_durations(trace)["Memcpy HtoD"] == {"count": 1, "total_us": 40.0, "avg_us": 40.0}
    assert profile_trace.normalize_program_name("train/ES_step-m4r1") == "es_step_m4r1"
    joined = profile_trace.join_ledger(durations, RECORDS)
    assert [r["key"] for r in joined["rows"]] == ["train/es_step_m4r1"]
    assert joined["rows"][0]["measured_flops_per_s"] == pytest.approx(5e12 / 32.5e-6)
    assert joined["unmatched_programs"] == [] and "serve/unmeasured" in joined["unmatched_records"]


def test_calibrate_run_device_truth_fallback_and_parse_errors(tmp_path, same_peaks):
    _trace(tmp_path)
    (tmp_path / "profile" / "cut.pt.trace.json").write_text('{"traceEvents": [{"ph": "X"')
    (tmp_path / "programs.jsonl").write_text("".join(json.dumps(r) + "\n" for r in RECORDS) + "not json\n")
    reg = MetricsRegistry()
    payload = calib.calibrate_run(tmp_path, host_measured=HOST, registry=reg)
    rows = {r["key"]: r for r in payload["rows"]}
    assert rows["train/es_step_m4r1"]["measured_source"] == "profile"
    assert rows["train/es_step_m4r1"]["measured_s"] == pytest.approx(32.5e-6)
    assert rows["train/es_step_m4r1"]["error_ratio"] == pytest.approx(32.5e-6 / (5e12 / 500e12))
    assert rows["train/es_step_m2r1"]["measured_source"] == "host_wall" and rows["train/es_step_m2r1"]["measured_s"] == 0.5
    assert payload["headline"]["rows"] == 3 and payload["headline"]["device_rows"] == 1
    assert len(payload["parse_errors"]) == 1 and "cut.pt.trace.json" in payload["parse_errors"][0]["file"]
    assert payload["kernel_evidence"]["int8_matmul"]["events"] == 1
    assert payload["chip_kind"] == "chip-x" and payload["torch_version"] == torch.__version__
    snap = reg.snapshot()
    assert snap["obs/calib/rows"] == 3 and snap["obs/calib/kernel/fused_qlora/events"] == 1
    assert snap["obs/calib/train/es_step_m4r1/measured_s"] == pytest.approx(32.5e-6)
    assert "obs/calib/train/es_step_m4r1/error_ratio" in snap
    out = calib.write_calib(payload, tmp_path / "CALIB_train.json")
    assert calib.load_calib(out) == json.loads(json.dumps(payload, default=str))
    (tmp_path / "wrapped.json").write_text(json.dumps({"parsed": {"mode": "calib", "rows": []}}))
    assert calib.load_calib(tmp_path / "wrapped.json") == {"mode": "calib", "rows": []}
    assert calib.load_calib(tmp_path / "programs.jsonl") is None


def test_trace_parse_error_is_loud(tmp_path):
    (tmp_path / "a.trace.json").write_text("[1, 2")
    (tmp_path / "b.trace.json").write_text("{}")
    for f in ("a.trace.json", "b.trace.json"):
        with pytest.raises(profile_trace.TraceParseError):
            profile_trace.load_trace(tmp_path / f)


def test_trainer_profile_window_on_the_cpu(tmp_path):
    tc = TrainConfig(num_epochs=3, pop_size=4, sigma=0.05, egg_rank=2, prompts_per_gen=2, member_batch=2,
                     save_every=0, log_hist_every=0, profile_epochs=2, steps_per_dispatch=4, seed=2,
                     run_dir=str(tmp_path), run_name="prof")
    trainer.run_training(port_backend(), brightness, tc, device="cpu")
    run_dir = tmp_path / "prof"
    (trace_file,) = profile_trace.find_trace_files(run_dir)
    ranges = profile_trace.range_events(profile_trace.load_trace(trace_file))
    assert [r["name"] for r in ranges] == ["train/es_step_m2r1"] * 2  # one range a dispatch of the window
    payload = calib.load_calib(run_dir / "CALIB_train.json")
    (row,) = payload["rows"]
    assert row["key"] == "train/es_step_m2r1" and row["measured_source"] == "host_wall"
    assert row["predicted_s"] is None and payload["headline"]["device_rows"] == 0
    rows = read_jsonl_rows(run_dir / "metrics.jsonl")
    assert [r["epochs_chained"] for r in rows] == [1, 1, 1]  # no chain inside the window; one epoch after it
    assert rows[-1]["obs/calib/rows"] == 1 and "mfu" not in rows[-1] and "roofline/bound" not in rows[-1]
    (rec,) = [json.loads(line) for line in (run_dir / "programs.jsonl").read_text().splitlines()]
    assert rec["label"] == "es_step_m2r1" and rec["flops"] > 0 and rec["bytes_accessed"] > 0
    quality = json.loads((run_dir / "QUALITY_train.json").read_text())
    # the reference's rule: any train/ row of a CALIB file sets the per-epoch seconds
    assert quality["device_s_source"] == "calib" and len(quality["curve"]) == 3
    assert quality["device_s_total"] == pytest.approx(3 * row["measured_s"], abs=1e-5)


def test_serving_profile_window_on_the_cpu(tmp_path):
    backend = build_serve_backend(sana_rung_model("tiny")["bcfg"], "off", device="cpu",
                                  prompts=["a red cube", "a blue sphere", "a green cone"])
    eng = ServeEngine(backend, ServeConfig(adapter_batch=2, device="cpu", profile_dir=str(tmp_path / "prof"),
                                           profile_batches=1))
    eng.put_adapter("t0", eng.template)
    eng.warmup()
    assert not (tmp_path / "prof").exists()  # the warm-up stays out of the window
    for i in range(4):
        eng.submit("t0", [i % 3], seed=i)
    res = eng.flush(max_batches=1)
    assert len(res) == 2 and all(r.ok for r in res)
    (trace_file,) = profile_trace.find_trace_files(tmp_path / "prof")
    assert eng.profile_trace == trace_file
    trace = profile_trace.load_trace(trace_file)
    assert any(ev.get("ph") == "X" for ev in trace["traceEvents"])
    assert all(ev["events"] == 0 for ev in profile_trace.kernel_evidence(trace).values())  # no card
    assert len(eng.flush()) == 2 and len(profile_trace.find_trace_files(tmp_path / "prof")) == 1  # one window
    eng.close()
    assert np.isfinite(np.stack([r.images for r in res])).all()
