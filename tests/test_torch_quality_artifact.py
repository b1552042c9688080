"""The port's sample-efficiency artifact (``obs.quality.build_quality_artifact``
and its CLI) against the JAX package's on the CPU: one synthetic run dir (a
resumed ``metrics.jsonl`` whose replayed epochs supersede, a chained
dispatch, ``quality.jsonl``, ``programs.jsonl`` and a ``CALIB_train.json``)
gives equal payloads in both, apart from the version stamp (``jax_version``
there, ``torch_version`` here); so does the same dir without the CALIB file
(host-wall device seconds)."""

import json

import pytest
import torch

from hyperscalees_t2i_tpu.obs import quality as jquality
from hyperscalees_t2i_tpu_torch.obs import quality

torch.set_num_threads(1)


def _row(epoch, combined, images=16, step_s=0.5, chained=1, **extra):
    return {"epoch": epoch, "reward/combined_mean": combined, "reward/clip_text_mean": combined / 2,
            "reward/pickscore_mean": combined * 0.1, "images_scored": images, "step_time_s": step_s,
            "epochs_chained": chained, "opt_score_mean": 0.0, **extra}


def _run_dir(tmp_path, calib: bool):
    rows = [_row(0, 0.20, step_s=9.0), _row(1, 0.25), _row(2, 0.9),  # the first incarnation
            _row(2, 0.31), _row(5, 0.42, images=48, chained=3), _row(6, float("nan")), _row(7, 0.40)]
    (tmp_path / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows) + "{torn")
    (tmp_path / "quality.jsonl").write_text(json.dumps({"epoch": 7, "hardest": [{"prompt": 1, "mean": 0.1}]}) + "\n")
    (tmp_path / "programs.jsonl").write_text(
        json.dumps({"site": "train", "label": "es_step_m4r1", "device_kind": "NVIDIA H100 80GB HBM3",
                    "flops": 1e12, "bytes_accessed": 1e9}) + "\n")
    if calib:
        (tmp_path / "CALIB_train.json").write_text(json.dumps({"mode": "calib", "rows": [
            {"key": "train/es_step_m4r1", "measured_s": 0.25},
            {"key": "serve/x", "measured_s": 9.0},
            {"key": "train/es_step_m2r1", "measured_s": 0.5}]}))
    return tmp_path


@pytest.mark.parametrize("calib", [True, False])
@pytest.mark.parametrize("threshold_frac", [0.9, 0.5])
def test_artifact_matches_jax(tmp_path, calib, threshold_frac):
    run_dir = _run_dir(tmp_path, calib)
    ours = quality.build_quality_artifact(run_dir, threshold_frac=threshold_frac)
    ref = jquality.build_quality_artifact(run_dir, threshold_frac=threshold_frac)
    assert ours.pop("torch_version") == torch.__version__
    ref.pop("jax_version")
    assert ours == ref
    assert ours["device_s_source"] == ("calib" if calib else "host_wall")
    assert [c["epoch"] for c in ours["curve"]] == [0, 1, 2, 5, 6, 7]  # 6: the NaN mean falls back to opt_score_mean
    assert ours["chip_kind"] == "NVIDIA H100 80GB HBM3"


def test_write_load_and_main_match_jax(tmp_path, capsys):
    (tmp_path / "run").mkdir()
    run_dir = _run_dir(tmp_path / "run", True)
    assert quality.main([str(run_dir), "--out", str(tmp_path / "ours.json")]) == 0
    assert jquality.main([str(run_dir), "--out", str(tmp_path / "ref.json")]) == 0
    ours, ref = quality.load_quality(tmp_path / "ours.json"), jquality.load_quality(tmp_path / "ref.json")
    ours.pop("torch_version"), ref.pop("jax_version")
    assert ours == ref
    # the default output, and a {"parsed": ...} wrapper unwrapped
    assert quality.main([str(run_dir)]) == 0 and (run_dir / "QUALITY_run.json").exists()
    (tmp_path / "wrapped.json").write_text(json.dumps({"parsed": ours}))
    assert quality.load_quality(tmp_path / "wrapped.json") == ours
    assert quality.load_quality(tmp_path / "missing.json") is None
    assert quality.main([str(tmp_path / "empty")]) == 1
    assert "no metrics.jsonl" in capsys.readouterr().err
