"""``tools/run_report.py`` of the port: one self-contained HTML file from a
run dir, against the JAX package's report.

- Parity: on run dirs without a ``programs.jsonl`` (synthetic metrics, a
  trace, CALIB, CAPACITY and QUALITY artifacts, fleet streams) the port's
  HTML is the JAX report's, byte for byte but for the kernel tiles' note
  ("device events of the hand-written kernel" for "... matching the Pallas
  kernel").
- Cross-reading: the JAX ``run_report`` exits 0 on a run dir the port's
  trainer wrote (tiny Sana, traced, quality on) and renders the same phase
  table as the port's report.
- The port's own program table: counted FLOPs and bytes, intensity, pool,
  warm-up and capture seconds and kernel calls from the port's
  ``programs.jsonl`` (no StableHLO or donation columns); a dir with
  per-host trace segments raises, naming ROADMAP item 7.
- Ported from ``tests/test_run_report.py``: the synthetic report, a report
  without trace or ``es/`` keys, no metrics, a custom output path, the
  tick and format helpers, a real CPU run, the predicted-vs-measured panel.
  Not ported: ``test_bench_report_trend_renders_calib_table``
  (``tools/bench_report.py`` is ROADMAP item 2).
"""

import json
import re
from html.parser import HTMLParser
from pathlib import Path

import pytest
import torch

from hyperscalees_t2i_tpu.tools import run_report as jrun_report
from hyperscalees_t2i_tpu_torch.tools import run_report

torch.set_num_threads(1)


class _StrictCollector(HTMLParser):
    """Every opened non-void tag closes in order."""

    VOID = {"meta", "br", "hr", "img", "input", "link", "circle", "line", "polyline", "path"}

    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.stack, self.errors, self.tags, self.text = [], [], set(), []

    def handle_starttag(self, tag, attrs):
        self.tags.add(tag)
        if tag not in self.VOID:
            self.stack.append(tag)

    def handle_endtag(self, tag):
        if tag in self.VOID:
            return
        if not self.stack or self.stack[-1] != tag:
            self.errors.append(f"unbalanced </{tag}> (stack: {self.stack[-3:]})")
        else:
            self.stack.pop()

    def handle_data(self, data):
        self.text.append(data)


def _parse(html_text):
    p = _StrictCollector()
    p.feed(html_text)
    p.close()
    assert not p.errors, p.errors
    assert p.stack == [], f"unclosed tags: {p.stack}"
    return p


def _self_contained(html_text):
    for needle in ("http://", "https://", "<script", "src=\"http", "@import"):
        assert needle not in html_text, f"not self-contained: found {needle}"


def _write_metrics(run_dir: Path, rows):
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "metrics.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")


def _synthetic_rows(n=6):
    return [{"epoch": e, "opt_score_mean": 0.1 * e, "opt_score_best": 0.1 * e + 0.05,
             "opt_score_worst": 0.1 * e - 0.05, "delta_norm": 0.02, "theta_norm": 1.0 + 0.01 * e,
             "es/update_cosine": (-1.0) ** e * 0.8, "es/cap_step_scale": 1.0 if e % 2 else 0.5,
             "es/cap_theta_scale": 1.0, "es/finite_frac": 1.0, "es/fitness_zero": 0.0, "es/pair_asym": 1.2,
             "es/leaf_delta_norm/blocks/0/attn": 0.015, "es/leaf_delta_norm/blocks/1/ffn": 0.013,
             "images_per_sec": 12.5, "step_time_s": 0.4, "resilience/rollbacks": float(e > 3),
             "resilience/retries": 2} for e in range(n)]


def _fleet_rows(n=4):
    rows = []
    for t in range(n):
        row = {"epoch": t, "fleet_tick": t, "fleet_width": 2}
        for j in range(2):
            row.update({f"job{j}/job_id": "ab"[j], f"job{j}/epoch": t, f"job{j}/opt_score_mean": 0.1 * t + j,
                        f"job{j}/reward/combined_mean": 0.2 + 0.01 * t, f"job{j}/delta_norm": 0.01,
                        f"job{j}/reward_rows_sha256": f"{j}{t}" * 20})
        rows.append(row)
    return rows


CALIB = {"mode": "calib", "schema_version": 1, "chip_kind": "NVIDIA H100 80GB HBM3",
         "rows": [{"key": "train/es_step_m4r1", "measured_source": "profile", "measured_s": 1.13,
                   "predicted_s": 0.26, "error_ratio": 4.3, "mfu_claimed": 0.55, "mfu_measured": 0.13,
                   "measured_flops_per_s": 1.3e14, "measured_bytes_per_s": 2.1e12}],
         "headline": {"rows": 1, "device_rows": 1, "max_error_ratio": 4.3, "median_error_ratio": 4.3},
         "kernel_evidence": {"fused_qlora": {"events": 2624, "total_ps": 9}, "int8_matmul": {"events": 0}},
         "unmatched_programs": ["train/orphan"]}
CAPACITY = {"mode": "capacity", "rung": "tiny", "capacity_rps": 12.0, "goodput_rps": 11.5, "knee_p99_s": 1.5,
            "slo_p99_s": 2.0, "steps": [{"offered_rps": r, "achieved_rps": r * 0.95, "goodput_rps": r * 0.9,
                                         "p50_s": 0.1, "p95_s": 0.2 * r, "p99_s": 0.3 * r} for r in (2.0, 4.0, 8.0)]}
QUALITY = {"mode": "quality", "final_reward": 0.3, "first_reward": 0.1, "auc_over_images": 0.2,
           "images_to_threshold": 32, "reward_per_device_s": 0.05, "images_total": 64, "device_s_source": "calib",
           "curve": [{"images_cum": 16 * (i + 1), "combined": 0.1 + 0.05 * i, "device_s_cum": 1.1 * (i + 1)}
                     for i in range(4)]}


def _dir(tmp_path, kind):
    d = tmp_path / kind
    if kind == "synthetic":
        _write_metrics(d, _synthetic_rows())
        (d / "trace.jsonl").write_text("\n".join(json.dumps(e) for e in [
            {"meta": "trace_start", "wall_time": 0.0, "pid": 1},
            {"name": "epoch", "t0_s": 0.0, "dur_s": 2.0, "depth": 0, "parent": None},
            {"name": "dispatch", "t0_s": 0.2, "dur_s": 1.5, "depth": 1, "parent": "epoch"},
            {"name": "serve/request", "t0_s": 0.3, "dur_s": 0.2, "depth": 0, "parent": None,
             "attrs": {"queue_wait_s": 0.01, "occupancy": 0.5, "queue_depth": 3}}]) + "\n")
        (d / "preempted.json").write_text(json.dumps({"epoch": 4, "reason": "SIGTERM"}))
    elif kind == "old":
        _write_metrics(d, [{"epoch": e, "opt_score_mean": 0.2 * e, "delta_norm": 0.1, "theta_norm": 2.0}
                           for e in range(3)])
    elif kind == "artifacts":
        _write_metrics(d, _synthetic_rows(4))
        (d / "CALIB_train.json").write_text(json.dumps(CALIB))
        (d / "CAPACITY_r01.json").write_text(json.dumps(CAPACITY))
        (d / "QUALITY_train.json").write_text(json.dumps(QUALITY))
    elif kind == "fleet":
        _write_metrics(d, _fleet_rows())
    elif kind == "calib_only":
        d.mkdir()
        (d / "CALIB_r02.json").write_text(json.dumps(CALIB))
    return d


@pytest.mark.parametrize("kind", ["synthetic", "old", "artifacts", "fleet", "calib_only"])
def test_html_matches_jax(tmp_path, kind):
    d = _dir(tmp_path, kind)
    assert jrun_report.main([str(d), "-o", str(tmp_path / "jax.html")]) == 0
    assert run_report.main([str(d), "-o", str(tmp_path / "port.html")]) == 0
    got = (tmp_path / "port.html").read_text()
    want = (tmp_path / "jax.html").read_text()
    assert got == want.replace("matching the Pallas kernel", "of the hand-written kernel")
    _parse(got)
    _self_contained(got)


def test_report_from_synthetic_run(tmp_path):
    run_dir = _dir(tmp_path, "synthetic")
    assert run_report.main([str(run_dir)]) == 0
    html_text = (run_dir / "run_report.html").read_text()
    p = _parse(html_text)
    text = " ".join(p.text)
    assert "svg" in p.tags and "table" in p.tags and "figure" in p.tags
    for section in ("Reward", "Update geometry", "Norm-cap engagement", "ES health", "Per-target", "Resilience",
                    "Serving", "phase times", "All scalars"):
        assert section in text, f"missing section: {section}"
    _self_contained(html_text)
    assert "3 engaged points" in text


def test_report_without_trace_or_es_keys(tmp_path):
    run_dir = _dir(tmp_path, "old")
    assert run_report.main([str(run_dir)]) == 0
    text = " ".join(_parse((run_dir / "run_report.html").read_text()).text)
    assert "Reward" in text and "Update geometry" in text and "Norm-cap engagement" not in text


def test_report_errors_without_metrics(tmp_path):
    assert run_report.main([str(tmp_path)]) == 1
    empty = tmp_path / "empty_run"
    empty.mkdir()
    (empty / "metrics.jsonl").write_text("not json\n")
    assert run_report.main([str(empty)]) == 1


def test_report_custom_output_path(tmp_path):
    run_dir = tmp_path / "run"
    _write_metrics(run_dir, _synthetic_rows(3))
    out = tmp_path / "elsewhere" / "r.html"
    out.parent.mkdir()
    assert run_report.main([str(run_dir), "-o", str(out)]) == 0
    assert out.exists()


def test_ticks_and_fmt_helpers():
    ticks = run_report._ticks(0.0, 10.0, 4)
    assert ticks[0] >= 0.0 and ticks[-1] <= 10.0 and len(ticks) >= 2
    assert run_report._ticks(5.0, 5.0) == [5.0]
    assert run_report._fmt(float("nan")) == "—"
    assert run_report._fmt(1.25) == "1.25"
    assert run_report._fmt(0.000012) == "1.2e-05"
    assert run_report._fmt("<prompt>") == "&lt;prompt&gt;"
    for lo, hi in ((0.0, 10.0), (-1.05, 1.05), (0.003, 0.0041), (5.0, 5.0)):
        assert run_report._ticks(lo, hi) == jrun_report._ticks(lo, hi)


def test_report_renders_predicted_vs_measured_panel(tmp_path):
    run_dir = _dir(tmp_path, "artifacts")
    assert run_report.main([str(run_dir)]) == 0
    html_text = (run_dir / "run_report.html").read_text()
    text = " ".join(_parse(html_text).text)
    assert "Predicted vs measured" in text and "train/es_step_m4r1" in text and "profile" in text
    assert "fused_qlora" in text and "device events of the hand-written kernel" in text and "train/orphan" in text
    assert "Capacity" in text and "Quality" in text
    _self_contained(html_text)
    solo = _dir(tmp_path, "calib_only")
    assert run_report.main([str(solo)]) == 0
    assert "Predicted vs measured" in (solo / "run_report.html").read_text()


def test_fleet_panel(tmp_path):
    d = _dir(tmp_path, "fleet")
    assert run_report.main([str(d)]) == 0
    text = " ".join(_parse((d / "run_report.html").read_text()).text)
    assert "Fleet" in text and "Jobs seen" in text and "Per-job reward" in text


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Two traced epochs of the port's ``run_training`` at tiny, quality on."""
    from hyperscalees_t2i_tpu_torch.train import trainer
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from test_torch_trainer import brightness, port_backend

    root = tmp_path_factory.mktemp("report")
    tc = TrainConfig(num_epochs=2, pop_size=4, sigma=0.05, egg_rank=2, promptnorm=False, prompts_per_gen=2,
                     member_batch=4, run_dir=str(root / "runs"), save_every=0, seed=13, trace=True, quality=True,
                     run_name="r")
    trainer.run_training(port_backend(), brightness, tc, device="cpu")
    return root / "runs" / "r"


def _phase_table(html_text):
    part = html_text.split("Host-side phase times")[1]
    return re.search(r"<table>.*?</table>", part).group(0)


def test_report_smoke_from_real_cpu_run(port_run):
    assert run_report.main([str(port_run)]) == 0
    html_text = (port_run / "run_report.html").read_text()
    text = " ".join(_parse(html_text).text)
    assert "ES health" in text and "phase times" in text and "es/update_cosine" in text
    assert "Roofline &amp; programs" in html_text and "es_step_m2r1" in text
    _self_contained(html_text)


def test_jax_run_report_reads_the_ports_run_dir(port_run, tmp_path):
    assert jrun_report.main([str(port_run), "-o", str(tmp_path / "jax.html")]) == 0
    assert run_report.main([str(port_run), "-o", str(tmp_path / "port.html")]) == 0
    want, got = (tmp_path / "jax.html").read_text(), (tmp_path / "port.html").read_text()
    _parse(want)
    assert _phase_table(got) == _phase_table(want)
    # the parts before the program table are the same report
    assert got.split("<h2>Roofline")[0] == want.split("<h2>Roofline")[0]


def test_program_table_has_the_ports_columns(port_run):
    from hyperscalees_t2i_tpu_torch.obs.program_cost import load_programs

    (rec,) = load_programs(port_run)
    assert run_report.main([str(port_run)]) == 0
    html_text = (port_run / "run_report.html").read_text()
    heads = re.findall(r"<th>(.*?)</th>", html_text.split("Roofline &amp; programs")[1].split("</table>")[0])
    assert heads == ["program", "site", "geometry", "chain", "TFLOP", "bytes moved", "FLOP/B", "peak bytes",
                     "graph pool", "warm-up s", "capture s", "kernel calls"]
    assert "HLO" not in html_text and "donation" not in html_text
    assert run_report._fmt(rec["flops"] / 1e12, 3) in html_text


def test_per_host_segments_raise_naming_item_7(tmp_path):
    d = _dir(tmp_path, "synthetic")
    (d / "trace.1.jsonl").write_text((d / "trace.jsonl").read_text())
    with pytest.raises(NotImplementedError, match="item 7"):
        run_report.main([str(d)])
