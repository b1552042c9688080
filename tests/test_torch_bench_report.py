"""The port's bench report (``hyperscalees_t2i_tpu_torch/tools/bench_report.py``)
renders the same markdown as the JAX tool on the same documents, the
trend's version column apart (``torch_version`` where the JAX tool reads
``jax_version``). The documents are the root ``*_r0*.json`` files, read as
schema fixtures only, plus ones written here: a calibration document, a
rung log, and records with the knob and Pallas fields the marks render."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from hyperscalees_t2i_tpu.tools import bench_report as jreport
from hyperscalees_t2i_tpu_torch.tools import bench_report as report

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
BENCH = sorted(str(p) for p in ROOT.glob("BENCH_r0*.json"))
OTHERS = [str(ROOT / n) for n in ("SCALING_r01.json", "SERVE_r01.json", "CAPACITY_r01.json", "QUALITY_r01.json")]


def _both(capsys, argv):
    """(port rc, port text, JAX rc, JAX text) of one command line."""
    rc = report.main(argv)
    out = capsys.readouterr().out
    jrc = jreport.main(argv)
    jout = capsys.readouterr().out
    return rc, out, jrc, jout


def _drop_version_column(text: str) -> str:
    """The trend's first table without its 4th column (the framework's
    version stamp); other tables unchanged."""
    blocks = text.split("\n\n")
    first = blocks[0]
    if first.startswith("| artifact | schema | git sha |"):
        rows = []
        for line in first.splitlines():
            cells = line.split("|")
            rows.append("|".join(cells[:4] + cells[5:]))
        blocks[0] = "\n".join(rows)
    return "\n\n".join(blocks)


@pytest.fixture()
def extra_docs(tmp_path):
    """A calibration document, a rung log (heartbeats and noise between the
    records), and two documents with the knob, fuse/q8 and Pallas fields."""
    calib = tmp_path / "CALIB_r01.json"
    calib.write_text(json.dumps({"mode": "calib", "chip_kind": "NVIDIA H100 80GB HBM3", "rows": [
        {"key": "bench/tiny", "measured_source": "profile", "measured_s": 0.004, "predicted_s": 0.001,
         "error_ratio": 4.0, "mfu_claimed": 0.1, "mfu_measured": 0.12},
        {"key": "bench/mid", "measured_source": "host_wall", "measured_s": 1.5, "predicted_s": None,
         "error_ratio": None, "mfu_claimed": None, "mfu_measured": None}]}))
    log = tmp_path / "rungs.log"
    log.write_text("\n".join([
        '{"hb": "ar", "phase": "build"}', "[bench +  1.0s] noise line",
        json.dumps({"rung": "ar", "geometry": "ar_small", "pop": 16, "imgs_per_sec": 40.0, "step_time_s": 1.6,
                    "chain": 0, "platform": "gpu", "kernel_parity_maxdiff": 0.0078}),
        json.dumps({"rung": "mid", "error": "stalled"})]))
    knobs = dict(remat="blocks", reward_tile=2, noise_dtype="bfloat16", tower_dtype="bfloat16", pop_fuse=True,
                 base_quant="int8")
    q8 = tmp_path / "BENCH_q8.json"
    q8.write_text(json.dumps({"value": 9.0, "platform": "tpu", "schema_version": 4, "jax_version": "0.4.37",
                              "rungs": {"mid": {"rung": "mid", "geometry": "mid", "imgs_per_sec": 9.0,
                                                "step_time_s": 1.7, "physical_floor_s": 0.01, **knobs}}}))
    kern = tmp_path / "BENCH_kern.json"
    kern.write_text(json.dumps({"value": 9.5, "platform": "tpu", "schema_version": 4, "rungs": {"mid": {
        "rung": "mid", "imgs_per_sec": 9.5, **knobs, "fused_qlora": False,
        "pallas_env": {"HSES_FUSED_QLORA_PALLAS": "1", "HSES_USE_PALLAS": "0"},
        "pallas_probes": {"flash": False}}}}))
    port = tmp_path / "BENCH_port.json"
    port.write_text(json.dumps({"value": 14.1, "platform": "gpu", "schema_version": 4, "torch_version": "2.11.0",
                                "git_sha": "abc1234", "rungs": {"flagship": {
                                    "rung": "flagship", "geometry": "flagship", "pop": 4, "imgs_per_sec": 14.1,
                                    "step_time_s": 1.13, "step_time_single_dispatch_s": 1.14, "chain": 2,
                                    "mfu": 0.13, "step_tflops": 147.0, "platform": "gpu", "physical_floor_s": 0.149,
                                    "roofline_bound": "latency", "remat": "none", "reward_tile": 1,
                                    "noise_dtype": "bfloat16", "tower_dtype": "bfloat16", "pop_fuse": True,
                                    "base_quant": "int8", "kernel_launches": {"fused_qlora": 2624}}}}))
    return dict(calib=str(calib), log=str(log), q8=str(q8), kern=str(kern), port=str(port), tmp=tmp_path)


def test_rung_table_equals_jax(capsys, extra_docs):
    for argv in ([*BENCH], [*BENCH, "--log", extra_docs["log"]], [extra_docs["q8"], extra_docs["kern"]],
                 [extra_docs["port"], "--log", extra_docs["log"]]):
        rc, out, jrc, jout = _both(capsys, argv)
        assert rc == jrc == 0 and out == jout, argv
    rc, out, _, _ = _both(capsys, [extra_docs["port"]])
    assert "| flagship | flagship | 4 | none/t1/n-bf16/w-bf16/fuse/q8 | 14.1 | 1.13 | 1.14 | 2 | 0.13 |" in out


def test_empty_inputs_equal_jax(capsys, tmp_path):
    art = tmp_path / "empty.json"
    art.write_text(json.dumps({"rungs": {"tiny": {"rung": "tiny", "error": "x"}}}))
    rc, out, jrc, jout = _both(capsys, [str(art)])
    assert rc == jrc == 1 and out == jout == ""
    assert report.main(["--trend"]) == jreport.main(["--trend"]) == 1


@pytest.mark.parametrize("which", ["bench", "scaling", "serve", "capacity", "quality", "calib", "marks", "all"])
def test_trend_equals_jax_but_the_version_column(capsys, extra_docs, which):
    docs = {"bench": BENCH, "scaling": OTHERS[:1], "serve": OTHERS[1:2], "capacity": OTHERS[2:3],
            "quality": OTHERS[3:4], "calib": [extra_docs["calib"]], "marks": [extra_docs["q8"], extra_docs["kern"]],
            "all": BENCH + OTHERS + [extra_docs["calib"], extra_docs["q8"], extra_docs["port"]]}[which]
    rc, out, jrc, jout = _both(capsys, ["--trend", *docs])
    assert rc == jrc == 0
    assert _drop_version_column(out) == _drop_version_column(jout)
    if out.startswith("| artifact | schema |"):
        assert out.splitlines()[0].startswith("| artifact | schema | git sha | torch | platform |")
        assert jout.splitlines()[0].startswith("| artifact | schema | git sha | jax | platform |")
    if which == "marks":
        assert "9.5 (fuse,q8,uq-,P:flash-,qlora,P!:flash)" in out and "9.0 (fuse,q8)" in out
    if which == "all":
        assert "| BENCH_port.json | 4 | abc1234 | 2.11.0 | gpu | 14.1 |" in out


def test_renderers_equal_jax_on_each_document_kind(extra_docs):
    """Each renderer on its own documents, called directly."""
    load = lambda p: (Path(p).name, report.load_artifact(p))  # noqa: E731
    assert report.render_scaling([load(OTHERS[0])]) == jreport.render_scaling([load(OTHERS[0])])
    assert report.render_serve([load(OTHERS[1])]) == jreport.render_serve([load(OTHERS[1])])
    assert report.render_capacity([load(OTHERS[2])]) == jreport.render_capacity([load(OTHERS[2])])
    assert report.render_quality([load(OTHERS[3])]) == jreport.render_quality([load(OTHERS[3])])
    assert report.render_calib([load(extra_docs["calib"])]) == jreport.render_calib([load(extra_docs["calib"])])
    rungs = report.iter_rungs(BENCH, [extra_docs["log"]])
    assert rungs == jreport.iter_rungs(BENCH, [extra_docs["log"]])
    assert report.render(rungs) == jreport.render(rungs)
    # the wrapper format ({"parsed": ...}) unwraps the same way
    wrapped = extra_docs["tmp"] / "wrapped.json"
    shutil.copy(BENCH[-1], wrapped)
    assert report.load_artifact(str(wrapped)) == jreport.load_artifact(str(wrapped))
