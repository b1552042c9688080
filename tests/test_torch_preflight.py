"""``tools/preflight.py`` of the port on the CPU, at tiny.

The port's preflight measures instead of lowering: it builds the rung and
its ES program as ``run_training`` does (warm-up counted, then captured on
the card). On the CPU the peak is the lower bound ``program_bytes`` gives,
so the verdict needs ``--hbm-gb``.

- The record's counted FLOPs, bytes, ops and kernel calls equal the
  ``programs.jsonl`` record of a ``run_training`` on the same plan.
- Exit codes 0, 1 and 2 through ``main`` with ``--hbm-gb``, and the
  reference's verdict logic on the same peaks (``render_report`` of both
  packages).
- ``--serve`` (``serve.admission.analyze_serve_geometry``: probes at 1 and 2
  lanes, extrapolated) and ``--fleet`` (``train.fleet.analyze_fleet_geometry``
  beside the solo rung).
- An out-of-memory build is a no-fit with the bytes asked for; flags with
  no meaning in the port raise naming why.
- Ported from ``tests/test_preflight.py``: the fit verdict, the no-fit exit,
  non-display target cards, unknown rungs, the report file, ``--base_quant``
  below and above the size floor. Not ported: the abstract-input and
  StableHLO-identity tests (nothing is lowered; the counted-equals-trainer
  test holds the same program instead), ``--devices`` and the update
  isolation (ROADMAP item 7), ``test_int8_dequant_stats_parser`` (an XLA:CPU
  HLO parser).
"""

import dataclasses

import pytest
import torch

from hyperscalees_t2i_tpu.tools import preflight as jpreflight
from hyperscalees_t2i_tpu_torch.obs.program_cost import load_programs
from hyperscalees_t2i_tpu_torch.tools import preflight

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    out = tmp_path_factory.mktemp("preflight")
    rc = preflight.main(["--rungs", "tiny", "--device", "cpu", "--hbm-gb", "80", "--out", str(out)])
    (rec,) = load_programs(out)
    return rc, rec, out


def test_record_counts_equal_run_training(tiny, tmp_path):
    from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_train_backend
    from hyperscalees_t2i_tpu_torch.rungs import rung_opt
    from hyperscalees_t2i_tpu_torch.train.trainer import run_training

    _, rec, _ = tiny
    backend, reward = build_train_backend("tiny", "cpu", seed=0)
    tc = dataclasses.replace(preflight.rung_train_config("tiny", rung_opt("tiny")), num_epochs=1, save_every=0,
                             run_dir=str(tmp_path), run_name="r")
    run_training(backend, reward, tc, device="cpu")
    (train_rec,) = load_programs(tmp_path / "r")
    assert train_rec["label"] == "es_step_m4r1" and rec["label"] == "tiny" and rec["site"] == "preflight"
    for k in ("flops", "bytes_accessed", "counted_ops", "kernels"):
        assert rec[k] == train_rec[k], k
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["peak_bytes"] == rec["base_bytes"] + rec["program_bytes"] > 0
    assert rec["warmup_launches"] == {"int8_matmul": 0, "lora_chain": 0, "fused_qlora": 0, "decode_attention": 0}
    assert rec["geometry"]["pop"] == 4 and rec["imgs_per_step"] == 16


def test_exit_codes_through_main(tiny, monkeypatch, tmp_path, capsys):
    rc, rec, _ = tiny
    assert rc == 0
    monkeypatch.setattr(preflight, "analyze_rung", lambda rung, *a, **kw: {**rec, "rung": rung})
    assert preflight.main(["--rungs", "tiny", "--device", "cpu", "--hbm-gb", "1e-9"]) == 1
    assert "VERDICT: NO-FIT on cpu: tiny" in capsys.readouterr().out
    assert preflight.main(["--rungs", "tiny", "--device", "cpu"]) == 2
    assert "cannot evaluate the fit on cpu for: tiny" in capsys.readouterr().out
    assert preflight.main(["--rungs", "tiny", "--device", "cpu", "--hbm-gb", "80"]) == 0
    assert "VERDICT: all analyzed rungs fit cpu" in capsys.readouterr().out
    # a listed card's capacity needs no --hbm-gb
    assert preflight.main(["--rungs", "tiny", "--device", "cpu", "--chip", H100]) == 0
    report = capsys.readouterr().out
    assert f"Predicted step time on {H100}" in report and "@MFU 0.10" in report


@pytest.mark.parametrize("peak,cap,want", [(1e9, 2e9, 0), (3e9, 2e9, 1), (None, 2e9, 2), (1e9, None, 2)])
def test_verdict_logic_is_the_references(peak, cap, want):
    """The same peak against the same capacity gives the reference's exit
    code (its fit gate reads ``peak_bytes`` when no chip estimate exists)."""
    rec = {"rung": "tiny", "label": "tiny", "geometry": {"scale": "tiny", "pop": 4}, "peak_bytes": peak}
    _, rc = preflight.render_report([rec], "an unlisted card", cap)
    _, jrc = jpreflight.render_report([rec], "an unlisted chip", cap)
    assert rc == jrc == want
    serve = {"label": "serve-tiny-a4", "geometry": {"adapter_batch": 4}, "peak_bytes": peak}
    assert preflight.render_serve_report([serve], "x", cap)[1] == jpreflight.render_serve_report([serve], "x", cap)[1]


def test_fit_verdict_and_report(tiny, tmp_path, monkeypatch, capsys):
    _, rec, out = tiny
    report, rc = preflight.render_report([rec], H100)
    assert rc == 0 and f"VERDICT: all analyzed rungs fit {H100}" in report
    assert "Device-memory fit" in report and "Predicted step time" in report and "tiny" in report
    report, rc = preflight.render_report([rec], H100, hbm_override_bytes=1.0)
    assert rc == 1 and "VERDICT: NO-FIT" in report
    monkeypatch.setattr(preflight, "analyze_rung", lambda rung, *a, **kw: rec)
    path = tmp_path / "sub" / "preflight.txt"
    assert preflight.main(["--rungs", "tiny", "--device", "cpu", "--chip", H100, "--report", str(path)]) == 0
    capsys.readouterr()
    assert "VERDICT" in path.read_text()


def test_verdict_gates_on_non_display_target_cards(tiny):
    _, rec, _ = tiny
    assert preflight.render_report([rec], "NVIDIA H100 PCIe")[1] == 0
    report, rc = preflight.render_report([rec], "NVIDIA A100-SXM4-40GB")
    assert rc == 2 and "cannot evaluate the fit" in report
    assert preflight.render_report([rec], "NVIDIA A100-SXM4-40GB", hbm_override_bytes=40e9)[1] == 0


def test_main_rejects_unknown_rungs(capsys):
    assert preflight.main(["--rungs", "nonesuch", "--device", "cpu"]) == 2
    assert "unknown rungs" in capsys.readouterr().err
    assert preflight.main(["--rungs", "ar_d16", "--device", "cpu"]) == 2


@pytest.mark.parametrize("argv,why", [(["--devices", "2"], "item 7"), (["--pop_shard_update", "on"], "item 7"),
                                      (["--remat", "blocks"], "differentiates nothing"),
                                      (["--fused_qlora", "off"], "fused kernel"), (["--chip", "v5e"], "TPU")])
def test_flags_without_meaning_raise(argv, why):
    with pytest.raises(NotImplementedError, match=why):
        preflight.main(["--rungs", "tiny", "--device", "cpu", *argv])


def test_out_of_memory_is_a_no_fit(monkeypatch):
    from hyperscalees_t2i_tpu_torch.backends import sana_backend

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 MiB. GPU 0 has a total "
                                          "capacity of 79.19 GiB of which 3.06 MiB is free.")

    monkeypatch.setattr(sana_backend, "build_train_backend", oom)
    rec = preflight.analyze_rung("tiny", "cpu")
    assert rec["oom"] and rec["oom_requested_bytes"] == 20 * 2**20 and "peak_bytes" not in rec
    report, rc = preflight.render_report([rec], H100)
    assert rc == 1 and "tiny (out of memory on the card, asked for 0.021 GB more)" in report


@pytest.mark.parametrize("floor,engaged", [(None, False), ("512", True)])
def test_base_quant_below_and_above_the_floor(tiny, monkeypatch, floor, engaged):
    """Below the size floor ``--base_quant int8`` quantizes nothing: the same
    counted program; with the floor lowered the int8 sites run K1's
    wrapper."""
    _, rec, _ = tiny
    if floor:
        monkeypatch.setenv("HSES_BASE_QUANT_MIN_SIZE", floor)
    q8 = preflight.analyze_rung("tiny", "cpu", opt_override={"base_quant": "int8"})
    assert q8["geometry"]["base_quant"] == "int8"
    calls = q8["kernels"].get("int8_matmul", {}).get("calls", 0)
    if engaged:
        assert calls > 0 and q8["kernels"] != rec["kernels"]
    else:
        assert calls == 0 and (q8["flops"], q8["bytes_accessed"]) == (rec["flops"], rec["bytes_accessed"])


def test_serve_mode(tmp_path, capsys):
    from hyperscalees_t2i_tpu_torch.serve.admission import extrapolate

    assert preflight.main(["--serve", "tiny:4", "--device", "cpu", "--out", str(tmp_path)]) == 2
    assert "cannot evaluate serve fit" in capsys.readouterr().out
    (rec,) = load_programs(tmp_path)
    assert rec["site"] == "serve" and rec["label"] == "serve-tiny-a4"
    probes = {int(k): v for k, v in rec["probe_bytes"].items()}
    assert sorted(probes) == [1, 2] and rec["program_bytes"] == extrapolate(probes, 4)
    assert rec["peak_bytes"] == rec["base_bytes"] + rec["program_bytes"]
    report, rc = preflight.render_serve_report([rec], H100)
    assert rc == 0 and "ADMITTED" in report
    assert preflight.render_serve_report([rec], H100, hbm_override_bytes=1.0)[1] == 1
    assert preflight.main(["--serve", "tiny", "--device", "cpu"]) == 2


def test_fleet_mode(tmp_path, capsys):
    assert preflight.main(["--fleet", "tiny:2", "--device", "cpu", "--hbm-gb", "80", "--out", str(tmp_path)]) == 0
    report = capsys.readouterr().out
    assert "fleet-tiny-j2" in report and "VERDICT: all fleet geometries ADMITTED" in report
    recs = load_programs(tmp_path)
    assert [r["site"] for r in recs] == ["preflight", "fleet"]
    solo, fleet = recs
    assert fleet["fleet_width"] == 2 and fleet["peak_bytes"] == fleet["base_bytes"] + fleet["program_bytes"]
    assert preflight.render_fleet_report([(fleet, solo)], H100, hbm_override_bytes=1.0)[1] == 1
    assert preflight.main(["--fleet", "tiny", "--device", "cpu"]) == 2


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preflight.main(["--rungs", "tiny"])
