"""The port's window queue (``hyperscalees_t2i_tpu_torch/tools/window.py``)
held to the JAX window's behaviour, the counterparts of
``tests/test_window.py``: the budgeted queue runs items in priority order
and skips what no longer fits; a window stopped mid-queue resumes from
``window_state.json`` running only the items left, the finished ones'
artifacts and timestamps kept; the ``WINDOW_r*.json`` rollup has one schema
whether or not the run was interrupted; the profiled item's post-hook
reconciles a ``torch.profiler`` trace into ``CALIB_r01.json``. Plans are
injected with ``--plan`` as cheap Python children; the parent imports no
torch."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import torch

from hyperscalees_t2i_tpu.tools import window as jwindow
from hyperscalees_t2i_tpu_torch.tools import window

torch.set_num_threads(1)


def _item(name, out_dir, *, est_s=5, sleep=0.0, artifact_body=None,
          rc=0, **extra):
    """A cheap plan item: a python child that sleeps then writes its
    artifact (the real items are bench/preflight children; the runner
    only cares about rc + artifact)."""
    art = str(Path(out_dir) / f"{name}.json")
    body = json.dumps(artifact_body if artifact_body is not None
                      else {"item": name})
    code = (
        f"import json,sys,time\n"
        f"time.sleep({sleep})\n"
        f"open({art!r}, 'w').write({body!r})\n"
        f"sys.exit({rc})\n"
    )
    return {"name": name, "est_s": est_s,
            "argv": [sys.executable, "-c", code], "artifact": art, **extra}


def write_plan(tmp_path, items):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(items))
    return str(plan)


def run_main(out_dir, plan, budget_s=600, extra=()):
    return window.main([
        "--budget_s", str(budget_s), "--out_dir", str(out_dir),
        "--plan", plan, "--round", "1", "--no_sentry", *extra,
    ])


def test_queue_runs_in_order_and_writes_rollup(tmp_path):
    out = tmp_path / "w"
    out.mkdir()
    plan = write_plan(tmp_path, [_item("a", out), _item("b", out)])
    assert run_main(out, plan) == 0
    state = json.loads((out / "window_state.json").read_text())
    assert [i["status"] for i in state["items"]] == ["completed"] * 2
    # priority order is execution order
    assert state["items"][0]["t_end"] <= state["items"][1]["t_start"]
    roll = json.loads((out / "WINDOW_r01.json").read_text())
    assert roll["mode"] == "window" and roll["schema_version"] == 1
    assert roll["completed"] == ["a", "b"]
    assert roll["incarnations"] == 1
    assert (out / "a.json").exists() and (out / "b.json").exists()


def test_budget_skip_is_loud_and_ordered(tmp_path):
    out = tmp_path / "w"
    out.mkdir()
    # budget 10s: a (est 5) fits, big (est 500) must be SKIPPED without
    # starting, c (est 4) still fits — the skip frees budget for later items
    plan = write_plan(tmp_path, [
        _item("a", out, est_s=5), _item("big", out, est_s=500),
        _item("c", out, est_s=4)])
    assert run_main(out, plan, budget_s=10) == 0
    state = json.loads((out / "window_state.json").read_text())
    by = {i["name"]: i for i in state["items"]}
    assert by["a"]["status"] == "completed"
    assert by["big"]["status"] == "skipped_budget"
    assert "500" in by["big"]["skip_reason"]
    assert by["big"]["t_start"] is None  # never started
    assert not (out / "big.json").exists()
    assert by["c"]["status"] == "completed"
    roll = json.loads((out / "WINDOW_r01.json").read_text())
    assert roll["skipped"] == ["big"]


def test_failed_child_recorded_and_rc_nonzero(tmp_path):
    out = tmp_path / "w"
    out.mkdir()
    plan = write_plan(tmp_path, [
        _item("bad", out, rc=3), _item("good", out)])
    assert run_main(out, plan) == 1
    state = json.loads((out / "window_state.json").read_text())
    by = {i["name"]: i for i in state["items"]}
    assert by["bad"]["status"] == "failed" and by["bad"]["rc"] == 3
    # one failure does not strand the rest of the window
    assert by["good"]["status"] == "completed"
    roll = json.loads((out / "WINDOW_r01.json").read_text())
    assert roll["failed"] == ["bad"]


def test_kill_mid_queue_then_resume_runs_only_remaining(tmp_path):
    out = tmp_path / "w"
    out.mkdir()
    items = [_item("fast", out),
             _item("slow", out, sleep=60, est_s=90),
             _item("tail", out)]
    plan = write_plan(tmp_path, items)
    # first incarnation as a real subprocess, SIGTERMed while "slow" runs
    proc = subprocess.Popen(
        [sys.executable, "-m", "hyperscalees_t2i_tpu_torch.tools.window",
         "--budget_s", "600", "--out_dir", str(out), "--plan", plan,
         "--round", "1", "--no_sentry"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=str(Path(window.__file__).resolve().parents[2]),
    )
    deadline = time.monotonic() + 60
    state_path = out / "window_state.json"
    while time.monotonic() < deadline:
        if state_path.exists():
            try:
                st = json.loads(state_path.read_text())
            except json.JSONDecodeError:
                st = None  # mid-replace; atomic writer makes this rare
            if st and st["items"][1]["status"] == "running":
                break
        time.sleep(0.1)
    else:
        proc.kill()
        pytest.fail(f"window never reached item 'slow': {proc.stderr.read()}")
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=60)
    assert rc == window.EXIT_INTERRUPTED
    st = json.loads(state_path.read_text())
    assert st["items"][0]["status"] == "completed"
    assert st["items"][1]["status"] == "interrupted"
    assert st["items"][2]["status"] == "pending"
    assert not (out / "WINDOW_r01.json").exists()  # no rollup mid-window
    fast_t = (st["items"][0]["t_start"], st["items"][0]["t_end"])

    # resume: same command → only slow (now instant) + tail run
    items[1] = _item("slow", out, sleep=0.0, est_s=90)
    plan = write_plan(tmp_path, items)
    assert run_main(out, plan) == 0
    st2 = json.loads(state_path.read_text())
    assert st2["incarnations"] == 2
    assert [i["status"] for i in st2["items"]] == ["completed"] * 3
    # the completed item was NOT re-run: timestamps byte-identical
    assert (st2["items"][0]["t_start"], st2["items"][0]["t_end"]) == fast_t
    # ...and the re-run items' start times postdate the interruption
    assert st2["items"][1]["t_start"] > fast_t[1]
    roll = json.loads((out / "WINDOW_r01.json").read_text())
    assert roll["completed"] == ["fast", "slow", "tail"]
    assert roll["incarnations"] == 2


def test_group_sigterm_marks_item_interrupted_not_failed(tmp_path):
    # timeout(1), interactive shells, and k8s deliver TERM to the whole
    # process GROUP — the window's child dies of the signal before the
    # parent's handler wins the poll race. The item must land as
    # "interrupted" (resume re-runs it), never "failed rc=-15".
    out = tmp_path / "w"
    out.mkdir()
    plan = write_plan(tmp_path, [_item("slow", out, sleep=60, est_s=90)])
    proc = subprocess.Popen(
        [sys.executable, "-m", "hyperscalees_t2i_tpu_torch.tools.window",
         "--budget_s", "600", "--out_dir", str(out), "--plan", plan,
         "--round", "1", "--no_sentry"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=str(Path(window.__file__).resolve().parents[2]),
        start_new_session=True,  # its own group, so killpg spares pytest
    )
    deadline = time.monotonic() + 60
    state_path = out / "window_state.json"
    while time.monotonic() < deadline:
        if state_path.exists():
            try:
                st = json.loads(state_path.read_text())
            except json.JSONDecodeError:
                st = None
            if st and st["items"][0]["status"] == "running":
                break
        time.sleep(0.1)
    else:
        proc.kill()
        pytest.fail(f"window never started 'slow': {proc.stderr.read()}")
    os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
    rc = proc.wait(timeout=60)
    assert rc == window.EXIT_INTERRUPTED
    st = json.loads(state_path.read_text())
    assert st["items"][0]["status"] == "interrupted", st["items"][0]
    assert st["items"][0]["rc"] is None


def test_rollup_schema_identical_resumed_or_not(tmp_path):
    # straight-through window with the same plan names as a resumed one →
    # identical key set (the promise that dashboards never special-case)
    out = tmp_path / "w"
    out.mkdir()
    plan = write_plan(tmp_path, [_item("a", out)])
    assert run_main(out, plan) == 0
    roll = json.loads((out / "WINDOW_r01.json").read_text())
    expect = {"mode", "schema_version", "window_id", "round", "budget_s",
              "spent_s", "incarnations", "items", "completed", "skipped",
              "failed", "calib", "sentry_worst_rc", "ts", "torch_version",
              "git_sha", "device_name", "power_limit"}
    assert set(roll.keys()) == expect
    # the JAX rollup's keys, its version stamp apart, and the card's stamp
    assert expect - {"torch_version", "device_name", "power_limit"} | {"jax_version"} == \
        expect - set(window._stamp()) | set(jwindow._stamp())
    item_keys = set(roll["items"][0].keys())
    for k in ("status", "rc", "t_start", "t_end", "duration_s",
              "sentry_rc", "calib_artifact"):
        assert k in item_keys


def test_plan_mismatch_refuses_to_inherit_state(tmp_path):
    out = tmp_path / "w"
    out.mkdir()
    plan = write_plan(tmp_path, [_item("a", out)])
    assert run_main(out, plan) == 0
    other = write_plan(tmp_path, [_item("different", out)])
    with pytest.raises(SystemExit):
        run_main(out, other)
    # --fresh discards the old state instead
    assert run_main(out, other, extra=("--fresh",)) == 0


def test_profiled_item_post_hook_writes_calib(tmp_path):
    # a completed "profiled" item triggers the in-process reconciliation:
    # the ledger + a torch.profiler trace with the rung's bench/<rung>
    # range in out_dir -> CALIB_r01.json, and the rollup embeds the payload
    from hyperscalees_t2i_tpu_torch.obs import profile_trace

    out = tmp_path / "w"
    out.mkdir()
    with (out / "programs.jsonl").open("w") as f:
        f.write(json.dumps({
            "site": "bench", "label": "tiny", "flops": 1e12,
            "bytes_accessed": 2e9, "device_kind": "NVIDIA H100 80GB HBM3",
            "n_devices": 1}) + "\n")
    prof = out / "profile" / "tiny"
    prof.mkdir(parents=True)
    (prof / "bench.pt.trace.json").write_text(profile_trace.build_trace({
        "ranges": [{"name": "bench/tiny", "ts": 0, "dur": 5000}],
        "kernels": [{"name": "qlora_mma_kernel", "ts": 100, "dur": 4000}]}))
    plan = write_plan(tmp_path, [_item(
        "profiled", out, post="calib",
        artifact_body={"rung": "tiny", "step_time_s": 0.005})])
    assert run_main(out, plan) == 0
    cal = json.loads((out / "CALIB_r01.json").read_text())
    assert cal["mode"] == "calib"
    (row,) = cal["rows"]
    assert row["measured_source"] == "profile" and row["key"] == "bench/tiny"
    assert row["measured_s"] == pytest.approx(0.004)
    roll = json.loads((out / "WINDOW_r01.json").read_text())
    assert roll["calib"]["headline"]["rows"] == 1
    assert roll["items"][0]["calib_artifact"].endswith("CALIB_r01.json")


def test_default_plan_covers_the_ladder(tmp_path):
    """The JAX queue less ``cache_warm`` (no program cache to warm), each
    item a command of the port, on the card unless a device is named."""
    names = [p["name"] for p in window.default_plan(tmp_path, ["tiny", "small"])]
    jnames = [p["name"] for p in jwindow.default_plan(tmp_path, ["tiny", "small"], "v5e")]
    assert names == [n for n in jnames if n != "cache_warm"]
    assert names == ["preflight", "bench_ladder", "scaling", "dispatch_tax", "profiled", "capacity"]
    for p in window.default_plan(tmp_path, ["tiny"], device="cpu"):
        assert p["est_s"] > 0 and p["argv"] and p["artifact"]
        assert p["argv"][1:3] == ["-m", p["argv"][2]] and p["argv"][2].startswith("hyperscalees_t2i_tpu_torch.tools.")
        assert p["argv"][-2:] == ["--device", "cpu"]
    out = subprocess.run([sys.executable, "-c", "import sys; import hyperscalees_t2i_tpu_torch.tools.window; "
                          "print('torch' in sys.modules)"], cwd=str(Path(window.__file__).resolve().parents[2]),
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "False", out.stderr
