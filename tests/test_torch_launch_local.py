"""Two processes training through ``tools.launch_local`` on the CPU, against
the port's one-process run and the JAX CLI.

The tiny Sana rung (``--model_scale tiny --device cpu``), population 4,
``member_batch`` 2 (it divides each process's slice of 2), 2 epochs, a slot
every epoch, traced. Three launches run at once: two processes with
``--pop_shard_update off``, two with ``on``, and one process; the JAX CLI
runs the same command line meanwhile.

- ``off``: θ′ after 2 epochs bitwise the one-process θ′ (the same chunks,
  the same update from the same gathered rows); ``on``: within 3e-4 of it
  (the partial sums' order); both within 3e-4 of the JAX CLI's θ′ for the
  same command line (measured in the test's output).
- Only process 0 writes ``metrics.jsonl`` (two rows, each saying
  ``process_count`` 2), ``quality.jsonl``, ``programs.jsonl`` (the eval
  slice and the update programs) and the slots; each process writes its
  trace segment (``trace.jsonl``, ``trace.1.jsonl``) and its
  ``resilience.host<i>.json``.
- The two-process slot resumed by one process raises the topology
  mismatch, as the JAX store's check does on the same slot.
- The launcher itself on stand-in children (a few lines of Python):
  ``[p<i>]`` prefixes and the launch flags, a failed child's code,
  ``--kill_host``, ``--grace_s``, the relaunch with ``HYPERSCALEES_FAULTS``
  cleared.
- ``die_with_parent``: a child dies when the process that started it ends,
  and leaves at once when that process had already gone.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.resilience.checkpoints import CheckpointStore as JStore
from hyperscalees_t2i_tpu.resilience.checkpoints import TopologyMismatch as JTopologyMismatch
from hyperscalees_t2i_tpu.train import cli as jcli
from hyperscalees_t2i_tpu_torch.resilience.checkpoints import TopologyMismatch
from hyperscalees_t2i_tpu_torch.tools import launch_local
from hyperscalees_t2i_tpu_torch.train import cli
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
ARGV = ["--backend", "sana_one_step", "--model_scale", "tiny", "--num_epochs", "2", "--allow_random_rewards",
        "true", "--pop_size", "4", "--prompts_per_gen", "2", "--member_batch", "2", "--save_every", "1",
        "--run_name", "cli", "--resume", "false", "--trace", "true"]
SLOT = "cli/ckpt/step_00000002/theta.npz"
LAUNCHES = {"p2_off": (2, ["--pop_shard_update", "off"]), "p2_on": (2, ["--pop_shard_update", "on"]),
            "p1": (1, [])}


def _theta(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The three launches at once (each child on one thread), and the JAX
    CLI on the same command line in this process meanwhile."""
    root = tmp_path_factory.mktemp("launch")
    rcs = {}

    def run(name, n, extra):
        rcs[name] = launch_local.run_pod(n, [*ARGV, "--device", "cpu", "--run_dir", str(root / name), *extra],
                                         timeout_s=110)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        threads = [threading.Thread(target=run, args=(name, n, extra)) for name, (n, extra) in LAUNCHES.items()]
        for t in threads:
            t.start()
        try:
            jcli.main([*ARGV, "--run_dir", str(root / "jax")])
        finally:
            for t in threads:
                t.join(timeout=150)
    assert all(not t.is_alive() for t in threads)
    assert rcs == {name: 0 for name in LAUNCHES}, rcs
    return root


def test_two_processes_train_as_one(launches):
    one = _theta(launches / "p1" / SLOT)
    off, on = _theta(launches / "p2_off" / SLOT), _theta(launches / "p2_on" / SLOT)
    assert set(off) == set(on) == set(one)
    for k in one:
        assert off[k].tobytes() == one[k].tobytes(), k  # the replicated update: bitwise
        np.testing.assert_allclose(on[k], one[k], err_msg=k, **TOL)
    print(f"pop_shard_update on against one process: max abs {max(np.abs(on[k] - one[k]).max() for k in one):.3g}")


def test_two_processes_match_the_jax_cli(launches):
    ref = _theta(launches / "jax" / SLOT)
    worst = 0.0
    for name in ("p2_off", "p2_on"):
        got = _theta(launches / name / SLOT)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], err_msg=f"{name} {k}", **TOL)
            worst = max(worst, float(np.abs(got[k] - ref[k]).max()))
    print(f"two processes against the JAX CLI: max abs {worst:.3g}")


@pytest.mark.parametrize("name, update_labels", [("p2_off", ["es_update_m1r1"]),
                                                  ("p2_on", ["es_update_partial_m1r1", "es_update_apply_m1r1"])])
def test_process_zero_writes_the_shared_files_and_each_its_own(launches, name, update_labels):
    run = launches / name / "cli"
    rows = read_jsonl_rows(run / "metrics.jsonl")
    assert [r["epoch"] for r in rows] == [0, 1] and all(r["process_count"] == 2 for r in rows)
    assert len(read_jsonl_rows(run / "quality.jsonl")) == 2
    assert [r["label"] for r in read_jsonl_rows(run / "programs.jsonl")] == ["es_eval_slice_m1r1", *update_labels]
    manifest = json.loads((run / "ckpt/step_00000002/manifest.json").read_text())
    assert manifest["topology"] == {"process_count": 2, "pop_shards": 1, "pop_size": 4, "pop_host_shard": True}
    for rank in (0, 1):
        seg = run / ("trace.jsonl" if rank == 0 else "trace.1.jsonl")
        lines = [json.loads(line) for line in seg.read_text().splitlines()]
        assert {ln["process_index"] for ln in lines} == {rank}
        assert sum(ln.get("name") == "epoch" for ln in lines) == 2
        snap = json.loads((run / f"resilience.host{rank}.json").read_text())
        assert snap["process_index"] == rank and snap["epoch"] == 2 and snap["preempted"] is False
    assert sorted(p.name for p in run.glob("trace*.jsonl")) == ["trace.1.jsonl", "trace.jsonl"]


def test_a_two_process_slot_resumed_alone_raises(launches, capsys):
    run_dir = launches / "p2_off"
    argv = [*ARGV, "--device", "cpu", "--run_dir", str(run_dir), "--resume", "true", "--num_epochs", "3"]
    with pytest.raises(TopologyMismatch, match=r"process_count=2 but this launch has process_count=1"):
        cli.main(argv)
    one = {"process_count": 1, "pop_shards": 1, "pop_size": 4, "pop_host_shard": False}
    with pytest.raises(JTopologyMismatch, match="process_count"):
        JStore(run_dir / "cli").restore({k: v for k, v in _theta(run_dir / SLOT).items()},
                                        expect_topology=one)


_CHILD = r"""
import os, sys, time
args = sys.argv[1:]
rank = int(args[args.index("--process_id") + 1])
print("faults=" + os.environ.get("HYPERSCALEES_FAULTS", "-"), " ".join(args), flush=True)
plan = dict(a.split("=") for a in args if "=" in a)
time.sleep(float(plan.get(f"sleep{rank}", "0")))
print("done", flush=True)
sys.exit(int(plan.get(f"exit{rank}", "0")))
"""


def _pod(capfd, n, fwd, **kw):
    rc = launch_local.run_pod(n, fwd, entry=["-c", _CHILD], timeout_s=30, **kw)
    return rc, capfd.readouterr().err


def test_launcher_prefixes_and_statuses(capfd, monkeypatch):
    monkeypatch.setenv("HYPERSCALEES_FAULTS", "die@3")
    rc, err = _pod(capfd, 2, ["x=1"], port=45678)
    assert rc == 0
    for r in (0, 1):
        assert f"[p{r}] faults=die@3 --coordinator 127.0.0.1:45678 --num_processes 2 --process_id {r} x=1" in err
        assert f"[p{r}] done" in err
    rc, err = _pod(capfd, 2, ["exit1=3"], clear_faults=True)
    assert rc == 3 and "[p0] faults=-" in err
    # a hard kill (128 + SIGKILL) stops the launch: the survivor's SIGTERM
    # (128 + 15) is the highest signal death
    rc, err = _pod(capfd, 2, ["sleep0=20", "sleep1=20"], kill_host=1, kill_after_s=0.5)
    assert rc == 143 and "KILL: SIGKILL host 1" in err and "[p0] done" not in err
    # the grace window lets the survivor finish on its own
    rc, err = _pod(capfd, 2, ["exit0=5", "sleep1=1"], grace_s=10)
    assert rc == 5 and "[p1] done" in err


def test_relaunch_clears_the_faults_and_appends_its_args(monkeypatch):
    calls = []
    monkeypatch.setattr(launch_local, "run_pod", lambda n, fwd, **kw: calls.append((n, fwd, kw)) or 7)
    assert launch_local.main(["--num_processes", "3", "--relaunch_num_processes", "2", "--relaunch_args",
                              "--resume true", "--", "--pop_size", "6"]) == 7
    assert [(n, fwd, kw.get("clear_faults", False)) for n, fwd, kw in calls] == [
        (3, ["--pop_size", "6"], False), (2, ["--pop_size", "6", "--resume", "true"], True)]


ROOT = Path(__file__).resolve().parents[1]
_GUARDED = ("import sys, time; from hyperscalees_t2i_tpu_torch.tools.launch_local import die_with_parent; "
            "die_with_parent({parent}); print('up', flush=True); time.sleep(60)")
# a parent that starts a guarded child, prints its pid and leaves it asleep
_PARENT = ("import os, subprocess, sys; code = sys.argv[1].format(parent=os.getpid()); "
           "child = subprocess.Popen([sys.executable, '-c', code], stdout=subprocess.PIPE, text=True); "
           "assert child.stdout.readline().strip() == 'up'; print(child.pid, flush=True)")


def _alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError):
        return False
    return state not in ("Z", "X")


def test_die_with_parent_dies_with_the_parent():
    out = subprocess.run([sys.executable, "-c", _PARENT, _GUARDED], cwd=ROOT, capture_output=True, text=True,
                         timeout=60, check=True)
    pid = int(out.stdout.split()[-1])
    deadline = time.monotonic() + 20
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(pid)


def test_die_with_parent_leaves_if_the_parent_is_gone():
    # pid 1 is never this child's parent: the child leaves before its work
    out = subprocess.run([sys.executable, "-c", _GUARDED.format(parent=1)], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 1 and "up" not in out.stdout
    out = subprocess.run([sys.executable, "-c", _GUARDED.replace("time.sleep(60)", "pass").format(
        parent=os.getpid())], cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "up"
