"""Two processes under injected faults on the CPU, port against itself: the
two-phase commit, the preemption broadcast, the torn write and the
non-finite rollback across processes (the scenarios of the JAX slow-tier
``tests/test_multihost_resilience.py``; launches in ``tests/_torch_chaos.py``,
run at once).

- ``straight``: two processes, 3 epochs. Every boundary committed by a
  unanimous vote (``ckpt_commits`` 3 in both host snapshots), both stores
  (``ckpt/``, ``ckpt.host1/``) holding bitwise-equal slots with equal
  digests, ``resilience/desync`` 0 with the check every epoch.
- ``preempt@0:host1``: host 1's request rides the epoch-0 gather; both
  processes save slot 1 and exit 0; the resumed launch ends bitwise the
  straight launch.
- ``torn_write@2:host1`` at the last boundary of a 2-epoch launch: host 1's
  read-back fails, the vote refuses, slot 2 is invalidated in both stores
  and ``latest`` stays at slot 1 in both; the resumed launch (3 epochs)
  restores slot 1 and ends bitwise the straight launch.
- ``nan_theta@1:host1``: host 1's θ alone turns NaN; the gathered verdict
  rolls both processes back to slot 1 (σ halved, ``rollbacks`` 1 in both
  snapshots) and both end with the same θ.
"""

import json

import pytest
import torch

from _torch_chaos import assert_bitwise, invalid, latest, launch, run_all, slot, snapshot

torch.set_num_threads(1)


def _after_first(run):
    """What the first launch left: each store's ``latest`` and each host's
    counters (the resumed launch writes both anew)."""
    return {rank: (latest(run, "ckpt" if rank == 0 else "ckpt.host1"),
                   {k: v for k, v in snapshot(run, rank).items() if k.startswith("resilience/ckpt")})
            for rank in (0, 1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("chaos_commit")
    jobs = {
        "straight": lambda: launch(root, "straight", 2, "--num_epochs", "3"),
        "preempt": lambda: (launch(root, "preempt", 2, "--num_epochs", "3", "--faults", "preempt@0:host1"),
                            launch(root, "preempt", 2, "--num_epochs", "3", "--resume", "true")),
        "torn": lambda: (launch(root, "torn", 2, "--num_epochs", "2", "--faults", "torn_write@2:host1"),
                         _after_first(root / "torn"),
                         launch(root, "torn", 2, "--num_epochs", "3", "--resume", "true")),
        "nan": lambda: launch(root, "nan", 2, "--num_epochs", "3", "--faults", "nan_theta@1:host1"),
    }
    # a deadline that a healthy launch never meets, far below the test's own
    out = run_all(root, jobs, {"HYPERSCALEES_KV_TIMEOUT_MS": "60000"})
    return root, out


def test_straight_launch_commits_every_slot_unanimously(runs):
    root, out = runs
    assert out["straight"] == 0, out["straight"]
    run = root / "straight"
    for e in (1, 2, 3):
        assert_bitwise(slot(run, e), slot(run, e, "ckpt.host1"), f"slot {e}")
        m0, m1 = (json.loads((run / s / f"step_{e:08d}/manifest.json").read_text()) for s in ("ckpt", "ckpt.host1"))
        assert {k: v["sha256"] for k, v in m0["arrays"].items()} == {k: v["sha256"] for k, v in m1["arrays"].items()}
    assert latest(run) == latest(run, "ckpt.host1") == "step_00000003"
    for rank in (0, 1):
        snap = snapshot(run, rank)
        assert snap["resilience/ckpt_commits"] == 3 and snap.get("resilience/desync", 0) == 0
        assert "resilience/ckpt_commit_failed" not in snap
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1, 2] and all(r.get("resilience/desync", 0) == 0 for r in rows)


def test_preempt_on_one_host_stops_both_and_resumes_bitwise(runs):
    root, out = runs
    assert out["preempt"] == (0, 0), out["preempt"]
    run = root / "preempt"
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    # the request reached process 0 through the epoch-0 gather; the resumed
    # launch (incarnation 1) cleared the marker and ran epochs 1-2
    assert [(r["epoch"], r["incarnation"]) for r in rows] == [(0, 0), (1, 1), (2, 1)]
    assert rows[0]["resilience/preempt_requests"] == 1
    assert not (run / "preempted.json").exists()
    assert_bitwise(slot(run, 1), slot(run, 1, "ckpt.host1"), "the preemption slot on both stores")
    assert_bitwise(slot(run, 3), slot(root / "straight", 3), "resumed against straight")
    assert_bitwise(slot(run, 3, name="delta.npz"), slot(root / "straight", 3, name="delta.npz"), "Δθ")


def test_torn_write_on_one_host_is_refused_everywhere_then_resumed(runs):
    root, out = runs
    rc1, first, rc2 = out["torn"]
    assert (rc1, rc2) == (0, 0), out["torn"]
    run = root / "torn"
    # the first launch: slot 1 committed, slot 2 refused on both processes
    assert first == {r: ("step_00000001", {"resilience/ckpt_commits": 1, "resilience/ckpt_commit_failed": 1})
                     for r in (0, 1)}
    for store in ("ckpt", "ckpt.host1"):
        assert invalid(run, store) == [".invalid-step_00000002"], store
    log = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in log if r["incarnation"] == 0] == [0, 1]
    resumed = [r for r in log if r["incarnation"] == 1]
    assert [r["epoch"] for r in resumed] == [1, 2]
    assert_bitwise(slot(run, 3), slot(root / "straight", 3), "resumed from slot 1 against straight")
    assert_bitwise(slot(run, 3, "ckpt.host1"), slot(root / "straight", 3), "host 1's store")


def test_nan_theta_on_one_host_rolls_every_host_back(runs):
    root, out = runs
    assert out["nan"] == 0, out["nan"]
    run = root / "nan"
    for rank in (0, 1):
        snap = snapshot(run, rank)
        assert snap["rollbacks"] == 1 and snap["resilience/rollbacks"] == 1 and not snap["halted"]
    assert snapshot(run, 1)["resilience/faults_injected"] == 1 and "resilience/faults_injected" not in snapshot(run, 0)
    assert_bitwise(slot(run, 3), slot(run, 3, "ckpt.host1"), "both hosts after the rollback")
    cfg = json.loads((run / "ckpt/step_00000003/manifest.json").read_text())["config"]
    assert cfg["sigma"] == 0.005 and cfg["_rollbacks"] == 1
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1, 1, 2]
