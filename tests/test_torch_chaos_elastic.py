"""Two processes under injected faults on the CPU, port against itself: the
desync check with its coordinated rollback, a hard death with either
elastic action, and reshard-on-restore (the JAX slow-tier
``tests/test_multihost_resilience.py`` scenarios and elastic
``continue``; launches in ``tests/_torch_chaos.py``, run at once, the
store's deadline 10 s so that a death is found in seconds).

- ``p1``: one process, ``--pop_host_shard on``, 3 epochs: the reference
  (two processes with ``--pop_shard_update off`` are bitwise one process).
- ``desync@1:host1``: host 1's θ forks after epoch 1's gather. The commit
  at boundary 2 refuses the digest fork (slot 2 invalidated in both
  stores), the fingerprint check at epoch 2 (one interval) disagrees on
  both processes (``resilience/desync`` 1), both restore slot 1 and replay
  epochs 1-2 with the same σ; the final θ is bitwise ``p1``'s.
- ``die@1:host1`` with ``checkpoint_exit``: host 1 exits hard; host 0's
  commit vote at boundary 2 times out, the roll-call's verdict is ``[0]``
  (``elastic.json``), host 0 commits slot 2 alone and exits 0. The
  relaunch as one process with ``--on_topology_mismatch reshard`` restores
  it (a ``reshard_restore`` transition) and its epoch-2 row, slot and θ are
  bitwise ``p1``'s.
- ``die@1:host1`` with ``continue`` (the pop-sharded update before the
  death): host 0 adopts host 1's members from the last ratified slot (slot
  1; the unratified slot 2 is rejected), its programs built again for
  members 0-3 with the replicated update, and finishes; its θ is bitwise
  one process resumed from that slot with ``reshard``.
"""

import json
import shutil

import pytest
import torch

from _torch_chaos import assert_bitwise, invalid, latest, launch, rows_equal, run_all, slot, snapshot

torch.set_num_threads(1)
ONE = ("--pop_host_shard", "on")
RELAUNCH = ("--resume", "true", "--on_topology_mismatch", "reshard", *ONE)


def _continue_reference(root):
    """One process from the continue launch's ratified slot, once that
    launch has ended."""
    src, dst = root / "cont" / "ckpt", root / "cont_ref" / "ckpt"
    dst.mkdir(parents=True)
    shutil.copytree(src / "step_00000001", dst / "step_00000001")
    (dst / "latest").write_text("step_00000001\n")
    return launch(root, "cont_ref", 1, "--num_epochs", "3", *RELAUNCH)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("chaos_elastic")
    jobs = {
        "p1": lambda: launch(root, "p1", 1, "--num_epochs", "3", *ONE),
        "desync": lambda: launch(root, "desync", 2, "--num_epochs", "3", "--pop_shard_update", "off", "--faults",
                                 "desync@1:host1"),
        "die": lambda: (launch(root, "die", 2, "--num_epochs", "3", "--pop_shard_update", "off", "--faults",
                               "die@1:host1", grace_s=120),
                        launch(root, "die", 1, "--num_epochs", "3", *RELAUNCH)),
        "cont": lambda: (launch(root, "cont", 2, "--num_epochs", "3", "--elastic_action", "continue", "--faults",
                                "die@1:host1", grace_s=120),
                         _continue_reference(root)),
    }
    env = {"HYPERSCALEES_KV_TIMEOUT_MS": "10000", "HYPERSCALEES_KV_PROBE_MS": "200",
           "HYPERSCALEES_ELASTIC_ROLLCALL_MS": "2000"}
    return root, run_all(root, jobs, env)


def _rows(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def test_desync_is_caught_within_one_interval_and_rolled_back_bitwise(runs):
    root, out = runs
    assert out["desync"] == 0 and out["p1"] == 0, out
    run = root / "desync"
    for rank in (0, 1):
        snap = snapshot(run, rank)
        assert snap["resilience/desync"] == 1 and snap["resilience/rollbacks"] == 1
        assert snap["resilience/ckpt_commit_failed"] == 1 and not snap["halted"]
    for store in ("ckpt", "ckpt.host1"):
        assert invalid(run, store) == [".invalid-step_00000002"], store
    rows = _rows(run)
    assert [r["epoch"] for r in rows] == [0, 1, 2, 1, 2]
    assert [r.get("resilience/desync", 0) for r in rows] == [0, 0, 1, 1, 1]  # caught at epoch 2, one interval
    for store in ("ckpt", "ckpt.host1"):
        assert_bitwise(slot(run, 3, store), slot(root / "p1", 3), f"{store} after the replay against one process")
    rows_equal(rows[-1], _rows(root / "p1")[-1], "the replayed epoch 2's row")


def test_die_checkpoint_exit_then_reshard_relaunch_is_one_process_bitwise(runs):
    root, out = runs
    assert out["die"] == (1, 0), out["die"]  # the launch's code is the dead host's; the relaunch's is 0
    run = root / "die"
    rollcall, reshard = json.loads((run / "elastic.json").read_text())
    assert (rollcall["kind"], rollcall["survivors"], rollcall["dead"], rollcall["action"], rollcall["epoch"]) == \
        ("rollcall", [0], [1], "checkpoint_exit", 2)
    assert 10.0 <= rollcall["detect_s"] < 60.0
    assert (reshard["kind"], reshard["epoch"], reshard["slot"]) == ("reshard_restore", 2, "step_00000002")
    assert reshard["from"]["process_count"] == 2 and reshard["to"]["process_count"] == 1
    assert_bitwise(slot(run, 2), slot(root / "p1", 2), "the survivor's slot 2 against one process")
    assert_bitwise(slot(run, 3), slot(root / "p1", 3), "the relaunch's θ against one process")
    assert_bitwise(slot(run, 3, name="delta.npz"), slot(root / "p1", 3, name="delta.npz"), "Δθ")
    rows = _rows(run)
    assert [(r["epoch"], r["incarnation"]) for r in rows] == [(0, 0), (1, 0), (2, 2)]
    rows_equal(rows[-1], _rows(root / "p1")[-1], "the relaunch's epoch-2 row")
    assert rows[-1]["resilience/elastic_reshard_restores"] == 1
    assert latest(run) == "step_00000003"


def test_die_continue_adopts_the_lost_members_bitwise(runs):
    root, out = runs
    assert out["cont"] == (1, 0), out["cont"]
    run = root / "cont"
    snap = snapshot(run, 0)
    assert snap["resilience/elastic_continues"] == 1 and snap["resilience/elastic_live_hosts"] == 1
    assert snap["resilience/restore_rejected"] == 1  # the unratified slot 2 of the failed commit
    (rollcall,) = json.loads((run / "elastic.json").read_text())
    assert (rollcall["survivors"], rollcall["dead"], rollcall["action"]) == ([0], [1], "continue")
    assert [r["epoch"] for r in _rows(run)] == [0, 1, 1, 2]
    programs = [json.loads(line) for line in (run / "programs.jsonl").read_text().splitlines()]
    assert [(p["label"], p["geometry"].get("host_slice")) for p in programs] == [
        ("es_eval_slice_m1r1", [0, 2]), ("es_update_partial_m1r1", None), ("es_update_apply_m1r1", None),
        ("es_eval_slice_m1r1", [0, 4]), ("es_update_m1r1", None)]
    assert out["cont"][1] == 0
    assert_bitwise(slot(run, 3), slot(root / "cont_ref", 3), "the survivor against one process from slot 1")
    assert_bitwise(slot(run, 3, name="delta.npz"), slot(root / "cont_ref", 3, name="delta.npz"), "Δθ")
