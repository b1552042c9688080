"""Elastic membership (``resilience.elastic``) and the store gathers it
stands on (``parallel.collectives``), against the JAX package on the CPU.

Every scenario of ``tests/test_elastic.py:170-465`` runs in both packages
on copies of one scripted key-value client (a dict whose missing key
"times out" as the real blocking get does):

- ``roll_call``: unanimous, a missing rank, a stale incarnation, a rank
  that died between the phases, the symmetric intersection with its
  eviction, the ratify phase adopting the lowest verdict, the membership
  tombstone (posted by survivors only; a straggler standing down on it; a
  stale incarnation's ignored; the latest of a chain read): the same
  survivors, dead, observed set and eviction, the same keys left in the
  store, the same ``resilience/elastic_*`` counters.
- ``survivor_commit``: publish and restore, the canonical republish when
  rank 0 is dead, the refusal on a missing peer vote, the refusal that
  keeps an already ratified slot, the vote at the gather deadline: the same
  verdicts, store contents, read deadlines and counters.
- ``elastic.json`` transitions and the membership view, key for key.
- The gather: ``GatherTimeout`` naming its round, rank and missing ranks
  with the probe after the first miss, the live-scoped gather, the compile
  grace.
"""

import copy
import json

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.parallel import collectives as jcollectives
from hyperscalees_t2i_tpu.resilience import elastic as jelastic
from hyperscalees_t2i_tpu.resilience import telemetry as jtelemetry
from hyperscalees_t2i_tpu.resilience.checkpoints import CheckpointStore as JStore
from hyperscalees_t2i_tpu_torch.parallel import collectives
from hyperscalees_t2i_tpu_torch.resilience import elastic
from hyperscalees_t2i_tpu_torch.resilience import telemetry
from hyperscalees_t2i_tpu_torch.resilience.checkpoints import CheckpointStore
from hyperscalees_t2i_tpu_torch.utils.pytree import flatten_with_paths
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

torch.set_num_threads(1)
ROOT = "hyperscalees/elastic"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("HYPERSCALEES_RETRY_BASE_S", "0")
    for coll, el, tel in ((collectives, elastic, telemetry), (jcollectives, jelastic, jtelemetry)):
        tel.set_resilience_registry(None)
        coll.set_live_ranks(None)
        el.reset_membership("test", [0])
    yield
    for coll, tel in ((collectives, telemetry), (jcollectives, jtelemetry)):
        coll.set_live_ranks(None)
        coll.set_gather_grace(False)
        tel.set_resilience_registry(None)


class FakeKV:
    """A dict as the store: a missing key raises as a timed-out get."""

    def __init__(self, initial=None):
        self.store = dict(initial or {})
        self.gets = []

    def key_value_set(self, key, value):
        self.store[key] = value

    def blocking_key_value_get(self, key, timeout_ms):
        self.gets.append((key, timeout_ms))
        if key in self.store:
            return self.store[key]
        raise TimeoutError(f"DEADLINE_EXCEEDED waiting for {key}")

    def key_value_delete(self, key):
        self.store.pop(key, None)


def _prepost(kv, round_id, rank, inc, vote):
    kv.key_value_set(f"{ROOT}/{round_id}/alive/{rank}", inc)
    kv.key_value_set(f"{ROOT}/{round_id}/vote/{rank}", json.dumps(vote))


def _tomb(rank, k, inc, rnd, survivors):
    return {f"{ROOT}/membership/{rank}/{k}": json.dumps({"incarnation": inc, "round": rnd, "survivors": survivors})}


def _script(name):
    """(initial store, [(rank, ranks, incarnation, round)] calls in order)."""
    kv = FakeKV()
    if name == "unanimous":
        for r in (1, 2):
            _prepost(kv, "g5", r, "i0.n3", [0, 1, 2])
        return kv, [(0, [0, 1, 2], "i0.n3", "g5")]
    if name == "missing_rank":
        _prepost(kv, "g5", 1, "i0.n3", [0, 1])
        return kv, [(0, [0, 1, 2], "i0.n3", "g5")]
    if name == "stale_incarnation":
        _prepost(kv, "g5", 1, "i0.n2", [0, 1])
        return kv, [(0, [0, 1], "i3.n2", "g5")]
    if name == "died_between_phases":
        kv.key_value_set(f"{ROOT}/g7/alive/1", "i0.n2")
        return kv, [(0, [0, 1], "i0.n2", "g7")]
    if name == "symmetric_intersection_evicts":
        _prepost(kv, "g9", 1, "i0.n3", [0, 1])
        _prepost(kv, "g9", 2, "i0.n3", [0, 1, 2])
        return kv, [(0, [0, 1, 2], "i0.n3", "g9"), (2, [0, 1, 2], "i0.n3", "g9")]
    if name == "ratify_adopts_lowest":
        kv.key_value_set(f"{ROOT}/g9/final/0", json.dumps([0, 1]))
        _prepost(kv, "g9", 1, "i0.n3", [1, 2])
        return kv, [(2, [0, 1, 2], "i0.n3", "g9")]
    if name == "tombstone_posted":
        return kv, [(0, [0, 1], "i0.n2", "g4")]
    if name == "straggler_stands_down":
        return FakeKV(_tomb(0, 0, "i0.n4", "g5", [0, 1, 2])), [(3, [0, 1, 2, 3], "i0.n4", "g9")]
    if name == "stale_tombstone_ignored":
        return FakeKV(_tomb(0, 0, "i0.n2", "g3", [0])), [(1, [0, 1], "i4.n2", "g8")]
    if name == "tombstone_chain_latest":
        return FakeKV({**_tomb(0, 0, "i0.n4", "g2", [0, 1, 2, 3]), **_tomb(0, 1, "i0.n4", "g6", [0, 1])}), \
            [(2, [0, 1, 2, 3], "i0.n4", "g9")]
    if name == "two_rounds_chain_own_tombstones":
        return kv, [(0, [0, 1, 2], "i0.n3", "g4"), (0, [0, 1], "i0.n3", "g8")]
    raise KeyError(name)


ROLL_CALLS = ["unanimous", "missing_rank", "stale_incarnation", "died_between_phases",
              "symmetric_intersection_evicts", "ratify_adopts_lowest", "tombstone_posted", "straggler_stands_down",
              "stale_tombstone_ignored", "tombstone_chain_latest", "two_rounds_chain_own_tombstones"]


@pytest.mark.parametrize("name", ROLL_CALLS)
def test_roll_call_as_jax(name):
    kv0, calls = _script(name)
    out = {}
    for pkg, el, tel in (("port", elastic, telemetry), ("jax", jelastic, jtelemetry)):
        kv = copy.deepcopy(kv0)
        reg = tel.set_resilience_registry(None)
        el.reset_membership("test", [0])
        verdicts = []
        for rank, ranks, inc, rnd in calls:
            rc = el.roll_call(kv, rank=rank, ranks=ranks, incarnation=inc, round_id=rnd, timeout_ms=50)
            verdicts.append((rc.round_id, rc.rank, rc.survivors, rc.dead, rc.observed_alive, rc.all_alive,
                             rc.evicted))
        out[pkg] = (verdicts, kv.store, kv.gets, reg.snapshot())
    assert out["port"] == out["jax"]
    print(name, out["port"][0])


def test_rollcall_timeout_env_as_jax(monkeypatch):
    for v in ("2500", "", "bad"):
        monkeypatch.setenv("HYPERSCALEES_ELASTIC_ROLLCALL_MS", v)
        assert elastic.rollcall_timeout_ms() == jelastic.rollcall_timeout_ms()


# ---------------------------------------------------------------------------
# the survivors' commit
# ---------------------------------------------------------------------------

def _theta_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"u": rng.normal(size=(4, 3)).astype(np.float32)}, "b": rng.normal(size=(5,)).astype(np.float32)}


COMMITS = {
    "publish": dict(epoch=3, rank=0, survivors=[0], kv={}, timeout_ms=None, presaved=False),
    "rank0_dead_republish": dict(epoch=5, rank=1, survivors=[1], kv={}, timeout_ms=None, presaved=False),
    "missing_peer_vote": dict(epoch=7, rank=0, survivors=[0, 1], kv={}, timeout_ms=5, presaved=False),
    "keeps_ratified_slot": dict(epoch=7, rank=0, survivors=[0, 1], kv={}, timeout_ms=5, presaved=True),
    "peer_agrees": dict(epoch=2, rank=0, survivors=[0, 1], kv="agree", timeout_ms=5, presaved=False),
    "peer_forked": dict(epoch=2, rank=0, survivors=[0, 1], kv="fork", timeout_ms=5, presaved=False),
    "vote_at_gather_deadline": dict(epoch=2, rank=0, survivors=[0, 1], kv={}, timeout_ms=None, presaved=False),
}


def _stores(run_dir):
    out = {}
    for d in sorted(p for p in run_dir.iterdir() if p.is_dir()):
        out[d.name] = (sorted(p.name for p in d.iterdir() if p.name.startswith("step_")),
                       sorted(p.name.rsplit("-", 1)[0] for p in d.iterdir() if p.name.startswith(".invalid-")),
                       (d / "latest").read_text() if (d / "latest").exists() else None)
    return out


@pytest.mark.parametrize("name", sorted(COMMITS))
def test_survivor_commit_as_jax(tmp_path, monkeypatch, name):
    c = COMMITS[name]
    monkeypatch.setenv("HYPERSCALEES_KV_TIMEOUT_MS", "77000")
    monkeypatch.setenv("HYPERSCALEES_ELASTIC_ROLLCALL_MS", "5")
    theta = _theta_np()
    out = {}
    for pkg, el, tel, store_cls, tree in (("port", elastic, telemetry, CheckpointStore, tree_from_numpy(theta, "cpu")),
                                          ("jax", jelastic, jtelemetry, JStore, theta)):
        run = tmp_path / pkg
        run.mkdir()
        reg = tel.set_resilience_registry(None)
        if c["presaved"]:
            store_cls(run, keep=3).save(tree, c["epoch"], backend_name="sana")
        kv = FakeKV()
        if c["kv"] in ("agree", "fork"):
            # the peer's vote: the digest this θ's slot has, or another one
            probe = store_cls(tmp_path / f"{pkg}_probe", keep=3)
            probe.save(tree, c["epoch"], backend_name="sana")
            digest = probe.verify_slot(c["epoch"], tree) if c["kv"] == "agree" else "ab" * 32
            kv.key_value_set(f"{ROOT}/g6/ckpt/1", json.dumps({"ok": True, "digest": digest}))
        ok = el.survivor_commit(run, tree, c["epoch"], client=kv, rank=c["rank"], survivors=c["survivors"],
                                round_id="g6", incarnation="i0.n2", keep=3, backend_name="sana",
                                topology={"process_count": 2, "pop_size": 4}, timeout_ms=c["timeout_ms"])
        out[pkg] = (ok, _stores(run), {k: json.loads(v)["ok"] for k, v in kv.store.items()}, kv.gets,
                    reg.snapshot())
    assert out["port"] == out["jax"]
    ok = out["port"][0]
    assert ok == (name in ("publish", "rank0_dead_republish", "peer_agrees"))
    if ok:
        for dirname in ("ckpt",) + (("ckpt.host1",) if c["rank"] == 1 else ()):
            res = CheckpointStore(tmp_path / "port", dirname=dirname).restore(tree_from_numpy(_theta_np(9), "cpu"))
            assert res.epoch == c["epoch"]
            np.testing.assert_array_equal(flatten_with_paths(res.theta)["b"], theta["b"])
    if name == "vote_at_gather_deadline":
        assert [t for k, t in out["port"][3] if "/ckpt/" in k] == [77000]


# ---------------------------------------------------------------------------
# transitions and the membership view
# ---------------------------------------------------------------------------

def test_transitions_and_membership_view_as_jax(tmp_path):
    rollcall = {"kind": "rollcall", "round": "g5", "epoch": 2, "dead": [1], "survivors": [0],
                "action": "checkpoint_exit", "incarnation": "i0.n2", "detect_s": 3.204}
    reshard = {"kind": "reshard_restore", "epoch": 2, "from": {"process_count": 2, "pop_size": 4},
               "to": {"process_count": 1, "pop_size": 4}, "slot": "step_00000002"}
    views, docs = {}, {}
    for pkg, el in (("port", elastic), ("jax", jelastic)):
        el.reset_membership("pending", [0, 1])
        el.note_membership([0, 1], transition={"kind": "reshard_restore"})
        el.set_incarnation("i0.n2")
        el.note_membership([0], transition=rollcall)
        views[pkg] = el.membership_view()
        run = tmp_path / pkg
        run.mkdir()
        assert el.read_transitions(run) == []
        el.write_transition(run, rollcall)
        el.write_transition(run, reshard)
        docs[pkg] = [{k: v for k, v in t.items() if k != "wall_time"} for t in el.read_transitions(run)]
        assert all("wall_time" in t for t in el.read_transitions(run))
        (run / "elastic.json").write_text("{not json")
        assert el.read_transitions(run) == []
    assert views["port"] == views["jax"] == {"incarnation": "i0.n2", "live_ranks": [0],
                                             "transitions": [{"kind": "reshard_restore"}, rollcall]}
    assert docs["port"] == docs["jax"] == [rollcall, reshard]
    # the port reads the JAX package's file and the other way round
    assert elastic.read_transitions(tmp_path / "jax") == jelastic.read_transitions(tmp_path / "jax")
    elastic.reset_membership("x", [0])
    jelastic.reset_membership("x", [0])
    assert elastic.membership_view() == jelastic.membership_view()


# ---------------------------------------------------------------------------
# the store gathers under elastic membership
# ---------------------------------------------------------------------------

def test_gather_timeout_names_round_rank_and_missing_as_jax(monkeypatch):
    monkeypatch.setenv("HYPERSCALEES_KV_PROBE_MS", "1")
    errs = []
    for coll in (collectives, jcollectives):
        kv = FakeKV()
        kv.key_value_set("hyperscalees/hg12/2", b"\x01".hex())
        with pytest.raises(coll.GatherTimeout) as ei:
            coll._kv_gather_rows(kv, 0, [0, 1, 2], 12, b"\x00", 1, timeout_ms=5)
        gt = ei.value
        errs.append((gt.seq, gt.rank, gt.missing, gt.timeout_ms, kv.gets, kv.store))
    assert errs[0] == errs[1]
    assert errs[0][:3] == (12, 0, [1]) and errs[0][4][-1] == ("hyperscalees/hg12/2", 1)
    # a scoped gather neither waits on nor reads the dead rank's row
    for coll in (collectives, jcollectives):
        kv = FakeKV()
        kv.key_value_set("hyperscalees/hg0/2", b"\x07".hex())
        assert coll._kv_gather_rows(kv, 0, [0, 2], 0, b"\x05", 1, timeout_ms=50) == [b"\x05", b"\x07"]
        assert not any("/1" in k for k, _ in kv.gets)


def test_live_ranks_and_gather_grace_as_jax(monkeypatch):
    for coll in (collectives, jcollectives):
        assert coll.live_ranks() == [0]
        with pytest.raises(ValueError):
            coll.set_live_ranks([1, 2])
        coll.set_live_ranks([0])
        assert coll.live_ranks() == [0] and coll.live_count() == 1
        coll.set_live_ranks(None)
    for base, grace in (("4000", "99999"), ("600000", "99999"), ("", "")):
        monkeypatch.setenv("HYPERSCALEES_KV_TIMEOUT_MS", base)
        monkeypatch.setenv("HYPERSCALEES_KV_COMPILE_GRACE_MS", grace)
        for on in (False, True):
            collectives.set_gather_grace(on)
            jcollectives.set_gather_grace(on)
            assert collectives._kv_timeout_ms() == jcollectives._kv_timeout_ms()
