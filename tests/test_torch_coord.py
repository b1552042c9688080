"""The launch's commit and agreement layer (``resilience.coord``) and the
store's new half (``resilience.checkpoints``: the per-process stores,
deferred publication, ``verify_slot``, ``invalidate_slot``, ``torn_write``,
``restore(on_mismatch="reshard")``), against the JAX package on the CPU.

- ``fingerprint_payload`` and ``fingerprints_agree`` give the JAX verdicts
  on the same gathered rows, made from a numpy seed: agreeing rows, a
  one-ulp fork, NaN rows alike on every process, NaN on one.
- The commit vote under the same faked gather (``host_allgather_bytes``
  monkeypatched in both packages, as ``tests/test_coord.py`` drives the
  JAX one): unanimous, a torn peer, a digest fork, a process other than 0
  writing its own store; the same verdict, the same published and
  invalidated slots, the same legacy mirror, the same counters.
- ``torn_write@K`` tears the slot in both packages, and the read-back
  refuses it.
- Slots cross packages under another process count: the port restores
  what the JAX store wrote with ``process_count`` 2 into a launch of 1
  (and the JAX store the port's), θ and Δθ bitwise, ``resharded`` true,
  ``resilience/elastic_reshard_restores`` ticked; ``raise`` refuses with
  the JAX text, and a ``pop_size`` change raises naming both values under
  ``reshard`` too.
- With one process the commit is the plain save (published at once).
"""

import json

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.parallel import collectives as jcollectives
from hyperscalees_t2i_tpu.resilience import coord as jcoord
from hyperscalees_t2i_tpu.resilience import faultinject as jfi
from hyperscalees_t2i_tpu.resilience import telemetry as jtelemetry
from hyperscalees_t2i_tpu.resilience.checkpoints import CheckpointStore as JStore
from hyperscalees_t2i_tpu.resilience.checkpoints import TopologyMismatch as JTopologyMismatch
from hyperscalees_t2i_tpu_torch.parallel import collectives
from hyperscalees_t2i_tpu_torch.resilience import coord
from hyperscalees_t2i_tpu_torch.resilience import faultinject as fi
from hyperscalees_t2i_tpu_torch.resilience import telemetry
from hyperscalees_t2i_tpu_torch.resilience.checkpoints import CheckpointStore, TopologyMismatch
from hyperscalees_t2i_tpu_torch.utils.pytree import flatten_with_paths
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("HYPERSCALEES_RETRY_BASE_S", "0")
    for mod in (fi, jfi):
        mod.set_fault_plan(None)
    telemetry.set_resilience_registry(None)
    jtelemetry.set_resilience_registry(None)
    yield
    for mod in (fi, jfi):
        mod.set_fault_plan(None)
    telemetry.set_resilience_registry(None)
    jtelemetry.set_resilience_registry(None)
    collectives.set_live_ranks(None)


def _theta_np(seed):
    rng = np.random.default_rng(seed)
    return {"blocks/attn/to_q": {"a": rng.standard_normal((2, 6, 2)).astype(np.float32),
                                 "b": rng.standard_normal((2, 2, 6)).astype(np.float32)},
            "proj_out": {"a": rng.standard_normal((6, 2)).astype(np.float32)}}


def _flat_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def _gathered(rng, n, kind):
    rows = {}
    for k in coord.FINGERPRINT_KEYS:
        v = np.float32(rng.uniform(0.1, 40.0))
        col = np.full(n, v, np.float32)
        if kind == "ulp":
            col[rng.integers(n)] = np.nextafter(v, np.float32(np.inf))
        elif kind == "nan_all":
            col[:] = np.nan
        elif kind == "nan_one":
            col[rng.integers(n)] = np.nan
        elif kind == "fork":
            col[rng.integers(n)] = v * np.float32(1.001)
        rows[coord._FP_PREFIX + k] = col
    return rows


@pytest.mark.parametrize("kind", ["agree", "ulp", "nan_all", "nan_one", "fork"])
def test_fingerprints_agree_as_jax(kind):
    rng = np.random.default_rng(["agree", "ulp", "nan_all", "nan_one", "fork"].index(kind))
    for n in (1, 2, 4):
        scalars = {"theta_norm": float(rng.uniform(1, 40)), "delta_norm": float(rng.uniform(0, 1)), "x": 1.0}
        assert coord.fingerprint_payload(scalars) == jcoord.fingerprint_payload(scalars)
        rows = _gathered(rng, n, kind)
        want = jcoord.fingerprints_agree(rows)
        assert coord.fingerprints_agree(rows) == want
        assert want == (kind in ("agree", "nan_all") or n == 1)
    assert coord.fingerprints_agree({}) == jcoord.fingerprints_agree({}) is True


# ---------------------------------------------------------------------------
# the commit vote under a faked gather
# ---------------------------------------------------------------------------

def _fake_launch(monkeypatch, rank, peer_payload=None):
    """Both packages as process ``rank`` of 2; the gather returns this
    process's row and a peer's (default: the same row, an agreeing peer)."""
    def fake_gather(data, length):
        rows = [data, peer_payload if peer_payload is not None else data]
        return rows[::-1] if rank == 1 else rows

    for mod, coll in ((coord, collectives), (jcoord, jcollectives)):
        monkeypatch.setattr(mod, "process_count", lambda: 2)
        monkeypatch.setattr(mod, "process_index", lambda: rank)
        monkeypatch.setattr(coll, "host_allgather_bytes", fake_gather)


def _outcome(run_dir):
    """What a commit left on disk: each store's slots, invalid slots and
    latest pointer, and the legacy mirror's epoch."""
    out = {}
    for store in sorted(p for p in run_dir.iterdir() if p.is_dir()):
        out[store.name] = (sorted(p.name for p in store.iterdir() if p.name.startswith("step_")),
                           sorted(p.name.rsplit("-", 1)[0] for p in store.iterdir() if p.name.startswith(".invalid-")),
                           (store / "latest").read_text() if (store / "latest").exists() else None)
    meta = run_dir / "latest_meta.json"
    out["mirror"] = json.loads(meta.read_text())["epoch"] if meta.exists() else None
    return out


SCENARIOS = {
    "unanimous": (0, None),
    "torn_peer": (0, b"\x00" * 33),
    "digest_fork": (0, b"\x01" + bytes.fromhex("ab" * 32)),
    "rank1_writes_its_own_store": (1, None),
    "rank1_torn_peer": (1, b"\x00" * 33),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_commit_vote_as_jax(tmp_path, monkeypatch, scenario):
    rank, peer = SCENARIOS[scenario]
    theta, bumped = _theta_np(1), _theta_np(2)
    results = {}
    for name, ck_cls, to_tree, tmod in (("port", coord.CoordinatedCheckpoint, lambda t: tree_from_numpy(t, "cpu"),
                                         telemetry),
                                        ("jax", jcoord.CoordinatedCheckpoint, lambda t: t, jtelemetry)):
        run = tmp_path / name
        _fake_launch(monkeypatch, rank)
        ck = ck_cls(run, keep=3)
        assert ck.save(to_tree(theta), 1, backend_name="sana", legacy_mirror=True)  # a first unanimous slot
        _fake_launch(monkeypatch, rank, peer)
        reg = tmod.set_resilience_registry(None)
        votes = []
        spy_mod = coord if name == "port" else jcoord
        real_vote = spy_mod.host_commit_vote
        monkeypatch.setattr(spy_mod, "host_commit_vote", lambda ok, d: votes.append(real_vote(ok, d)) or votes[-1])
        committed = ck.save(to_tree(bumped), 2, prev_delta=to_tree(theta), backend_name="sana", legacy_mirror=True)
        v = votes[0]
        results[name] = (committed, v.committed, v.ok_flags, [d.hex() for d in v.digests], v.forked,
                         v.failed_hosts, _outcome(run), reg.snapshot())
    assert results["port"] == results["jax"]
    committed = results["port"][0]
    assert committed == (peer is None)
    store = CheckpointStore(tmp_path / "port", dirname=coord.host_store_dirname(rank))
    res = store.restore(tree_from_numpy(_theta_np(9), "cpu"))
    assert res.epoch == (2 if committed else 1)  # a refused slot is never a resume candidate


def test_lowest_live_rank_takes_the_canonical_store(monkeypatch):
    for rank, live, want in ((0, None, "ckpt"), (1, None, "ckpt.host1"), (1, [1], "ckpt"), (2, [1, 2], "ckpt.host2")):
        monkeypatch.setattr(collectives, "process_rank", lambda: rank)
        monkeypatch.setattr(collectives, "process_count", lambda: 3)
        collectives.set_live_ranks(live)
        assert coord.CoordinatedCheckpoint("run").store().dir.name == want
        collectives.set_live_ranks(None)


def test_one_process_commit_is_the_plain_save(tmp_path):
    theta = tree_from_numpy(_theta_np(3), "cpu")
    assert coord.CoordinatedCheckpoint(tmp_path / "run").save(theta, 4, backend_name="sana")
    assert (tmp_path / "run/ckpt/latest").read_text().strip() == "step_00000004"
    assert (tmp_path / "run/latest_theta.npz").exists()
    assert not any(p.name.startswith("ckpt.host") for p in (tmp_path / "run").iterdir())
    v = coord.host_commit_vote(True, "ab" * 32)
    jv = jcoord.host_commit_vote(True, "ab" * 32)
    assert (v.committed, v.ok_flags, v.digests) == (jv.committed, jv.ok_flags, jv.digests) == (True, [True], [
        bytes.fromhex("ab" * 32)])


# ---------------------------------------------------------------------------
# the store: deferred publication, torn writes, verify, invalidate
# ---------------------------------------------------------------------------

def test_deferred_publish_torn_write_verify_and_invalidate_as_jax(tmp_path):
    theta = _theta_np(4)
    outcome = {}
    for name, store_cls, mod, tree in (("port", CheckpointStore, fi, tree_from_numpy(theta, "cpu")),
                                       ("jax", JStore, jfi, theta)):
        store = store_cls(tmp_path / name, keep=2, dirname="ckpt.host1")
        store.save(tree, 1, prev_delta=tree, backend_name="sana")
        digest = store.verify_slot(1, tree)
        mod.set_fault_plan(mod.FaultPlan.parse("torn_write@2"))
        store.save(tree, 2, backend_name="sana", publish_latest=False)
        with pytest.raises(Exception):
            store.verify_slot(2, tree)
        assert store.latest_epoch() == 1
        store.invalidate_slot(2)
        store.save(tree, 3, backend_name="sana", publish_latest=False)
        kept = [p.name for p in store.slots()]  # no retention before the publication
        store.publish_latest(3)
        outcome[name] = (digest, kept, [p.name for p in store.slots()], store.latest_epoch(),
                         store.restore(tree).epoch, store.invalidate_slot(9))
    assert outcome["port"] == outcome["jax"]
    assert outcome["port"][1:5] == (["step_00000001", "step_00000003"], ["step_00000001", "step_00000003"], 3, 3)


# ---------------------------------------------------------------------------
# reshard-on-restore across packages
# ---------------------------------------------------------------------------

TOPO2 = {"process_count": 2, "pop_shards": 1, "pop_size": 4, "pop_host_shard": True}
TOPO1 = {"process_count": 1, "pop_shards": 1, "pop_size": 4, "pop_host_shard": True}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reshard_restore_across_packages(tmp_path, writer):
    theta, delta = _theta_np(5), _theta_np(6)
    if writer == "jax":
        JStore(tmp_path).save(theta, 3, prev_delta=delta, backend_name="sana", topology=TOPO2)
    else:
        CheckpointStore(tmp_path).save(tree_from_numpy(theta, "cpu"), 3, prev_delta=tree_from_numpy(delta, "cpu"),
                                       backend_name="sana", topology=TOPO2)
    template = _theta_np(9)
    with pytest.raises(JTopologyMismatch) as jerr:
        JStore(tmp_path).restore(template, expect_topology=TOPO1)
    with pytest.raises(TopologyMismatch) as err:
        CheckpointStore(tmp_path).restore(tree_from_numpy(template, "cpu"), expect_topology=TOPO1)
    assert str(err.value) == str(jerr.value)
    reg = telemetry.set_resilience_registry(None)
    res = CheckpointStore(tmp_path).restore(tree_from_numpy(template, "cpu"), with_delta=True, expect_topology=TOPO1,
                                            on_mismatch="reshard")
    jres = JStore(tmp_path).restore(template, with_delta=True, expect_topology=TOPO1, on_mismatch="reshard")
    assert res.resharded and jres.resharded and res.epoch == jres.epoch == 3
    _flat_equal(res.theta, tree_from_numpy(theta, "cpu"))
    _flat_equal(res.prev_delta, tree_from_numpy(delta, "cpu"))
    assert reg.snapshot()["resilience/elastic_reshard_restores"] == 1
    assert jtelemetry.get_resilience_registry().snapshot()["resilience/elastic_reshard_restores"] == 1
    same = CheckpointStore(tmp_path).restore(tree_from_numpy(template, "cpu"), expect_topology=TOPO2,
                                             on_mismatch="reshard")
    assert not same.resharded
    # a population change is a different run, reshard or not
    pop8 = {**TOPO1, "pop_size": 8}
    with pytest.raises(JTopologyMismatch) as jerr:
        JStore(tmp_path).restore(template, expect_topology=pop8, on_mismatch="reshard")
    with pytest.raises(TopologyMismatch) as err:
        CheckpointStore(tmp_path).restore(tree_from_numpy(template, "cpu"), expect_topology=pop8,
                                          on_mismatch="reshard")
    assert str(err.value) == str(jerr.value)
    assert "pop_size=4" in str(err.value) and "pop_size=8" in str(err.value)
    for bad in ("shrug",):
        with pytest.raises(ValueError) as jerr:
            JStore(tmp_path).restore(template, on_mismatch=bad)
        with pytest.raises(ValueError) as err:
            CheckpointStore(tmp_path).restore(tree_from_numpy(template, "cpu"), on_mismatch=bad)
        assert str(err.value) == str(jerr.value)
