"""The port's launch, collectives and process identity
(``parallel.mesh``, ``parallel.collectives``, ``obs.multihost``,
``resilience.telemetry``'s host snapshots) against the JAX package on the
CPU.

- At N = 2 and 4 gloo processes (``_torch_gloo.run_workers``), every
  assertion of the JAX two-process worker (``tests/test_multihost.py``),
  generalized to N: barrier, ``master_only``, the scalar mean, the f32
  gather bitwise, the byte gather, rows in rank order bitwise,
  ``host_flag_any``, the trace segment names; and the tensor collectives
  (``psum_tree``, ``pmean_tree``, ``all_gather_tree`` on both axes,
  ``all_gather_ragged``, ``ppermute_ring`` at shifts 1 and −1) against
  the JAX functions under ``shard_map`` on an N-device CPU mesh with the
  same numpy inputs: gathers and permutes exactly, sums within 1e-6.
- One process with no group gives the JAX single-process results.
- ``_kv_gather_rows`` against a fake store, as ``tests/test_elastic.py``
  holds the JAX one: ``GatherTimeout`` names the missing ranks.
- A configured launch whose store cannot be reached raises; the ``xla``
  transport raises by name; without a card a process that names no
  device raises.
- Process identity: rank 0 and, by ``set_process_index_override(1)``,
  rank 1 in trace lines, heartbeats, ``/healthz``, host snapshots, trace
  and profile segments and exporter ports, each as the JAX module gives it.
"""

import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hyperscalees_t2i_tpu.obs import multihost as jmultihost
from hyperscalees_t2i_tpu.parallel import collectives as jcoll
from hyperscalees_t2i_tpu.parallel import mesh as jmesh
from hyperscalees_t2i_tpu_torch.obs import multihost
from hyperscalees_t2i_tpu_torch.obs.exporter import MetricsExporter
from hyperscalees_t2i_tpu_torch.obs.heartbeat import emit_heartbeat
from hyperscalees_t2i_tpu_torch.obs.trace import Tracer
from hyperscalees_t2i_tpu_torch.parallel import collectives as coll
from hyperscalees_t2i_tpu_torch.parallel import mesh
from hyperscalees_t2i_tpu_torch.resilience import telemetry

from _torch_gloo import free_port, run_workers

torch.set_num_threads(1)
SUM_TOL = dict(rtol=1e-6, atol=1e-6)

_WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from hyperscalees_t2i_tpu_torch.obs.multihost import (exporter_port, is_primary, profile_segment_path,
                                                      safe_process_index, trace_segment_path)
from hyperscalees_t2i_tpu_torch.parallel import collectives as C
from hyperscalees_t2i_tpu_torch.parallel.mesh import initialize_multihost, process_device

n = int(os.environ["JAX_NUM_PROCESSES"])
assert initialize_multihost(), "the launch did not form"
assert initialize_multihost()  # joined once; a second call reports the group
rank = C.process_rank()
assert C.process_count() == C.axis_size() == n and C.live_ranks() == list(range(n))
assert process_device("cpu") == torch.device("cpu")

marker = C.master_only(lambda: "master-ran")()
assert (marker == "master-ran") == C.is_master() == (rank == 0)
C.barrier("test-sync")
red = C.host_scalar_allmean({"step_time_s": float(rank), "const": 2.0})
assert red["step_time_s"] == (n - 1) / 2 and red["const"] == 2.0, red
g = C.host_scalar_allgather({"fp": 1.25 + rank})
assert g["fp"].tolist() == [1.25 + r for r in range(n)], g
assert C.host_allgather_bytes(bytes([rank]) * 4, 4) == [bytes([r]) * 4 for r in range(n)]
full = C.host_allgather_rows({"s": np.full((2, 3), float(rank), np.float32)})
assert full["s"].shape == (2 * n, 3)
assert all((full["s"][2 * r:2 * r + 2] == r).all() for r in range(n)), full["s"]
assert C.host_flag_any(rank == 1) is True
assert C.host_flag_any(False) is False
C.barrier("test-sync")
seg = trace_segment_path("/tmp/does-not-matter")
assert seg.name == ("trace.jsonl" if rank == 0 else f"trace.{rank}.jsonl"), seg
assert profile_segment_path("/r").name == ("profile" if rank == 0 else f"profile.{rank}")
assert safe_process_index() == rank and is_primary() == (rank == 0)
assert exporter_port(9100) == 9100 + rank and exporter_port(0) == 0

x = np.load(sys.argv[1])
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
out = {}
mine = {"a": t(x["a"][rank]), "b": t(x["b"][rank])}
out["psum_a"], out["psum_b"] = (v.numpy() for v in C.psum_tree(mine).values())
out["pmean_a"] = C.pmean_tree(mine)["a"].numpy()
out["gather0"] = C.all_gather_tree({"a": mine["a"]}, axis=0)["a"].numpy()
out["gather1"] = C.all_gather_tree({"a": mine["a"]}, axis=1)["a"].numpy()
data, lens = C.all_gather_ragged(t(x["rag"][rank][:x["lens"][rank]]), torch.tensor(int(x["lens"][rank])),
                                 x["rag"].shape[1])
out["ragged"], out["ragged_lens"] = data.numpy(), lens.numpy()
out["ring1"] = C.ppermute_ring(mine["a"], shift=1).numpy()
out["ring_1"] = C.ppermute_ring(mine["a"], shift=-1).numpy()
rows = C.host_allgather_rows({"f": x["rows_f"][rank], "i": x["rows_i"][rank]})
out["rows_f"], out["rows_i"] = rows["f"], rows["i"]
np.savez(sys.argv[2] + f"/rank{rank}.npz", **out)
print(f"rank{rank} ok", flush=True)
"""


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 5, size=n)
    rag = rng.standard_normal((n, 5, 3)).astype(np.float32)
    for r in range(n):
        rag[r, lens[r]:] = 0.0  # the valid prefix only: past it each rank pads with zeros
    return dict(a=rng.standard_normal((n, 3, 4)).astype(np.float32),
                b=rng.standard_normal((n, 6)).astype(np.float32), rag=rag, lens=lens,
                rows_f=rng.standard_normal((n, 2, 5)).astype(np.float32),
                rows_i=rng.integers(-9, 9, size=(n, 2, 2)).astype(np.int32))


def _jax_on_mesh(n, x):
    """The same inputs through the JAX collectives under ``shard_map`` on an
    N-device CPU mesh, shard ``r`` holding rank ``r``'s values."""
    m = jmesh.make_mesh({jmesh.POP_AXIS: n}, devices=jax.devices()[:n])
    ax = jmesh.POP_AXIS

    def run(f, *args, out=P()):
        return jmesh.shard_map(f, mesh=m, in_specs=tuple(P(ax) for _ in args), out_specs=out)(*args)

    a = jnp.asarray(x["a"].reshape(n * 3, 4))
    b = jnp.asarray(x["b"].reshape(n * 6))
    psum = run(lambda s, u: jcoll.psum_tree({"a": s, "b": u}, ax), a, b)
    pmean = run(lambda s: jcoll.pmean_tree({"a": s}, ax), a)
    g0 = run(lambda s: jcoll.all_gather_tree({"a": s}, ax, axis=0), a)
    g1 = run(lambda s: jcoll.all_gather_tree({"a": s}, ax, axis=1), a)
    rag = jnp.asarray(x["rag"][:, :int(x["lens"].max())].reshape(n * int(x["lens"].max()), 3))
    data, lens = run(lambda s, ln: jcoll.all_gather_ragged(s, ln[0], x["rag"].shape[1], ax), rag,
                     jnp.asarray(x["lens"]))
    ring1 = run(lambda s: jcoll.ppermute_ring(s, ax, shift=1), a, out=P(ax))
    ring_1 = run(lambda s: jcoll.ppermute_ring(s, ax, shift=-1), a, out=P(ax))
    return dict(psum_a=psum["a"], psum_b=psum["b"], pmean_a=pmean["a"], gather0=g0["a"], gather1=g1["a"],
                ragged=data, ragged_lens=lens, ring1=np.asarray(ring1).reshape(n, 3, 4),
                ring_1=np.asarray(ring_1).reshape(n, 3, 4))


@pytest.mark.parametrize("n", [2, 4])
def test_n_process_launch_matches_jax(tmp_path, n):
    x = _inputs(n, seed=n)
    np.savez(tmp_path / "x.npz", **x)
    outs = run_workers(n, _WORKER, [str(tmp_path / "x.npz"), str(tmp_path)], timeout_s=100)
    assert all(f"rank{r} ok" in outs[r] for r in range(n))
    ref = _jax_on_mesh(n, x)
    for r in range(n):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(got["psum_a"], ref["psum_a"], **SUM_TOL)
        np.testing.assert_allclose(got["psum_b"], ref["psum_b"], **SUM_TOL)
        np.testing.assert_allclose(got["pmean_a"], ref["pmean_a"], **SUM_TOL)
        for k in ("gather0", "gather1", "ragged_lens"):
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        # the ragged gather: every rank's valid prefix exactly, zeros past it
        np.testing.assert_array_equal(got["ragged"], x["rag"])
        lmax = int(x["lens"].max())
        np.testing.assert_array_equal(got["ragged"][:, :lmax], np.asarray(ref["ragged"])[:, :lmax])
        np.testing.assert_array_equal(got["ring1"], ref["ring1"][r])
        np.testing.assert_array_equal(got["ring_1"], ref["ring_1"][r])
        # rows of every rank in rank order, bitwise (floats and ints)
        assert got["rows_f"].tobytes() == x["rows_f"].reshape(2 * n, 5).tobytes()
        assert got["rows_i"].tobytes() == x["rows_i"].reshape(2 * n, 2).tobytes()


def test_one_process_without_a_group_gives_the_single_process_results():
    assert not mesh.initialize_multihost() and mesh.coordination_store() is None
    assert coll.process_count() == coll.axis_size() == 1 and coll.process_rank() == 0 and coll.is_master()
    x = _inputs(1, seed=7)
    ref = _jax_on_mesh(1, x)
    a, b = torch.from_numpy(x["a"][0]), torch.from_numpy(x["b"][0])
    s = coll.psum_tree({"a": a, "b": b})
    np.testing.assert_array_equal(s["a"].numpy(), ref["psum_a"])
    np.testing.assert_array_equal(s["b"].numpy(), ref["psum_b"])
    np.testing.assert_array_equal(coll.pmean_tree({"a": a})["a"].numpy(), ref["pmean_a"])
    np.testing.assert_array_equal(coll.all_gather_tree({"a": a}, axis=1)["a"].numpy(), ref["gather1"])
    data, lens = coll.all_gather_ragged(torch.from_numpy(x["rag"][0][:x["lens"][0]]), torch.tensor(int(x["lens"][0])),
                                        5)
    np.testing.assert_array_equal(data.numpy(), x["rag"])
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref["ragged_lens"]))
    np.testing.assert_array_equal(coll.ppermute_ring(a, shift=1).numpy(), ref["ring1"][0])
    # the host gathers: the JAX package's single-process answers
    sc = {"b": 2.5, "a": float("nan")}
    ours, theirs = coll.host_scalar_allgather(sc), jcoll.host_scalar_allgather(sc)
    assert list(ours) == list(theirs) and all(ours[k].tobytes() == theirs[k].tobytes() for k in ours)
    assert coll.host_scalar_allmean({"x": 1.5}) == jcoll.host_scalar_allmean({"x": 1.5})
    assert coll.host_allgather_bytes(b"\x01\x02\x03", 2) == jcoll.host_allgather_bytes(b"\x01\x02\x03", 2)
    assert coll.host_allgather_bytes(b"\x01", 3) == jcoll.host_allgather_bytes(b"\x01", 3)
    rows = {"s": x["rows_f"][0]}
    assert coll.host_allgather_rows(rows)["s"].tobytes() == jcoll.host_allgather_rows(rows)["s"].tobytes()
    assert coll.host_flag_any(True) is jcoll.host_flag_any(True) is True
    coll.barrier()  # a no-op alone
    assert coll.master_only(lambda: 3)() == jcoll.master_only(lambda: 3)() == 3
    m = {"a": np.asarray([1.0, 2.0]), "b": 0.25}
    assert coll.fmt_metric_vals(m) == jcoll.fmt_metric_vals(m)


class FakeKV:
    """A dict standing in for the store: a missing key times out (raises)
    as the real blocking get does."""

    def __init__(self):
        self.store = {}
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


def test_kv_gather_timeout_names_seq_rank_and_missing_as_jax(monkeypatch):
    monkeypatch.setenv("HYPERSCALEES_KV_PROBE_MS", "1")
    errors = []
    for gather in (coll._kv_gather_rows, jcoll._kv_gather_rows):
        kv = FakeKV()
        kv.key_value_set("hyperscalees/hg12/2", b"\x01".hex())
        kv.key_value_set("hyperscalees/hg10/0", b"\x09".hex())  # this rank's row of round s − 2
        with pytest.raises(RuntimeError) as ei:
            gather(kv, 0, [0, 1, 2, 3], 12, b"\x00", 1, timeout_ms=5)
        gt = ei.value
        assert gt.seq == 12 and gt.rank == 0 and gt.missing == [1, 3] and gt.timeout_ms == 5
        # after the first miss the remaining reads take the short probe
        assert kv.gets == [("hyperscalees/hg12/0", 5), ("hyperscalees/hg12/1", 5), ("hyperscalees/hg12/2", 1),
                           ("hyperscalees/hg12/3", 1)]
        assert "hyperscalees/hg10/0" not in kv.store
        errors.append(str(gt))
    assert isinstance(gt, jcoll.GatherTimeout)
    assert errors[0] == errors[1] and "hg12" in errors[0] and "rank 0" in errors[0] and "[1, 3]" in errors[0]


def test_kv_gather_rows_in_rank_order_and_live_scoped_as_jax():
    for gather in (coll._kv_gather_rows, jcoll._kv_gather_rows):
        kv = FakeKV()
        kv.key_value_set("hyperscalees/hg3/1", b"\x02".hex())
        assert gather(kv, 0, [0, 1], 3, b"\x01", 1, timeout_ms=50) == [b"\x01", b"\x02"]
        # a shrunk membership neither writes nor waits on the dead rank's keys
        kv = FakeKV()
        kv.key_value_set("hyperscalees/hg0/2", b"\x07".hex())
        assert gather(kv, 0, [0, 2], 0, b"\x05", 1, timeout_ms=50) == [b"\x05", b"\x07"]
        assert not any("/1" in k for k, _ in kv.gets)


def test_set_live_ranks_validates_membership():
    assert coll.live_ranks() == [0] and coll.live_count() == 1
    with pytest.raises(ValueError, match="does not include this process"):
        coll.set_live_ranks([1, 2])
    coll.set_live_ranks([0])
    assert coll.live_ranks() == [0] and coll.live_count() == 1
    coll.set_live_ranks(None)


def test_gather_deadlines_read_the_jax_variables(monkeypatch):
    for name, value in (("HYPERSCALEES_KV_TIMEOUT_MS", "1500"), ("HYPERSCALEES_KV_COMPILE_GRACE_MS", "9000"),
                        ("HYPERSCALEES_KV_PROBE_MS", "7")):
        monkeypatch.setenv(name, value)
    try:
        for grace in (False, True):
            coll.set_gather_grace(grace)
            jcoll.set_gather_grace(grace)
            assert coll._kv_timeout_ms() == jcoll._kv_timeout_ms() == (9000 if grace else 1500)
        assert coll._kv_probe_timeout_ms() == jcoll._kv_probe_timeout_ms() == 7
    finally:
        coll.set_gather_grace(False)
        jcoll.set_gather_grace(False)


def test_xla_transport_raises_by_name(monkeypatch):
    monkeypatch.setenv("HYPERSCALEES_HOST_GATHER", "xla")
    with pytest.raises(RuntimeError, match="HYPERSCALEES_HOST_GATHER=xla"):
        coll.kv_client()
    monkeypatch.setenv("HYPERSCALEES_HOST_GATHER", "kv")
    with pytest.raises(RuntimeError, match="no launch store"):
        coll.kv_client()


def test_a_configured_launch_whose_store_cannot_be_reached_raises(monkeypatch):
    """Rank 1 of 2 with nobody listening at the coordinator: it raises
    within the store's deadline and never runs alone."""
    monkeypatch.setenv("HYPERSCALEES_KV_TIMEOUT_MS", "1500")
    for k, v in (("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}"), ("NUM_PROCESSES", "2"),
                 ("JAX_PROCESS_ID", "1")):
        monkeypatch.setenv(k, v)
    assert mesh.launch_config()[1:] == (2, 1)
    with pytest.raises(RuntimeError, match="could not be reached"):
        mesh.initialize_multihost()
    assert mesh.coordination_store() is None and coll.process_count() == 1
    with pytest.raises(ValueError, match="host:port"):
        mesh.initialize_multihost("nohost", 2, 1)
    with pytest.raises(ValueError, match="outside a launch of 2"):
        mesh.initialize_multihost("127.0.0.1:1", 2, 2)


def test_launch_config_reads_both_spellings_and_the_flags_win(monkeypatch):
    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "NUM_PROCESSES",
              "JAX_PROCESS_ID", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.launch_config() is None and not mesh.initialize_multihost()
    monkeypatch.setenv("COORDINATOR_ADDRESS", "h:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
    monkeypatch.setenv("PROCESS_ID", "0")
    assert mesh.launch_config() == ("h:1", 3, 0)
    assert mesh.launch_config("g:2", 4, 3) == ("g:2", 4, 3)


def test_a_process_without_a_card_must_name_its_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.process_device(None)
    assert mesh.process_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("pop, hosts", [(8, 1), (8, 2), (8, 4), (6, 3), (5, 2), (4, 0)])
def test_host_slices_and_local_pop_match_jax(pop, hosts):
    def outcome(fn, *a):
        try:
            return fn(*a)
        except ValueError as e:
            return ("raises", str(e))

    assert outcome(mesh.host_slices, pop, hosts) == outcome(jmesh.host_slices, pop, hosts)
    if hosts:
        jm = jmesh.make_mesh({jmesh.POP_AXIS: hosts}, devices=jax.devices()[:hosts])
        assert outcome(mesh.local_pop, pop, hosts) == outcome(jmesh.local_pop, jm, pop)
        ours, theirs = mesh.pop_slice_plan(pop, hosts), jmesh.pop_slice_plan(jm, pop)
        assert {k: ours[k] for k in ("n_pop", "lpop", "pop_size")} == {k: theirs[k] for k in ("n_pop", "lpop",
                                                                                               "pop_size")}
        assert [s["members"] for s in ours["shards"]] == [s["members"] for s in theirs["shards"]]
        assert [s["processes"] for s in ours["shards"]] == [[p] for p in range(hosts)]
    assert (mesh.POP_AXIS, mesh.DATA_AXIS, mesh.TP_AXIS) == (jmesh.POP_AXIS, jmesh.DATA_AXIS, jmesh.TP_AXIS)


@pytest.mark.parametrize("rank", [0, 1])
def test_process_identity_as_jax(tmp_path, rank):
    """Rank 0 is what a process alone reports; rank 1 is pinned by the
    override, in both packages."""
    multihost.set_process_index_override(rank or None)
    jmultihost.set_process_index_override(rank or None)
    try:
        assert multihost.safe_process_index() == jmultihost.safe_process_index() == rank
        assert multihost.is_primary() == jmultihost.is_primary() == (rank == 0)
        for base in (0, 9100):
            assert multihost.exporter_port(base) == jmultihost.exporter_port(base)
        for name in ("trace.jsonl", "events.jsonl", "trace"):
            assert multihost.trace_segment_path(tmp_path, name) == jmultihost.trace_segment_path(tmp_path, name)
        assert multihost.profile_segment_path(tmp_path) == jmultihost.profile_segment_path(tmp_path)
        # every writer of a process_index says this rank
        tr = Tracer(tmp_path / "t.jsonl")
        with tr.span("s"):
            pass
        tr.event("e", 0.0, 1.0)
        assert [json.loads(l)["process_index"] for l in (tmp_path / "t.jsonl").read_text().splitlines()] == [rank] * 3
        hb = io.StringIO()
        emit_heartbeat("train", "dispatch", stream=hb)
        assert json.loads(hb.getvalue())["process_index"] == rank
        assert MetricsExporter(0).healthz()["process_index"] == rank
        assert telemetry.host_snapshot_payload()["process_index"] == rank
        telemetry.write_host_snapshot(tmp_path, epoch=3, extra={"committed": True})
        path = telemetry.host_snapshot_path(tmp_path, rank)
        assert path.name == f"resilience.host{rank}.json"
        snap = json.loads(path.read_text())
        assert snap["process_index"] == rank and snap["epoch"] == 3 and snap["committed"] is True
        assert math.isfinite(snap["wall_time"])
    finally:
        multihost.set_process_index_override(None)
        jmultihost.set_process_index_override(None)
