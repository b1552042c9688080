"""The port's open-loop load harness against the JAX package's.

- ``build_schedule`` gives the JAX schedule for the same ``TrafficConfig``
  (Poisson and MMPP, several seeds and geometry mixes): the same arrival
  times, adapter ranks, prompt counts and seeds; ``zipf_weights``,
  ``detect_knee`` and ``parse_geometry_mix`` equal too.
- ``run_step`` is open loop: against a slow fake engine every arrival is
  submitted at its scheduled time and the backlog is abandoned into the
  tail (the JAX test's engine).
- ``run_step`` and ``run_sweep`` over a tiny CPU engine (windows ≤ 1 s):
  completions, store churn through the synthetic population, the capacity
  document's fields; the CLI writes the artifact.
"""

import json
import time
import types

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.tools import loadgen as jloadgen
from hyperscalees_t2i_tpu_torch.tools import loadgen
from hyperscalees_t2i_tpu_torch.utils import threefry

torch.set_num_threads(1)

TRAFFIC = [
    dict(rate_rps=30.0, window_s=2.0, seed=0),
    dict(rate_rps=5.0, window_s=4.0, seed=7, population=1000, zipf_s=1.3),
    dict(rate_rps=12.0, window_s=3.0, seed=3, process="mmpp", burst_factor=1.5, burst_dwell_s=0.5),
    dict(rate_rps=40.0, window_s=1.0, seed=11, process="mmpp", geometry_mix=((1, 0.8), (2, 0.2))),
]


@pytest.mark.parametrize("kw", TRAFFIC, ids=[f"{k.get('process', 'poisson')}-{k['seed']}" for k in TRAFFIC])
def test_build_schedule_matches_jax(kw):
    ours = loadgen.build_schedule(loadgen.TrafficConfig(**kw))
    theirs = jloadgen.build_schedule(jloadgen.TrafficConfig(**kw))
    assert len(ours) == len(theirs) > 0
    assert [dataclass_tuple(a) for a in ours] == [dataclass_tuple(a) for a in theirs]


def dataclass_tuple(a):
    return (a.t, a.adapter_index, a.n_prompts, a.seed)


def test_zipf_weights_and_geometry_mix_match_jax():
    for pop, s in ((1, 1.1), (64, 1.1), (1000, 0.8)):
        np.testing.assert_array_equal(loadgen.zipf_weights(pop, s), jloadgen.zipf_weights(pop, s))
    for spec in ("1:0.9,2:0.1", "1", "4:2,1:1"):
        assert loadgen.parse_geometry_mix(spec) == jloadgen.parse_geometry_mix(spec)
    with pytest.raises(ValueError):
        loadgen.parse_geometry_mix("0:1")
    with pytest.raises(ValueError):
        loadgen.build_schedule(loadgen.TrafficConfig(rate_rps=1.0, window_s=1.0, process="mmpp", burst_factor=2.5))


KNEE_STEPS = [
    [{"offered_rps": 2.0, "p99_open_s": 0.4, "queue_unbounded": False, "goodput_rps": 1.9},
     {"offered_rps": 4.0, "p99_open_s": 0.8, "queue_unbounded": False, "goodput_rps": 3.7},
     {"offered_rps": 8.0, "p99_open_s": 1.1, "queue_unbounded": True, "goodput_rps": 5.0},
     {"offered_rps": 16.0, "p99_open_s": 9.0, "queue_unbounded": True, "goodput_rps": 2.0}],
    [{"offered_rps": 1.0, "p99_open_s": 3.0, "queue_unbounded": False, "goodput_rps": 0.1}],
    [{"offered_rps": 1.0, "p99_open_s": None, "queue_unbounded": False, "goodput_rps": 0.0},
     {"offered_rps": 2.0, "p99_open_s": 0.5, "queue_unbounded": False, "goodput_rps": 2.0}],
]


@pytest.mark.parametrize("i", range(len(KNEE_STEPS)))
def test_detect_knee_matches_jax(i):
    assert loadgen.detect_knee(KNEE_STEPS[i], 2.0) == jloadgen.detect_knee(KNEE_STEPS[i], 2.0)


# -- the open-loop invariant against a slow fake engine -------------------------

class _FakeQueue:
    def __init__(self):
        self.items = []

    @property
    def depth(self):
        return len(self.items)

    def drain(self):
        out, self.items = self.items, []
        return out


class _FakeStore:
    def __init__(self):
        self.known = set()

    def entry(self, aid):
        if aid not in self.known:
            raise KeyError(aid)

    def stats(self):
        return {"hits": 0, "misses": 0, "evictions": 0, "resident": len(self.known), "resident_bytes": 0}


class _FakePop:
    def ensure(self, engine, index):
        aid = f"synth-{index:06d}"
        engine.store.known.add(aid)
        return aid


class _SlowFakeEngine:
    def __init__(self, dispatch_s=0.12):
        self.queue, self.store = _FakeQueue(), _FakeStore()
        self.cfg = types.SimpleNamespace(adapter_batch=1, max_queue=10_000)
        self.backend = types.SimpleNamespace(num_items=4)
        self.dispatch_s = dispatch_s
        self.submitted_t = []

    def submit(self, adapter_id, prompt_ids, seed, t_submit=None):
        self.submitted_t.append(float(t_submit))
        self.queue.items.append(types.SimpleNamespace(t_submit=t_submit))

    def flush(self, max_batches=None):
        time.sleep(self.dispatch_s)
        take, self.queue.items = self.queue.items[:1], self.queue.items[1:]
        now = time.perf_counter()
        return [types.SimpleNamespace(ok=True, latency_s=now - it.t_submit, t_submit=it.t_submit, batch_occupancy=1.0)
                for it in take]

    def abandon_queued(self):
        return self.queue.drain()


def test_open_loop_arrivals_independent_of_a_slow_engine():
    cfg = loadgen.TrafficConfig(rate_rps=30.0, window_s=1.0, seed=5, population=8)
    arrivals = loadgen.build_schedule(cfg)
    eng = _SlowFakeEngine()
    row = loadgen.run_step(eng, _FakePop(), arrivals, cfg.window_s, slo_p99_s=0.05, offered_rps=cfg.rate_rps)
    assert len(eng.submitted_t) == len(arrivals)
    np.testing.assert_allclose(np.diff(eng.submitted_t), np.diff([a.t for a in arrivals]), atol=1e-9)
    assert row["completed"] + row["abandoned"] == len(arrivals) and row["abandoned"] > 0
    assert row["queue_unbounded"] and row["p99_open_s"] > 0.05
    knee, capacity, _, knee_p99 = loadgen.detect_knee([row], slo_p99_s=0.05)
    assert knee["rate_rps"] == cfg.rate_rps and capacity == 0.0 and knee_p99 == row["p99_open_s"]


# -- a tiny engine on the CPU ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    engine, pop = loadgen.build_engine("tiny", store_adapters=4, device="cpu", adapter_batch=4)
    engine.warmup()
    return engine, pop


def test_population_draws_are_deterministic_and_through_the_store(tiny):
    engine, pop = tiny
    a, b = pop.theta_for(3), pop.theta_for(3)
    k = sorted(a)[0]
    assert torch.equal(a[k]["a"], b[k]["a"]) and not torch.equal(a[k]["a"], pop.theta_for(4)[k]["a"])
    # one flat draw from fold_in(PRNGKey(0), rank), cut into the leaves in order
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves

    leaves = tree_leaves(engine.template)
    z = threefry.normal(threefry.fold_in(threefry.prng_key(0, "cpu"), 3), (sum(t.numel() for t in leaves),))
    n0 = leaves[0].numel()
    first = tree_leaves(a)[0]
    torch.testing.assert_close(first, leaves[0] + 0.05 * z[:n0].reshape(leaves[0].shape), rtol=0, atol=0)
    second = tree_leaves(a)[1]
    torch.testing.assert_close(second, leaves[1] + 0.05 * z[n0:n0 + leaves[1].numel()].reshape(leaves[1].shape),
                               rtol=0, atol=0)


def test_run_step_over_a_tiny_engine(tiny):
    engine, pop = tiny
    arrivals = loadgen.build_schedule(loadgen.TrafficConfig(rate_rps=20.0, window_s=1.0, seed=1, population=64))
    row = loadgen.run_step(engine, pop, arrivals, 1.0, slo_p99_s=2.0, offered_rps=20.0)
    assert row["arrivals"] == len(arrivals) > 0
    assert row["completed"] + row["abandoned"] + row["rejected"] + row["errors"] + row["shed"] == len(arrivals)
    assert row["completed"] > 0 and row["p50_s"] <= row["p99_s"]
    # overload off: the only errors are admit-then-thrash refusals (a queued
    # request's adapter evicted by a later admission)
    assert row["errors"] == row["not_resident_refusals"]
    distinct = len({a.adapter_index for a in arrivals})
    assert row["store_misses"] >= distinct - 4 and row["store_resident"] <= 4
    assert row["store_evictions"] >= distinct - 4 - 4  # at most 4 were resident before the window
    assert row["overload_enabled"] is False


def test_run_sweep_document_over_a_tiny_engine(tiny):
    engine, pop = tiny
    doc = loadgen.run_sweep("tiny", [4.0, 400.0], window_s=0.5, population=16, store_adapters=4, engine=engine,
                            pop=pop)
    jkeys = {"mode", "schema_version", "metric", "rung", "seed", "process", "zipf_s", "population", "geometry_mix",
             "window_s", "slo_p99_s", "adapter_batch", "max_queue", "store_budget_bytes", "store_budget_adapters",
             "rates", "steps", "knee", "capacity_rps", "goodput_rps", "knee_p99_s", "headline", "adapter_hotness",
             "adapters_seen", "adapters_materialized", "store", "git_sha", "platform", "n_devices"}
    assert jkeys <= set(doc) and "jax_version" not in doc and doc["torch_version"] == torch.__version__
    assert doc["mode"] == "capacity" and doc["platform"] == "cpu" and len(doc["steps"]) == 2
    assert doc["capacity_rps"] in (0.0, 4.0, 400.0)


def test_cli_writes_the_artifact(tmp_path, capsys):
    out = tmp_path / "cap.json"
    assert loadgen.main(["--rung", "tiny", "--device", "cpu", "--adapter_batch", "2", "--rate", "4",
                         "--window_s", "0.5", "--population", "8", "--store_adapters", "4", "--out", str(out),
                         "--run_dir", str(tmp_path / "run")]) == 0
    doc = json.loads(out.read_text())
    assert doc["mode"] == "capacity" and doc["adapter_batch"] == 2 and doc["rates"] == [4.0]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["mode"] == "capacity" and (tmp_path / "run" / "cap.json").exists()
    assert (tmp_path / "run" / "trace.jsonl").exists()
