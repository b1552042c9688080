"""The port's serving tier against the JAX package's, on the CPU: the same
inputs through both, the outcomes held equal.

- ``utils.stats``: every function on the same samples, equal results.
- SLOs: the same spec parses to the same objectives; one event sequence on
  an injected clock gives the same burn gauges and alert latches tick by
  tick (availability and latency objectives).
- ``render_prometheus``: one registry's operations in each package render
  to the same text, which parses to the same samples.
- The overload governor: one event sequence on an injected clock gives the
  same rungs, doom reasons, breaker states and shed counts.
- The batcher: deadlines carried, prune and drain keep the same requests in
  the same order.
- The store: one sequence of puts, leases, releases and evictions leaves
  the same resident ids in the same order, with the same counters.
- Admission: an override budget below the estimate refuses in both
  packages before anything is built (the port: no program, no capture
  counted, nothing run at full width); the port's probes run below
  ``adapter_batch`` lanes, and at one lane the gate measures the build.
- The engine's admit-then-thrash scenario: the same refusals with the
  overload layer off in both packages, none with it on (``not_resident``
  0).
- With overload on, a request batched equals it served alone, bitwise; the
  live exporter serves ``/metrics`` (histograms counting the requests) and
  ``/healthz`` over HTTP on the loopback.
- ``load_adapter`` reads a training run's checkpoint slot.
"""

import copy
import io
import json
import socket
import urllib.request

import jax
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.obs import exporter as jexporter
from hyperscalees_t2i_tpu.obs import slo as jslo
from hyperscalees_t2i_tpu.obs.metrics import MetricsRegistry as JRegistry
from hyperscalees_t2i_tpu.serve import adapter_store as jstore_mod
from hyperscalees_t2i_tpu.serve import batcher as jbatcher
from hyperscalees_t2i_tpu.serve import overload as joverload
from hyperscalees_t2i_tpu.utils import stats as jstats
from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_serve_backend
from hyperscalees_t2i_tpu_torch.obs import exporter, slo
from hyperscalees_t2i_tpu_torch.obs.metrics import MetricsRegistry
from hyperscalees_t2i_tpu_torch.rungs import sana_rung_model
from hyperscalees_t2i_tpu_torch.serve import (AdapterStore, OverloadConfig, ServeAdmissionError, ServeConfig,
                                              ServeEngine, ServeShedError, adapter_bytes, batcher, overload)
from hyperscalees_t2i_tpu_torch.serve.admission import extrapolate, parse_serve_geometry, probe_lanes
from hyperscalees_t2i_tpu_torch.utils import stats, threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax

torch.set_num_threads(1)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# utils.stats
# ---------------------------------------------------------------------------

SAMPLES = [0.3, 0.1, 5.0, 0.2, 0.2, 0.9, 1.7, 0.05, 3.3, 0.4, 0.4, 12.0]
STATS_CASES = [
    ("nearest_rank", (SAMPLES, 0.5)), ("nearest_rank", (SAMPLES, 0.99)), ("percentiles", (SAMPLES,)),
    ("histogram_quantile", ([0.1, 0.2, 0.4, 0.8], [1, 4, 6, 9, 10], 0.95)),
    ("histogram_percentiles", ([0.1, 0.2, 0.4, 0.8], [2, 3, 3, 7, 7])),
    ("median", (SAMPLES,)), ("mad", (SAMPLES,)), ("robust_z", (4.0, SAMPLES)), ("robust_z", (1.0, [1.0] * 5)),
    ("changepoint_split", ([1, 1, 1.1, 0.9, 1, 5, 5.2, 4.9, 5, 5.1],)),
    ("window_anchor_index", ([0.0, 1.0, 2.5, 4.0], 2.6)), ("window_anchor_index", ([3.0, 4.0], 1.0)),
]


@pytest.mark.parametrize("name,args", STATS_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(STATS_CASES)])
def test_stats_match_jax(name, args):
    assert getattr(stats, name)(*args) == getattr(jstats, name)(*args)


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["latency_p95=2s,availability=99.9", "latency_p99=500ms", "availability=99"])
def test_parse_slos_matches_jax(spec):
    assert [vars(s) for s in slo.parse_slos(spec)] == [vars(s) for s in jslo.parse_slos(spec)]


@pytest.mark.parametrize("bad", ["", "latency_p95", "latency_p100=1s", "availability=100", "speed=3"])
def test_parse_slos_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        jslo.parse_slos(bad)
    with pytest.raises(ValueError):
        slo.parse_slos(bad)


def _serve_events():
    """(t, ok requests with their latencies, errors) per tick."""
    return [(0.0, [0.1] * 50, 0), (30.0, [0.2] * 20 + [3.0] * 10, 12), (60.0, [0.1] * 40, 0),
            (400.0, [0.05] * 300, 0), (4000.0, [5.0] * 5, 5), (4010.0, [0.1] * 1000, 0)]


def test_serve_slo_burn_ticks_match_jax():
    spec = "latency_p95=2s,availability=99.9"
    sides = []
    for mod, Reg in ((jslo, JRegistry), (slo, MetricsRegistry)):
        clock, reg = Clock(), Reg(prefix="")
        sides.append((clock, reg, mod.build_serve_evaluator(spec, reg, clock=clock, stream=io.StringIO())))
    outs = [[], []]
    for t, lats, errs in _serve_events():
        for side, (clock, reg, ev) in enumerate(sides):
            clock.t = t
            for lat in lats:
                reg.inc("serve_requests")
                reg.observe("serve_request_latency_seconds", lat)
            reg.inc("serve_request_errors", errs)
            outs[side].append((ev.tick(), ev.alerting, ev.registry.snapshot(), ev.max_burn("fast"),
                               ev.max_burn("slow")))
    assert outs[0] == outs[1]
    assert any(a["availability"] for _, a, *_ in outs[1]) and not outs[1][-1][1]["latency_p95"]


# ---------------------------------------------------------------------------
# Prometheus text
# ---------------------------------------------------------------------------

def _fill(reg):
    reg.inc("serve_requests", 7)
    reg.inc("serve_request_errors")
    reg.gauge("serve/queue_depth", 3)
    reg.gauge("serve/pressure_rung", float("nan"))
    reg.gauge("verdict", "memory-bound")
    for v in (0.0004, 0.003, 0.05, 0.05, 1.5, 400.0):
        reg.observe("serve_request_latency_seconds", v)
    reg.observe("serve_dispatch_seconds", 0.066)
    return reg


def test_render_prometheus_matches_jax():
    extra = {"serve_adapter_hotness": {"labeled": [({"adapter": 'synth-"1"'}, 4), ({"adapter": "b"}, 2)]},
             "serve/adapters_seen": 2}
    texts = []
    for mod, Reg in ((jexporter, JRegistry), (exporter, MetricsRegistry)):
        exp = _fill(Reg(prefix="obs/")).export()
        texts.append(mod.render_prometheus(exp["counters"], {**exp["gauges"], **extra}, exp["histograms"]))
    assert texts[0] == texts[1]
    # repr: the NaN gauge parses to NaN on both sides
    assert repr(exporter.parse_prometheus_text(texts[1])) == repr(jexporter.parse_prometheus_text(texts[0]))
    assert 'serve_request_latency_seconds_bucket{le="+Inf"} 6' in texts[1]
    with pytest.raises(ValueError):
        exporter.parse_prometheus_text("not a metric line at all {")


# ---------------------------------------------------------------------------
# the overload governor
# ---------------------------------------------------------------------------

def _governor_trace(mod):
    clock = Clock()
    cfg = mod.OverloadConfig(escalate_after=2, recover_after=2, breaker_faults=2, breaker_cooldown_s=5.0)
    gov = mod.OverloadGovernor(cfg, clock=clock)
    out = []
    req = type("R", (), {})()
    req.geometry_key = (1, None)
    for step, (depth, burn, evictions) in enumerate([(900, None, 0), (900, None, 0), (10, 20.0, 0), (10, 20.0, 0),
                                                     (10, None, 50), (0, None, 50), (0, None, 50), (0, None, 50),
                                                     (600, 3.0, 50), (0, 0.1, 50), (0, 0.1, 50)]):
        out.append(("rung", gov.evaluate(depth, 1024, burn, evictions), gov.controller.rung_name))
        gov.ewma.observe((1, None), 0.05 * (step + 1))
        req.t_deadline = 1.0 + 0.1 * step
        out.append(("doom", gov.doom_reason(req, 0.9 + 0.05 * step), round(gov.ewma.get((1, None)), 9)))
    for aid, event, t in [("a", "fault", 0.0), ("a", "allow", 0.1), ("a", "fault", 0.2), ("a", "allow", 0.3),
                          ("a", "allow", 6.0), ("a", "allow", 6.1), ("a", "fault", 6.2), ("a", "allow", 12.0),
                          ("a", "abort", 12.1), ("a", "allow", 12.2), ("a", "ok", 12.3), ("b", "fault", 13.0),
                          ("a", "allow", 13.1)]:
        clock.t = t
        if event == "fault":
            out.append((aid, event, gov.breaker.record_fault(aid)))
        elif event == "allow":
            out.append((aid, event, gov.breaker.allow(aid)))
        elif event == "abort":
            gov.breaker.abort_probe(aid)
        else:
            gov.breaker.record_ok(aid)
        out.append((aid, "state", gov.breaker.state(aid)))
    for reason in ("deadline", "doomed", "deadline", "breaker_open"):
        gov.count_shed(reason)
    out.append(("metrics", gov.metrics(), gov.pressure_view(5, 1024, 3), gov.shed_total()))
    return out


def test_governor_decisions_match_jax():
    assert _governor_trace(overload) == _governor_trace(joverload)


# ---------------------------------------------------------------------------
# batcher and store
# ---------------------------------------------------------------------------

def _queue_trace(mod):
    q = mod.RequestQueue(max_depth=8)
    reqs = []
    for i, (ids, g, dl) in enumerate([((0,), None, 5.0), ((1, 2), None, None), ((3,), None, 1.0),
                                      ((4,), 2.0, 2.0), ((5,), None, 0.5), ((6,), None, None)]):
        r = mod.ServeRequest(adapter_id=f"a{i}", prompt_ids=ids, seed=i, guidance=g)
        r.t_submit = 100.0 + i
        r.t_deadline = None if dl is None else r.t_submit + dl
        reqs.append(q.submit(r))
    out = [[r.queue_position for r in reqs]]
    out.append([r.adapter_id for r in q.prune(lambda r: r.t_deadline is not None and r.t_deadline < 104.0)])
    out.append([r.adapter_id for r in q.take_batch(2)])
    out.append([r.adapter_id for r in q.prune(lambda r: r.guidance is not None)])
    out.append([r.adapter_id for r in q.drain()])
    out.append((q.depth, q.prune(lambda r: True), [r.priority for r in reqs], [r.finalized for r in reqs]))
    return out


def test_batcher_deadlines_and_prune_match_jax():
    assert _queue_trace(batcher) == _queue_trace(jbatcher)


def _tree(seed):
    g = np.random.default_rng(seed)
    return {"blocks/attn1/to_q": {"a": g.normal(size=(2, 8, 2)).astype(np.float32),
                                  "b": g.normal(size=(2, 2, 8)).astype(np.float32)}}


def _store_trace(store, to_tree):
    one = adapter_bytes(adapter_from_jax(_tree(0), "cpu"))
    store.budget_bytes = int(2.5 * one)
    out = []
    for step in [("put", "a"), ("put", "b"), ("lease", "a"), ("put", "c"), ("put", "d"), ("release", "a"),
                 ("put", "e"), ("evict", "b"), ("lease", "e"), ("evict", "e"), ("evict_force", "e"), ("get", "d"),
                 ("put", "f"), ("release", "zz")]:
        op, aid = step
        if op == "put":
            store.put(aid, to_tree(_tree(ord(aid))))
        elif op == "lease":
            out.append(store.lease(aid))
        elif op == "release":
            out.append(store.release(aid))
        elif op == "evict":
            out.append(store.evict(aid))
        elif op == "evict_force":
            out.append(store.evict(aid, force=True))
        else:
            store.get(aid)
        out.append((op, aid, store.ids(), store.leases_active, store.lease_blocked, store.evictions))
    st = store.stats()
    out.append({k: st[k] for k in ("resident", "hits", "misses", "evictions", "leases_active",
                                    "lease_blocked_evictions")})
    out.append({aid: e["version"] for aid, e in st["adapters"].items()})
    return out


def test_store_lease_and_eviction_order_match_jax():
    theirs = _store_trace(jstore_mod.AdapterStore(), lambda t: t)
    ours = _store_trace(AdapterStore(registry=MetricsRegistry(prefix="")), lambda t: adapter_from_jax(t, "cpu"))
    assert ours == theirs
    with pytest.raises(KeyError):
        AdapterStore().lease("ghost")


def test_parse_serve_geometry_and_extrapolation():
    from hyperscalees_t2i_tpu.serve.admission import parse_serve_geometry as jparse

    for spec in ("flagship:4", "tiny:16:8"):
        assert parse_serve_geometry(spec) == jparse(spec)
    for bad in ("tiny", "tiny:x", "tiny:0", "a:1:2:3"):
        with pytest.raises(ValueError):
            parse_serve_geometry(bad)
    assert extrapolate({1: 10.0, 2: 14.0}, 4) == 22.0 and extrapolate({1: 10.0, 2: 9.0}, 8) == 10.0
    assert extrapolate({1: 10.0}, 2) == 20.0  # one probe: an upper bound
    assert probe_lanes(1) == () and probe_lanes(2) == (1,) and probe_lanes(4) == (1, 2)


# ---------------------------------------------------------------------------
# the engine on the tiny rung
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def backend():
    return build_serve_backend(sana_rung_model("tiny")["bcfg"], "off", device="cpu",
                               prompts=["a red cube", "a blue sphere", "a green cone"])


@pytest.fixture(scope="module")
def jax_backend():
    from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackend as JSanaBackend
    from hyperscalees_t2i_tpu.rungs import sana_rung_model as jrung

    b = JSanaBackend(jrung("tiny")["bcfg"])
    b.setup()
    return b


def _jax_tenant(template, i):
    return jax.tree_util.tree_map(
        lambda x, k=jax.random.fold_in(jax.random.PRNGKey(7), i): x + 0.01 * jax.random.normal(k, x.shape, x.dtype),
        template)


def _spied(backend):
    """A copy of ``backend`` (its modules shared, no remembered estimate)
    whose ``generate_p`` records the lanes of every call."""
    seen = []
    spy = copy.copy(backend)
    real = backend.generate_p

    def generate_p(theta, ids, keys, *args, **kwargs):
        seen.append(int(ids.shape[0]))
        return real(theta, ids, keys, *args, **kwargs)

    spy.generate_p = generate_p
    return spy, seen


def test_admission_refuses_under_an_override_budget_in_both(backend, jax_backend):
    from hyperscalees_t2i_tpu.serve import ServeAdmissionError as JAdmissionError
    from hyperscalees_t2i_tpu.serve import ServeConfig as JServeConfig
    from hyperscalees_t2i_tpu.serve import ServeEngine as JServeEngine

    jeng = JServeEngine(jax_backend, JServeConfig(adapter_batch=2, hbm_budget_bytes=1))
    jeng.put_adapter("t0", jeng.template)
    with pytest.raises(JAdmissionError, match="REFUSED") as jerr:
        jeng.generate("t0", [0], seed=1)
    spy, seen = _spied(backend)
    eng = ServeEngine(spy, ServeConfig(adapter_batch=2, hbm_budget_bytes=1, device="cpu"))
    eng.put_adapter("t0", eng.template)
    with pytest.raises(ServeAdmissionError, match="REFUSED") as err:
        eng.generate("t0", [0], seed=1)
    for e in (err.value, jerr.value):
        assert e.peak_bytes > e.budget_bytes == 1.0 and "GB" in str(e) and "budget" in str(e)
        assert e.budget_source == "configured hbm_budget_bytes"
    # nothing was built or run at full width: the one probe ran 1 lane
    assert seen == [1]
    assert eng.programs.entries == {} and "serve_compiles" not in eng.registry.snapshot()
    rec = eng.stats()["admission"]["serve_a2b1"]
    assert set(rec["probe_bytes"]) == {1} and rec["estimate_bytes"] > rec["base_bytes"] > 0
    # a generous budget admits, and the measured bytes sit beside the estimate
    ok = ServeEngine(backend, ServeConfig(adapter_batch=2, hbm_budget_bytes=1 << 40, device="cpu"))
    assert ok.warmup() == ["serve_a2b1"]
    rec = ok.stats()["admission"]["serve_a2b1"]
    assert rec["armed"] and rec["measured_bytes"] > rec["base_bytes"]
    # the CPU has no card budget: unarmed, recorded as such
    off = ServeEngine(backend, ServeConfig(adapter_batch=2, device="cpu"))
    off.warmup()
    assert off.stats()["hbm_budget_source"] == "unknown (gate unarmed)"
    assert off.stats()["admission"]["serve_a2b1"]["armed"] is False


@pytest.mark.parametrize("lanes", [2, 4])
def test_admission_probes_run_below_adapter_batch(backend, lanes):
    spy, seen = _spied(backend)
    eng = ServeEngine(spy, ServeConfig(adapter_batch=lanes, hbm_budget_bytes=1 << 40, device="cpu"))
    label = eng.warmup()[0]
    # the probes, then the one build at full width
    assert seen == list(probe_lanes(lanes)) + [lanes] and all(n < lanes for n in seen[:-1])
    rec = eng.stats()["admission"][label]
    assert rec["armed"] and set(rec["probe_bytes"]) == set(probe_lanes(lanes))
    assert rec["estimate_bytes"] >= rec["measured_bytes"] > rec["base_bytes"] > 0
    # a second engine on the backend decides from the remembered estimate
    again = ServeEngine(spy, ServeConfig(adapter_batch=lanes, hbm_budget_bytes=1, device="cpu"))
    again.put_adapter("t0", again.template)
    with pytest.raises(ServeAdmissionError):
        again.generate("t0", [0], seed=1)
    assert len(seen) == len(probe_lanes(lanes)) + 1 and again.programs.entries == {}


def test_admission_at_one_lane_measures_the_build(backend):
    spy, seen = _spied(backend)
    eng = ServeEngine(spy, ServeConfig(adapter_batch=1, hbm_budget_bytes=1, device="cpu"))
    eng.put_adapter("t0", eng.template)
    # nothing smaller to probe: the build runs once, its bytes refuse it
    with pytest.raises(ServeAdmissionError, match="REFUSED") as err:
        eng.generate("t0", [0], seed=1)
    assert seen == [1] and eng.programs.entries == {}
    rec = eng.stats()["admission"]["serve_a1b1"]
    assert err.value.peak_bytes == rec["measured_bytes"] > rec["base_bytes"] > 0 and "probe_bytes" not in rec
    # the measured bytes are remembered: a second engine refuses without running
    again = ServeEngine(spy, ServeConfig(adapter_batch=1, hbm_budget_bytes=1, device="cpu"))
    again.put_adapter("t0", again.template)
    with pytest.raises(ServeAdmissionError):
        again.generate("t0", [0], seed=1)
    assert seen == [1]
    ok = ServeEngine(spy, ServeConfig(adapter_batch=1, hbm_budget_bytes=1 << 40, device="cpu"))
    ok.warmup()
    rec = ok.stats()["admission"]["serve_a1b1"]
    assert rec["armed"] and rec["estimate_bytes"] == rec["measured_bytes"] and seen == [1, 1]


def _thrash(make_engine, put, template, tenants, overload_cfg):
    eng = make_engine(overload_cfg)
    for i, aid in enumerate(["t0", "t1", "t2", "t3"]):
        put(eng, aid, tenants[i])
        eng.submit(aid, [0], seed=i)
    results = eng.flush()
    return [r.ok for r in results], eng.overload_snapshot()


def test_thrash_scenario_matches_jax_and_leases_zero_refusals(backend, jax_backend):
    from hyperscalees_t2i_tpu.serve import OverloadConfig as JOverloadConfig
    from hyperscalees_t2i_tpu.serve import ServeConfig as JServeConfig
    from hyperscalees_t2i_tpu.serve import ServeEngine as JServeEngine
    from hyperscalees_t2i_tpu.serve import adapter_bytes as jadapter_bytes

    jtemplate = jax_backend.init_theta(jax.random.PRNGKey(0))
    jtenants = [_jax_tenant(jtemplate, i) for i in range(4)]
    jbudget = int(2.5 * jadapter_bytes(jtemplate))
    template = backend.init_theta(threefry.prng_key(0, "cpu"))
    tenants = [adapter_from_jax(jax.tree_util.tree_map(np.asarray, t), "cpu") for t in jtenants]
    budget = int(2.5 * adapter_bytes(template))
    assert budget == jbudget
    for on in (False, True):
        j_ok, j_snap = _thrash(
            lambda ov: JServeEngine(jax_backend, JServeConfig(adapter_batch=4, adapter_budget_bytes=jbudget,
                                                              overload=ov), theta_template=jtemplate),
            lambda e, a, t: e.put_adapter(a, t), jtemplate, jtenants, JOverloadConfig() if on else None)
        p_ok, p_snap = _thrash(
            lambda ov: ServeEngine(backend, ServeConfig(adapter_batch=4, adapter_budget_bytes=budget, overload=ov,
                                                        device="cpu")),
            lambda e, a, t: e.put_adapter(a, t), template, tenants, OverloadConfig() if on else None)
        assert p_ok == j_ok
        for k in ("enabled", "not_resident_refusals", "leases_active", "lease_blocked_evictions", "shed_total"):
            assert p_snap[k] == j_snap[k], k
        if on:
            assert p_snap["not_resident_refusals"] == 0 and all(p_ok) and p_snap["lease_blocked_evictions"] >= 1
        else:
            assert p_snap["not_resident_refusals"] >= 1 and not all(p_ok)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def test_overload_on_batched_equals_solo_and_the_exporter_serves(backend):
    eng = ServeEngine(backend, ServeConfig(adapter_batch=3, member_batch=0, device="cpu", overload=OverloadConfig(),
                                           slo="latency_p95=2s,availability=99.9", metrics_port=_free_port(),
                                           metrics_host="127.0.0.1"))
    try:
        template = eng.template
        for i in range(3):
            eng.put_adapter(f"t{i}", {k: {f: t + 0.05 * threefry.normal(threefry.fold_in(threefry.prng_key(3, "cpu"),
                                                                                         i), tuple(t.shape))
                                          for f, t in d.items()} for k, d in template.items()})
        reqs = [eng.submit(f"t{i % 3}", [i % 3], seed=10 + i) for i in range(5)]
        res = eng.flush()
        assert [r.request.request_id for r in res] == [r.request_id for r in reqs] and all(r.ok for r in res)
        for r in res:
            solo = eng.generate(r.request.adapter_id, r.request.prompt_ids, r.request.seed)
            np.testing.assert_array_equal(solo, r.images)
        assert eng.store.leases_active == 0 and eng.overload_snapshot()["not_resident_refusals"] == 0
        # deadlines: an expired one is shed at submit, with a typed refusal
        with pytest.raises(ServeShedError) as shed:
            eng.submit("t0", [0], seed=1, deadline_s=-1.0)
        assert shed.value.reason == "deadline"
        parsed = exporter.parse_prometheus_text(_get(eng.exporter.port, "/metrics"))
        served = 10  # 5 batched + 5 solo
        assert parsed["serve_request_latency_seconds_count"][0][1] == served
        assert parsed["serve_request_latency_seconds_bucket"][-1] == ({"le": "+Inf"}, float(served))
        for name in ("serve_queue_wait_seconds_count", "serve_dispatch_seconds_count",
                     "serve_batch_assembly_seconds_count", "serve_requests", "slo_availability_burn_fast",
                     "serve_shed_reason", "serve_adapter_hotness", "serve_leases_active"):
            assert name in parsed, name
        health = json.loads(_get(eng.exporter.port, "/healthz"))
        assert health["status"] == "ok" and health["serve"]["queue_depth"] == 0
        assert health["pressure"]["shed"] == {"deadline": 1}
        pct = eng.latency_percentiles()
        assert set(pct) == {"p50", "p95", "p99"} and eng.hot_adapters(1)[0][1] == 4
    finally:
        eng.close()
    assert eng.exporter is None


def test_abandon_and_refusal_accounting(backend):
    eng = ServeEngine(backend, ServeConfig(adapter_batch=2, device="cpu", max_queue=2, overload=OverloadConfig()))
    eng.put_adapter("t0", eng.template)
    eng.submit("t0", [0], seed=0)
    eng.submit("t0", [1], seed=1)
    with pytest.raises(Exception):
        eng.submit("t0", [0], seed=2)  # queue full
    assert eng.store.leases_active == 2
    gone = eng.abandon_queued()
    assert len(gone) == 2 and eng.store.leases_active == 0
    snap = eng.registry.snapshot()
    assert snap["serve_queue_abandoned"] == 2 and snap["serve_queue_rejected"] == 1
    assert snap["serve_request_errors"] == 1 and snap["serve_queue_wait_seconds"]["count"] == 3
    # finalize is exactly once
    assert not eng._finalize_request(gone[0], "abandon") and eng.registry.snapshot()["serve_finalize_duplicates"] == 1
    with pytest.raises(NotImplementedError, match="cannot be serialized"):
        ServeConfig(compile_cache_dir="x")
    with pytest.raises(NotImplementedError, match="item 10"):
        ServeConfig(profile_dir="x")


def test_load_adapter_from_a_training_runs_slot(backend, tmp_path):
    """``load_adapter`` reads a training run's newest slot (the port's
    writer, the format both packages restore); the version names its epoch
    and the content sha."""
    from hyperscalees_t2i_tpu_torch.serve.adapter_store import adapter_digest
    from hyperscalees_t2i_tpu_torch.train.checkpoints import save_checkpoint

    eng = ServeEngine(backend, ServeConfig(adapter_batch=2, device="cpu"))
    theta = {k: {f: t + 0.01 * (i + 1) for f, t in d.items()} for i, (k, d) in enumerate(eng.template.items())}
    save_checkpoint(tmp_path, theta, 3, 0.5, backend.name)
    version = eng.load_adapter("trained", tmp_path)
    assert version == f"epoch3:{adapter_digest(theta)}"
    assert eng.store.stats()["adapters"]["trained"]["source"] == str(tmp_path)
    assert eng.generate("trained", [0], seed=1).shape == (1, 32, 32, 3)
    with pytest.raises(FileNotFoundError):
        eng.load_adapter("missing", tmp_path / "nothing")
