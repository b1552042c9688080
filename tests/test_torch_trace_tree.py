"""The span tree and the trace-time counters against the JAX package's, on
the CPU at tiny sizes.

- The trainer: ``tests/test_obs.py``'s traced configuration (2 epochs, pop
  4, member_batch 4, seed 3) through both packages' ``run_training`` on the
  tiny Sana backend of ``tests/test_torch_trainer.py``. Both traces have the
  same set of ``(name, parent, depth)`` and the same attribute keys for each
  name; ``trace/pop_eval`` sits in ``compile`` with ``pop`` 4; the port's
  spans cover at least 0.90 of the run; both ``metrics.jsonl`` ends carry
  ``obs/pop_eval_traces`` (1 in each: the port's build is its one trace on
  the CPU) and the same ``obs/phase_*_seconds`` histograms.
- Serving: ``tests/test_serve.py``'s two requests through both engines
  (``adapter_batch`` 2) under the process's tracer: the same tree and
  attribute keys, ``serve/compile`` ⊃ ``trace/serve_batch`` before
  ``serve/batch`` ⊃ ``serve/dispatch``; after a warm-up a hot swap of three
  batches leaves ``obs/serve_traces`` and ``serve_compiles`` flat, as the
  JAX ``test_hot_swap_zero_compiles_after_warmup`` holds; a geometry's
  first batch without a warm-up runs its program once (its build).
- The fleet: one tick of two jobs in both schedulers: ``trace/fleet_eval``
  at the same place in both trees, in the port's build, and
  ``obs/fleet_traces`` 1 in both registries.
- A ``run_training`` that raises leaves the disabled tracer, no span
  observer and the process's own registry behind.
"""

import json

import jax
import pytest
import torch

from hyperscalees_t2i_tpu.obs import trace as jtrace
from hyperscalees_t2i_tpu.obs.metrics import MetricsRegistry as JRegistry
from hyperscalees_t2i_tpu.obs.metrics import get_registry as jget_registry
from hyperscalees_t2i_tpu.obs.metrics import set_registry as jset_registry
from hyperscalees_t2i_tpu.train import fleet as jfleet
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import run_training as jrun_training
from hyperscalees_t2i_tpu_torch.obs import metrics, trace
from hyperscalees_t2i_tpu_torch.tools import trace_report
from hyperscalees_t2i_tpu_torch.train import fleet, trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows

from test_torch_trainer import _jax_backend, brightness, jax_brightness, port_backend

torch.set_num_threads(1)
TRACED = dict(num_epochs=2, pop_size=4, sigma=0.05, egg_rank=2, promptnorm=False, prompts_per_gen=2, member_batch=4,
              save_every=2, log_hist_every=0, seed=3, trace=True)


def tree(events):
    return {(e["name"], e["parent"], e["depth"]) for e in events}


def attr_keys(events):
    keys = {}
    for e in events:
        keys.setdefault(e["name"], set()).update(e.get("attrs", {}))
    return keys


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    jrun_training(_jax_backend(root), jax_brightness, JTrainConfig(run_dir=str(root / "jax"), **TRACED))
    trainer.run_training(port_backend(), brightness, TrainConfig(run_dir=str(root / "port"), run_name="r", **TRACED),
                         device="cpu")
    jdir = next((root / "jax").iterdir())
    return {"jax": jdir, "port": root / "port" / "r"}


def test_trainer_span_tree_is_the_jax_tree(train_runs):
    jev, ev = jtrace.load_events(train_runs["jax"]), trace.load_events(train_runs["port"])
    assert tree(ev) == tree(jev)
    assert attr_keys(ev) == attr_keys(jev)
    assert {"setup", "epoch", "plan", "compile", "dispatch", "log", "checkpoint", "trace/pop_eval"} <= \
        {e["name"] for e in ev}
    assert sum(e["name"] == "dispatch" for e in ev) == sum(e["name"] == "epoch" for e in ev) == 2
    (pe,) = [e for e in ev if e["name"] == "trace/pop_eval"]
    assert (pe["parent"], pe["depth"], pe["attrs"]["pop"]) == ("compile", 2, 4)
    (comp,) = [e for e in ev if e["name"] == "compile"]
    assert (comp["parent"], comp["attrs"]) == ("epoch", {"m": 2, "r": 1})
    assert trace_report.coverage(ev) >= 0.90


def test_trainer_counters_and_phase_histograms(train_runs):
    jrow = read_jsonl_rows(train_runs["jax"] / "metrics.jsonl")[-1]
    row = read_jsonl_rows(train_runs["port"] / "metrics.jsonl")[-1]
    assert row["obs/pop_eval_traces"] == jrow["obs/pop_eval_traces"] == 1
    phases = {k for k in jrow if k.startswith("obs/phase_")}
    assert phases == {k for k in row if k.startswith("obs/phase_")} >= {"obs/phase_compile_seconds",
                                                                        "obs/phase_dispatch_seconds"}
    assert row["obs/phase_dispatch_seconds"]["count"] == jrow["obs/phase_dispatch_seconds"]["count"] == 2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_backends():
    from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackend as JSanaBackend
    from hyperscalees_t2i_tpu.rungs import sana_rung_model as jrung
    from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_serve_backend
    from hyperscalees_t2i_tpu_torch.rungs import sana_rung_model

    jb = JSanaBackend(jrung("tiny")["bcfg"])
    jb.setup()
    return jb, build_serve_backend(sana_rung_model("tiny")["bcfg"], "off", device="cpu",
                                   prompts=["a red cube", "a blue sphere", "a green cone"])


def _jax_adapters(jb, n):
    return {f"t{i}": jax.tree_util.tree_map(
        lambda x, k=jax.random.fold_in(jax.random.PRNGKey(100), i): x + 0.05 * jax.random.normal(k, x.shape, x.dtype),
        jb.init_theta(jax.random.fold_in(jax.random.PRNGKey(5), i))) for i in range(n)}


def _port_adapters(tb, n):
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    def tenant(i):
        key = threefry.fold_in(threefry.prng_key(7, "cpu"), i)
        return tree_map(lambda x: x + 0.05 * threefry.normal(key, tuple(x.shape)).to(x.dtype),
                        tb.init_theta(threefry.prng_key(i, "cpu")))

    return {f"t{i}": tenant(i) for i in range(n)}


def _two_requests(mod_trace, engine, path):
    mod_trace.set_tracer(mod_trace.Tracer(path))
    try:
        engine.submit("t0", [0], seed=1)
        engine.submit("t1", [1], seed=2)
        engine.flush()
    finally:
        mod_trace.set_tracer(None)
    return mod_trace.load_events(path)


def test_serving_span_chain_is_the_jax_chain(serve_backends, tmp_path):
    from hyperscalees_t2i_tpu.serve import ServeConfig as JServeConfig
    from hyperscalees_t2i_tpu.serve import ServeEngine as JServeEngine
    from hyperscalees_t2i_tpu_torch.serve import ServeConfig, ServeEngine

    jb, tb = serve_backends
    jeng = JServeEngine(jb, JServeConfig(adapter_batch=2, images_per_request=1))
    eng = ServeEngine(tb, ServeConfig(adapter_batch=2, images_per_request=1, device="cpu"))
    for e, ads in ((jeng, _jax_adapters(jb, 2)), (eng, _port_adapters(tb, 2))):
        for aid, th in ads.items():
            e.put_adapter(aid, th)
    jev = _two_requests(jtrace, jeng, tmp_path / "jax.jsonl")
    ev = _two_requests(trace, eng, tmp_path / "port.jsonl")
    assert tree(ev) == tree(jev)
    assert attr_keys(ev) == attr_keys(jev)
    order = [e["name"] for e in sorted(ev, key=lambda e: e["t0_s"]) if e["name"] != "serve/request"]
    assert order == ["serve/submit", "serve/submit", "serve/coalesce", "serve/compile", "trace/serve_batch",
                     "serve/batch", "serve/dispatch"]
    by = {e["name"]: e for e in ev}
    assert by["trace/serve_batch"]["parent"] == "serve/compile"
    assert by["serve/dispatch"]["parent"] == "serve/batch"
    assert by["serve/batch"]["attrs"]["program"] == by["serve/dispatch"]["attrs"]["program"] == \
        by["serve/compile"]["attrs"]["label"] == "serve_a2b1"


def test_hot_swap_leaves_serve_traces_flat(serve_backends):
    from hyperscalees_t2i_tpu_torch.serve import ServeConfig, ServeEngine

    _, tb = serve_backends
    reg = metrics.set_registry(metrics.MetricsRegistry())
    try:
        eng = ServeEngine(tb, ServeConfig(adapter_batch=2, images_per_request=1, device="cpu"))
        for aid, th in _port_adapters(tb, 6).items():
            eng.put_adapter(aid, th)
        eng.warmup()
        traces0, compiles0 = reg.value("serve_traces", 0), eng.registry.value("serve_compiles", 0)
        for pair in (("t0", "t1"), ("t2", "t3"), ("t4", "t5")):
            for aid in pair:
                eng.submit(aid, [0], seed=11)
            assert [r.batch_occupancy for r in eng.flush()] == [1.0, 1.0]
        assert traces0 == 1 and reg.value("serve_traces", 0) == traces0
        assert eng.registry.value("serve_compiles", 0) == compiles0 == 1
        assert eng.registry.value("serve_dispatches", 0) == 3
    finally:
        metrics.set_registry(None)


def test_first_batch_of_a_geometry_runs_its_program_once(serve_backends, monkeypatch):
    """A geometry not warmed up is built on its first batch's own inputs, and
    that build's output is the batch's: the program runs once, as it does
    for the next batch, and both batches' images are equal."""
    import numpy as np

    from hyperscalees_t2i_tpu_torch.serve import ServeConfig, ServeEngine

    _, tb = serve_backends
    calls = []
    real = tb.generate_p
    monkeypatch.setattr(tb, "generate_p", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    eng = ServeEngine(tb, ServeConfig(adapter_batch=2, images_per_request=1, device="cpu"))
    for aid, th in _port_adapters(tb, 2).items():
        eng.put_adapter(aid, th)
    runs = []
    for _ in range(2):
        before = len(calls)
        eng.submit("t0", [0], seed=1)
        eng.submit("t1", [1], seed=2)
        runs.append(([r.images for r in eng.flush()], len(calls) - before))
    assert runs[0][1] == runs[1][1] > 0
    assert all(np.array_equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert eng.registry.value("serve_compiles", 0) == 1


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def test_fleet_tick_opens_trace_fleet_eval_in_its_build(tmp_path):
    from hyperscalees_t2i_tpu.ops.quant import quantize_tree as jquantize_tree

    jb = _jax_backend(tmp_path)
    jb.setup()
    jb.params = jquantize_tree(jb.params, min_size=0)
    jb.vae_params = jquantize_tree(jb.vae_params, min_size=0)
    tb = port_backend(jb)
    tb.setup()
    geom = dict(num_epochs=1, save_every=1, pop_size=4, egg_rank=2, prompts_per_gen=2, member_batch=2, pop_fuse=True)
    jobs = [(0.05, 2.0, 3), (0.07, 1.5, 9)]
    jtcs = [JTrainConfig(sigma=s, lr_scale=lr, seed=sd, **geom) for s, lr, sd in jobs]
    tcs = [TrainConfig(sigma=s, lr_scale=lr, seed=sd, **geom) for s, lr, sd in jobs]
    jset_registry(JRegistry())
    jtrace.set_tracer(jtrace.Tracer(tmp_path / "jax.jsonl"))
    try:
        jsched = jfleet.FleetScheduler(jb, jax_brightness, jtcs[0], tmp_path / "jax", max_width=2)
        for jid, tc in zip("ab", jtcs):
            jsched.submit(jfleet.FleetJobSpec(jid, tc))
        assert jsched.run() == 1
        jtraces = jget_registry().snapshot()["obs/fleet_traces"]
    finally:
        jtrace.set_tracer(None)
        jset_registry(None)
    reg = metrics.MetricsRegistry()
    with trace.process_tracer(tmp_path / "port.jsonl"):
        sched = fleet.FleetScheduler(tb, brightness, tcs[0], tmp_path / "port", max_width=2, device="cpu",
                                     registry=reg)
        for jid, tc in zip("ab", tcs):
            sched.submit(fleet.FleetJobSpec(jid, tc))
        assert sched.run() == 1
    jev, ev = jtrace.load_events(tmp_path / "jax.jsonl"), trace.load_events(tmp_path / "port.jsonl")
    assert tree(ev) == tree(jev) == {("trace/fleet_eval", None, 0)}
    assert attr_keys(ev) == attr_keys(jev)
    (fe,) = ev
    assert fe["attrs"] == {"fleet_width": 2, "pop": 4, "member_batch": 2}
    # one trace in the JAX package; the port's step counts every run of its body (the CPU's one tick)
    assert reg.snapshot()["obs/fleet_traces"] == jtraces == 1


def test_a_crashed_run_leaves_no_tracer_or_observer(tmp_path):
    def crash(images, prompt_ids):
        raise RuntimeError("reward down")

    seen = []
    trace.set_span_observer(lambda name, dur: seen.append(name))  # replaced by the run's, reset after it
    tc = TrainConfig(run_dir=str(tmp_path), run_name="crash", **TRACED)
    with pytest.raises(RuntimeError, match="reward down"):
        trainer.run_training(port_backend(), crash, tc, device="cpu")
    assert not trace.get_tracer().enabled and trace._OBSERVER is None
    # the run's registry (its program counted before the warm-up raised) is not the process's any more
    assert metrics.get_registry().value("compiles", 0) == 0
    with trace.span("after"):
        pass
    assert seen == []
    names = [e["name"] for e in trace.load_events(tmp_path / "crash")]
    assert "setup" in names and "after" not in names
    assert json.loads((tmp_path / "crash" / "trace.jsonl").read_text().splitlines()[0])["meta"] == "trace_start"
