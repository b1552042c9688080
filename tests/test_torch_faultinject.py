"""The port's fault plan (``resilience.faultinject``) and its sites, against
the JAX package on the CPU.

- ``FaultPlan`` parses and fires as the JAX one: a grid of every epoch
  fault × epoch × host scope, consulted as each of two processes at every
  epoch (what fires, the disarm, ``next_armed_epoch``, the
  ``faults_injected`` counter), the ``*N`` counters of ``io_error``,
  ``slow_dispatch`` and ``store_io``, and the same refusals with the same
  messages.
- ``io_error:SITE*N`` fires before each retry attempt (the JAX
  ``retry.py:121`` site): the same retries and counters.
- ``HYPERSCALEES_FAULTS`` and ``HYPERSCALEES_SLOW_FAULT_S`` as the JAX
  module reads them.
- The serving sites, held on the port alone (the JAX
  ``test_overload.py::test_slow_dispatch_fault_inflates_ewma`` fails in
  every driver run): ``store_io*1`` fails exactly one request of a batch,
  every other request completes; ``slow_dispatch*2`` raises those two
  dispatches' ``dispatch_s`` by at least the injected sleep, and the
  overload layer's EWMA sees it.
"""

import itertools

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.obs import multihost as jmultihost
from hyperscalees_t2i_tpu.resilience import faultinject as jfi
from hyperscalees_t2i_tpu.resilience import telemetry as jtelemetry
from hyperscalees_t2i_tpu.resilience.retry import call_with_retry as jcall_with_retry
from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_serve_backend
from hyperscalees_t2i_tpu_torch.obs import multihost
from hyperscalees_t2i_tpu_torch.resilience import faultinject as fi
from hyperscalees_t2i_tpu_torch.resilience import telemetry
from hyperscalees_t2i_tpu_torch.resilience.retry import call_with_retry
from hyperscalees_t2i_tpu_torch.rungs import sana_rung_model
from hyperscalees_t2i_tpu_torch.serve.engine import ServeConfig, ServeEngine
from hyperscalees_t2i_tpu_torch.serve.overload import OverloadConfig
from hyperscalees_t2i_tpu_torch.utils import threefry

torch.set_num_threads(1)
EPOCH_FAULTS = ("preempt", "crash", "die", "nan_theta", "desync", "torn_write", "slow")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("HYPERSCALEES_RETRY_BASE_S", "0")
    monkeypatch.delenv("HYPERSCALEES_FAULTS", raising=False)
    for mod in (fi, jfi):
        mod.set_fault_plan(None)
    telemetry.set_resilience_registry(None)
    jtelemetry.set_resilience_registry(None)
    yield
    for mod in (fi, jfi):
        mod.set_fault_plan(None)
    multihost.set_process_index_override(None)
    jmultihost.set_process_index_override(None)
    telemetry.set_resilience_registry(None)
    jtelemetry.set_resilience_registry(None)


def _as_rank(rank):
    multihost.set_process_index_override(rank)
    jmultihost.set_process_index_override(rank)


def _injected(mod):
    return mod.get_resilience_registry().snapshot().get("resilience/faults_injected", 0)


@pytest.mark.parametrize("name", EPOCH_FAULTS)
def test_epoch_fault_grid_fires_as_jax(name):
    """Every (epoch, scope) of one fault and a second fault beside it, for
    each of two processes: the fires, the disarm and the chain clamp at
    every consult are the JAX plan's."""
    for armed, scope, rank in itertools.product(range(3), (None, 0, 1), (0, 1)):
        other = "crash" if name != "crash" else "slow"
        spec = f"{name}@{armed}" + ("" if scope is None else f":host{scope}") + f"; {other}@{armed + 2}:host1"
        _as_rank(rank)
        plan, jplan = fi.set_fault_plan(fi.FaultPlan.parse(spec)), jfi.set_fault_plan(jfi.FaultPlan.parse(spec))
        assert plan.epoch_faults == jplan.epoch_faults
        for epoch in range(5):
            assert plan.next_armed_epoch(epoch) == jplan.next_armed_epoch(epoch), (spec, rank, epoch)
            for f in (name, other):
                assert fi.fault_epoch(f, epoch) == jfi.fault_epoch(f, epoch), (spec, rank, f, epoch)
            assert plan.epoch_faults == jplan.epoch_faults
        assert _injected(telemetry) == _injected(jtelemetry)
        telemetry.set_resilience_registry(None)
        jtelemetry.set_resilience_registry(None)


@pytest.mark.parametrize("spec", [
    "io_error:ckpt_write*2", "io_error:ckpt_read", "io_error:weights*3:host1", "io_error:obs_write*2:host0",
    "slow_dispatch*2", "store_io*1:host1", "store_io*3; slow_dispatch; io_error:prompt_cache*2",
    "preempt@1;crash@5, nan_theta@2;io_error:ckpt_write*2; torn_write@3; die@4:host1; desync@6:host0",
])
def test_count_faults_parse_and_consume_as_jax(spec):
    for rank in (0, 1):
        _as_rank(rank)
        plan, jplan = fi.set_fault_plan(fi.FaultPlan.parse(spec)), jfi.set_fault_plan(jfi.FaultPlan.parse(spec))
        assert (plan.epoch_faults, plan.io_faults, plan.serve_faults) == \
            (jplan.epoch_faults, jplan.io_faults, jplan.serve_faults)
        for site in ("ckpt_write", "ckpt_read", "weights", "obs_write", "prompt_cache"):
            for _ in range(4):
                outcome = []
                for mod in (fi, jfi):
                    try:
                        mod.maybe_io_error(site)
                        outcome.append(None)
                    except OSError as e:
                        outcome.append(str(e))
                assert outcome[0] == outcome[1], (spec, rank, site)
        for name in ("slow_dispatch", "store_io"):
            assert [fi.maybe_serve_fault(name) for _ in range(4)] == [jfi.maybe_serve_fault(name) for _ in range(4)]
        assert _injected(telemetry) == _injected(jtelemetry)


@pytest.mark.parametrize("spec", ["meteor@3", "dye@3", "preempt", "preempt@x", "io_error:*2", "slow_dispatch@2",
                                  "preempt@1:hostA"])
def test_bad_tokens_raise_as_jax(spec):
    with pytest.raises(Exception) as jerr:
        jfi.FaultPlan.parse(spec)
    with pytest.raises(type(jerr.value)) as err:
        fi.FaultPlan.parse(spec)
    assert str(err.value) == str(jerr.value)


def test_io_error_fires_before_each_retry_attempt_as_jax():
    """``io_error:ckpt_write*2``: two injected failures, then the call; the
    same retries and counters in both packages."""
    results = []
    for mod, call, tmod in ((fi, call_with_retry, telemetry), (jfi, jcall_with_retry, jtelemetry)):
        mod.set_fault_plan(mod.FaultPlan.parse("io_error:ckpt_write*2"))
        calls = {"n": 0}

        def op():
            calls["n"] += 1
            return "written"

        assert call(op, site="ckpt_write", attempts=5) == "written"
        n, io = calls["n"], dict(mod.get_fault_plan().io_faults)
        # exhausted: three failures against three attempts
        mod.set_fault_plan(mod.FaultPlan.parse("io_error:ckpt_read*3"))
        with pytest.raises(OSError, match="injected transient I/O fault at 'ckpt_read'"):
            call(op, site="ckpt_read", attempts=3)
        results.append((n, io, tmod.get_resilience_registry().snapshot()))
    (n, io, snap), (jn, jio, jsnap) = results
    assert n == jn == 1 and io == jio == {"ckpt_write": 0}
    assert snap == jsnap and snap["resilience/retries"] == 4 and snap["resilience/retry_exhausted"] == 1


def test_env_spec_and_slow_seconds_as_jax(monkeypatch):
    monkeypatch.setenv("HYPERSCALEES_FAULTS", "preempt@2;io_error:ckpt_write*1")
    plan, jplan = fi.install_fault_plan(None), jfi.install_fault_plan(None)
    assert plan.epoch_faults == jplan.epoch_faults == {"preempt": {2: None}}
    assert plan.io_faults == jplan.io_faults == {"ckpt_write": 1}
    assert fi.install_fault_plan("crash@1").epoch_faults == jfi.install_fault_plan("crash@1").epoch_faults
    for v in ("0.5", "nonsense", None):
        if v is None:
            monkeypatch.delenv("HYPERSCALEES_SLOW_FAULT_S", raising=False)
        else:
            monkeypatch.setenv("HYPERSCALEES_SLOW_FAULT_S", v)
        assert fi.slow_fault_seconds() == jfi.slow_fault_seconds()


# ---------------------------------------------------------------------------
# the serving sites, on the port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_backend():
    return build_serve_backend(sana_rung_model("tiny")["bcfg"], "off", device="cpu",
                               prompts=["a red cube", "a blue sphere", "a green cone"])


def _engine(backend, n, overload=None):
    eng = ServeEngine(backend, ServeConfig(adapter_batch=4, device="cpu", overload=overload))
    for i in range(n):
        eng.put_adapter(f"t{i}", backend.init_theta(threefry.fold_in(threefry.prng_key(9, "cpu"), i)))
    return eng


def test_store_io_fails_one_request_not_the_batch(serve_backend):
    eng = _engine(serve_backend, 4)
    fi.set_fault_plan(fi.FaultPlan.parse("store_io*1"))
    reqs = [eng.submit(f"t{i}", [i % 3], seed=100 + i) for i in range(4)]
    res = eng.flush()
    assert [r.request.request_id for r in res if r.ok] == [r.request_id for r in reqs[1:]]
    failed = [r for r in res if not r.ok]
    assert len(res) == 4 and len(failed) == 1 and failed[0].request.request_id == reqs[0].request_id
    assert "injected store_io fault reading adapter 't0'" in failed[0].error
    assert eng.stats()["dispatches"] == 1  # the three others in one batch
    for r in res:
        if r.ok:
            assert r.images.shape == (1, 32, 32, 3) and np.isfinite(r.images).all()
            # a batch mate of the failed request is its solo image
            np.testing.assert_allclose(eng.generate(r.request.adapter_id, r.request.prompt_ids, r.request.seed),
                                       r.images, rtol=0, atol=1e-6)
    assert fi.get_fault_plan().serve_faults == {"store_io": 0}
    assert telemetry.get_resilience_registry().snapshot()["resilience/faults_injected"] == 1


def test_slow_dispatch_inflates_dispatch_s_and_the_ewma(serve_backend, monkeypatch):
    monkeypatch.setenv("HYPERSCALEES_SLOW_FAULT_S", "0.3")
    eng = _engine(serve_backend, 1, overload=OverloadConfig())
    ewma = eng._governor.ewma
    for i in range(2):  # the program's first dispatch, then a steady one
        eng.submit("t0", [0], seed=i)
        eng.flush()
    base = list(eng.dispatch_seconds)
    (key, before), = ewma._ewma.items()
    fi.set_fault_plan(fi.FaultPlan.parse("slow_dispatch*2"))
    predicted = []
    for i in range(3):
        eng.submit("t0", [0], seed=10 + i)
        eng.flush()
        predicted.append(ewma.get(key))
    slow, steady = eng.dispatch_seconds[len(base):len(base) + 2], eng.dispatch_seconds[-1]
    # the sleep is inside the timed dispatch: each slowed dispatch_s carries it
    assert all(s >= 0.3 for s in slow) and steady < 0.3 <= min(slow)
    assert min(slow) - base[-1] >= 0.3 - 0.05
    # the EWMA saw it: up by alpha × the sleep at least twice, then decaying
    assert predicted[0] - before >= ewma.alpha * 0.25 and predicted[1] - predicted[0] >= ewma.alpha * 0.15
    assert before < predicted[2] < predicted[1]
    assert fi.get_fault_plan().serve_faults == {"slow_dispatch": 0}
