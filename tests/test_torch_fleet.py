"""Fleet training in the port (``train.trainer.make_fleet_step``,
``parallel.pop_eval.make_fleet_evaluator``, ``train.fleet``) against the
port's own solo step and against the JAX package.

- Two tiny geometries, W = 2 jobs with their own σ, lr_scale and seed, every
  weight, θ₀ and draw from the seeds (nothing injected): the Sana backend
  of ``tests/test_trainer.py`` over an int8 base (``quantize_tree
  (min_size=0)`` on the DiT and the decoder: K3 at the adapted sites, K1 at
  the others, their plain versions here) with ``pop_fuse``, and the tiny
  VAR geometry over a float base with materialized members
  (``perturb_member``), both with a brightness reward. Each job's reward
  rows, θ′, Δθ, opt scores and metrics out of the fleet step are bitwise
  the port's solo step (``make_es_step``; rows from
  ``make_solo_reward_rows``), also when ``member_batch`` does not divide
  the population. Against the JAX package (its ``make_fleet_step`` and its
  solo ``make_es_step``) they agree within 3e-4, the golden bound;
  measured max abs error 2.1e-5 (the JAX fleet's own rows differ from its
  solo rows in the last bits on this jax build).
- σ as a program input: ``scaled``, ``perturb_member(sigma=)``,
  ``factored_member_theta(sigma=, c_scale=)`` and ``es_update(lr=)`` with
  ``f32`` tensors give the Python-float path's bits (f32 and bf16 leaves),
  ``fleet_scalar_args`` rounds ``σ/√r`` once where a device division of an
  f32 σ would round twice; a captured program (the capture stubbed by a
  recording function, as in ``tests/test_torch_dispatch.py``) serves a job
  swapped for one with another σ without a new capture, bitwise its solo
  step.
- Host pieces equal the JAX functions: ``jobwise_prompt_normalized_scores``
  (1e-4 against JAX, bitwise against the per-job solo call),
  ``fleet_scalar_args``, ``reward_rows_digest``, ``job_lane_spans``,
  ``cohort_mismatches``, ``parse_fleet_geometry``.
- ``FleetScheduler`` end to end: three jobs at ``max_width`` 2, the third
  joining after the first tick, each job's trajectory bitwise its solo
  steps, one program across the joins and leaves, the ``metrics.jsonl``
  line with the JAX scheduler's keys and values (3e-4), per-job slots that
  each package restores from the other, and the admission gate refusing
  under an override budget before anything is built.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.base import make_frozen
from hyperscalees_t2i_tpu.backends.var_backend import VarBackend as JVarBackend
from hyperscalees_t2i_tpu.backends.var_backend import VarBackendConfig as JVarConfig
from hyperscalees_t2i_tpu.es.sampling import epoch_key as jepoch_key
from hyperscalees_t2i_tpu.es.scoring import jobwise_prompt_normalized_scores as jjobwise
from hyperscalees_t2i_tpu.lora import stack_adapters as jstack
from hyperscalees_t2i_tpu.ops.quant import quantize_tree as jquantize_tree
from hyperscalees_t2i_tpu.resilience.checkpoints import CheckpointStore as JStore
from hyperscalees_t2i_tpu.train import fleet as jfleet
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import fleet_scalar_args as jfleet_scalar_args
from hyperscalees_t2i_tpu.train.trainer import make_es_step as jmake_es_step
from hyperscalees_t2i_tpu.train.trainer import make_fleet_step as jmake_fleet_step
from hyperscalees_t2i_tpu_torch.backends.var_backend import VarBackend
from hyperscalees_t2i_tpu_torch.es import noiser
from hyperscalees_t2i_tpu_torch.es.noiser import EggRollConfig, sample_noise
from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key
from hyperscalees_t2i_tpu_torch.es.scoring import jobwise_prompt_normalized_scores, prompt_normalized_scores
from hyperscalees_t2i_tpu_torch.lora import FactoredDelta, stack_adapters
from hyperscalees_t2i_tpu_torch.obs.metrics import MetricsRegistry
from hyperscalees_t2i_tpu_torch.resilience.checkpoints import CheckpointStore
from hyperscalees_t2i_tpu_torch.rungs import var_rung_model
from hyperscalees_t2i_tpu_torch.train import fleet
from hyperscalees_t2i_tpu_torch.train import trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils import graphs, threefry
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows
from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves, tree_map
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

from test_torch_trainer import _jax_backend, brightness, jax_brightness, port_backend
from test_torch_var import _jax_cfg

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
CPU = torch.device("cpu")
# (σ, lr_scale, seed) per job; 0.07/√2 is not an f32
JOBS = [(0.05, 2.0, 3), (0.07, 1.5, 9)]
GEOMETRY = {
    "sana-int8-fused": dict(pop_size=4, egg_rank=2, prompts_per_gen=2, member_batch=2, pop_fuse=True),
    "var-float-materialized": dict(pop_size=4, egg_rank=4, prompts_per_gen=4, member_batch=2, pop_fuse=False),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(theta):
    return torch.cat([t.reshape(-1) for t in tree_leaves(theta)])


def _jflat(theta):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in jax.tree_util.tree_leaves(theta)])


def _backends(kind, tmp_path):
    if kind.startswith("sana"):
        jb = _jax_backend(tmp_path)
        jb.setup()
        jb.params = jquantize_tree(jb.params, min_size=0)
        jb.vae_params = jquantize_tree(jb.vae_params, min_size=0)
        tb = port_backend(jb)
    else:
        jb = JVarBackend(JVarConfig(model=_jax_cfg()))
        jb.setup()
        tb = VarBackend(var_rung_model("tiny")["bcfg"], "cpu", params=tree_from_numpy(_np(jb.params), "cpu"))
    tb.setup()
    return jb, tb


def _tcs(kind, cls=TrainConfig, **kw):
    return [cls(sigma=s, lr_scale=lr, seed=seed, **{**GEOMETRY[kind], **kw}) for s, lr, seed in JOBS]


def port_solo(tb, tc, theta, prev, ids, key):
    """The port's solo epoch of one job: (rows, θ′, Δθ, metrics, opt)."""
    rows = fleet.make_solo_reward_rows(tb, brightness, tc)(theta, ids, key)
    step = trainer.make_es_step(tb, brightness, tc, len(ids) // tc.batches_per_gen, tc.batches_per_gen, CPU,
                                stateful_delta=True)
    return (rows,) + tuple(step(theta, prev, ids, key))


def port_fleet(tb, tcs, thetas, prevs, ids, keys, graphs_=None):
    step = trainer.make_fleet_step(tb, brightness, tcs[0], len(ids[0]), 1, len(tcs), CPU, graphs=graphs_)
    rows = [torch.from_numpy(x) for x in trainer.fleet_scalar_args(tcs)]
    return step(stack_adapters(thetas), stack_adapters(prevs), torch.tensor(ids), torch.stack(keys), *rows)


@pytest.fixture(scope="module", params=list(GEOMETRY))
def case(request, tmp_path_factory):
    kind = request.param
    jb, tb = _backends(kind, tmp_path_factory.mktemp(kind))
    jtcs, tcs = _tcs(kind, JTrainConfig), _tcs(kind)
    m = tcs[0].prompts_per_gen
    ids = jb.step_info(0, m, 1).flat_ids
    assert tb.step_info(0, m, 1).flat_ids == ids
    # JAX: one fleet execution, and each job's solo step
    frozen = make_frozen(jb, jax_brightness)
    jthetas = [jb.init_theta(jax.random.fold_in(jax.random.PRNGKey(t.seed), 17)) for t in jtcs]
    jkeys = [jepoch_key(t.seed, 0) for t in jtcs]
    stacked = jax.tree_util.tree_map(jnp.asarray, jstack([jax.device_get(t) for t in jthetas]))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, stacked)
    sig, csc, lrs = jfleet_scalar_args(jtcs)
    jfl = jmake_fleet_step(jb, jax_brightness, jtcs[0], m, 1, 2, donate=False)(
        frozen, stacked, zeros, jnp.asarray([ids, ids], jnp.int32), jnp.stack(jkeys), jnp.asarray(sig),
        jnp.asarray(csc), jnp.asarray(lrs))
    jsolo = []
    for t, th, k in zip(jtcs, jthetas, jkeys):
        step = jmake_es_step(jb, jax_brightness, t, m, 1, stateful_delta=True, donate=False)
        jsolo.append(_np(step(frozen, th, jax.tree_util.tree_map(jnp.zeros_like, th),
                              jnp.asarray(ids, jnp.int32), k)))
    # the port, from the same seeds
    thetas = [trainer._init_theta(tb, t, CPU) for t in tcs]
    keys = [epoch_key(t.seed, 0, CPU) for t in tcs]
    zeros_t = [tree_map(torch.zeros_like, th) for th in thetas]
    out = port_fleet(tb, tcs, thetas, zeros_t, [ids, ids], keys)
    solo = [port_solo(tb, t, th, z, ids, k) for t, th, z, k in zip(tcs, thetas, zeros_t, keys)]
    return dict(kind=kind, jb=jb, tb=tb, tcs=tcs, jtcs=jtcs, ids=ids, thetas=thetas, keys=keys,
                jfleet=_np(jfl), jsolo=jsolo, jthetas=_np(jthetas), fleet=out, solo=solo)


def _assert_fleet_is_solo(out, solo):
    theta_new, delta, metrics, opt = out
    rows = metrics["fleet_reward_rows"]
    assert rows.shape[0] == len(solo) and opt.shape[0] == len(solo)
    for j, (s_rows, s_theta, s_delta, s_metrics, s_opt) in enumerate(solo):
        assert fleet.reward_rows_digest(rows[j]) == fleet.reward_rows_digest(s_rows), j
        assert torch.equal(rows[j], s_rows)
        assert torch.equal(_flat(tree_map(lambda t, _j=j: t[_j], theta_new)), _flat(s_theta)), j
        assert torch.equal(_flat(tree_map(lambda t, _j=j: t[_j], delta)), _flat(s_delta)), j
        assert torch.equal(opt[j], s_opt)
        assert set(metrics) - {"fleet_reward_rows"} == set(s_metrics)
        for k, v in s_metrics.items():
            assert torch.equal(metrics[k][j], v), (j, k)


def test_fleet_step_is_bitwise_the_port_solo_step(case):
    _assert_fleet_is_solo(case["fleet"], case["solo"])
    # the two jobs really differ: σ, lr and seed are per job
    rows = case["fleet"][2]["fleet_reward_rows"]
    assert not torch.equal(rows[0], rows[1])


def test_fleet_step_matches_jax(case):
    jtheta, jdelta, jmetrics, jopt = case["jfleet"]
    theta_new, delta, metrics, opt = case["fleet"]
    np.testing.assert_allclose(metrics["fleet_reward_rows"].numpy(), jmetrics["fleet_reward_rows"], **TOL)
    np.testing.assert_allclose(opt.numpy(), jopt, **TOL)
    for j in range(2):
        got = _flat(tree_map(lambda t, _j=j: t[_j], theta_new)).numpy()
        np.testing.assert_allclose(got, _jflat(jax.tree_util.tree_map(lambda t, _j=j: t[_j], jtheta)), **TOL)
        np.testing.assert_allclose(got, _jflat(case["jsolo"][j][0]), **TOL)  # the JAX solo step's θ′
        np.testing.assert_allclose(opt[j].numpy(), case["jsolo"][j][3], **TOL)
        np.testing.assert_allclose(_flat(tree_map(lambda t, _j=j: t[_j], delta)).numpy(),
                                   _jflat(jax.tree_util.tree_map(lambda t, _j=j: t[_j], jdelta)), **TOL)
    shared = set(jmetrics) & set(metrics)
    assert shared == set(jmetrics)
    for k in shared:
        np.testing.assert_allclose(np.asarray(metrics[k], np.float64), np.asarray(jmetrics[k], np.float64),
                                   err_msg=k, **TOL)


def test_member_batch_not_dividing_the_population(case):
    """Each job's lanes are chunked as its solo population is: bitwise."""
    tb, ids = case["tb"], case["ids"]
    tcs = _tcs(case["kind"], member_batch=3)
    zeros = [tree_map(torch.zeros_like, th) for th in case["thetas"]]
    out = port_fleet(tb, tcs, case["thetas"], zeros, [ids, ids], case["keys"])
    solo = [port_solo(tb, t, th, z, ids, k) for t, th, z, k in zip(tcs, case["thetas"], zeros, case["keys"])]
    _assert_fleet_is_solo(out, solo)


def test_width_one_is_the_solo_step(case):
    tb, ids = case["tb"], case["ids"]
    tc, th, key = case["tcs"][1], case["thetas"][1], case["keys"][1]
    out = port_fleet(tb, [tc], [th], [tree_map(torch.zeros_like, th)], [ids], [key])
    _assert_fleet_is_solo(out, case["solo"][1:])


@pytest.fixture
def stubbed(monkeypatch):
    """Graphs "on" the CPU, the capture a recording function whose replay
    reruns the program on its static buffers (``tests/test_torch_dispatch.py``)."""
    captures = []

    def capture(fn, static_args, stream):
        captures.append(static_args)
        outputs = fn(*static_args)

        def replay():
            for out, new in zip(graphs._flatten(outputs)[0], graphs._flatten(fn(*static_args))[0]):
                out.copy_(new)

        return graphs.Captured(replay, outputs, 0.0, 0.0, 0)

    monkeypatch.setattr(graphs, "graphs_on", lambda device: True)
    monkeypatch.setattr(graphs, "capture", capture)
    return captures


def test_a_sigma_swap_is_an_input_change(case, stubbed):
    """A job swapped for one with another σ, lr and seed at the same width
    replays the captured program: no new capture, and the new job's epoch
    is bitwise its solo step."""
    tb, ids, tcs = case["tb"], case["ids"], case["tcs"]
    cache = graphs.GraphCache(CPU)
    zeros = [tree_map(torch.zeros_like, th) for th in case["thetas"]]
    out = port_fleet(tb, tcs, case["thetas"], zeros, [ids, ids], case["keys"], graphs_=cache)
    _assert_fleet_is_solo(out, case["solo"])
    assert len(stubbed) == 1
    tc_c = dataclasses.replace(tcs[1], sigma=0.031, lr_scale=0.7, seed=21)
    th_c = trainer._init_theta(tb, tc_c, CPU)
    key_c = epoch_key(tc_c.seed, 4, CPU)
    thetas, keys = [case["thetas"][0], th_c], [case["keys"][0], key_c]
    out = port_fleet(tb, [tcs[0], tc_c], thetas, zeros, [ids, ids], keys, graphs_=cache)
    assert len(stubbed) == 1 and len(cache.entries) == 1
    solo_c = port_solo(tb, tc_c, th_c, zeros[1], ids, key_c)
    _assert_fleet_is_solo(out, [case["solo"][0], solo_c])


# ---------------------------------------------------------------------------
# σ, c and lr as f32 inputs: the Python float's bits
# ---------------------------------------------------------------------------

def _theta(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"blk": {"a": torch.randn(6, 3, generator=g).to(dtype), "b": torch.randn(3, 5, generator=g).to(dtype),
                    "bias": torch.randn(5, generator=g).to(dtype)}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sigma, rank", [(0.07, 2), (0.013, 3), (0.05, 4), (1 / 3, 5)])
def test_tensor_sigma_and_lr_give_the_float_bits(dtype, sigma, rank):
    cfg = EggRollConfig(sigma=sigma, lr_scale=1.7, rank=rank)
    theta = _theta(dtype)
    noise = sample_noise(threefry.prng_key(5, "cpu"), theta, 6, cfg)
    sig, csc, lr = (torch.tensor(x) for x in trainer.fleet_scalar_args(
        [TrainConfig(sigma=sigma, lr_scale=1.7, egg_rank=rank)]))
    for k in range(6):
        a = noiser.perturb_member(theta, noise, k, 6, cfg)
        b = noiser.perturb_member(theta, noise, k, 6, cfg, sigma=sig[0])
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    for members in (1, [0, 3, 5]):
        a = noiser.factored_member_theta(theta, noise, members, 6, cfg)
        b = noiser.factored_member_theta(theta, noise, members, 6, cfg, sigma=sig[0], c_scale=csc[0])
        for f in ("a", "b", "bias"):
            x, y = a["blk"][f], b["blk"][f]
            if isinstance(x, FactoredDelta):
                assert torch.equal(x.c, y.c) and torch.equal(x.u, y.u) and torch.equal(x.w, y.w)
            else:
                assert torch.equal(x, y)
    fitness = torch.linspace(-1.0, 1.3, 6)
    a = noiser.es_update(theta, noise, fitness, 6, cfg)
    b = noiser.es_update(theta, noise, fitness, 6, cfg, lr=lr[0])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    with pytest.raises(ValueError, match="together"):
        noiser.factored_member_theta(theta, noise, 1, 6, cfg, sigma=sig[0])


def test_c_scale_rounds_once():
    """``fleet_scalar_args`` rounds σ/√r once from float64, as the solo
    constant does; dividing an f32 σ on the device rounds twice, and for
    these σ that gives other bits."""
    found = 0
    for sigma in np.linspace(0.001, 0.2, 400):
        sigma = float(sigma)
        _, csc, _ = trainer.fleet_scalar_args([TrainConfig(sigma=sigma, egg_rank=3)])
        twice = (torch.tensor(sigma, dtype=torch.float32) / torch.sqrt(torch.tensor(3.0))).item()
        assert csc[0] == np.float32(sigma / math.sqrt(3))
        found += np.float32(twice) != csc[0]
    assert found > 0


# ---------------------------------------------------------------------------
# host pieces against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("J, n, m", [(2, 6, 3), (3, 4, 2), (1, 8, 5)])
def test_jobwise_promptnorm(J, n, m):
    rng = np.random.default_rng(J * 100 + n * 10 + m)
    S = np.stack([rng.normal(50.0 * j, 1.0 + 100.0 * j, size=(n, m)) for j in range(J)]).astype(np.float32)
    S[0, 1, :] = S[0, 0, :]
    out = jobwise_prompt_normalized_scores(torch.from_numpy(S))
    jout = jjobwise(jnp.asarray(S))
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
    for j in range(J):
        for a, b in zip(out, prompt_normalized_scores(torch.from_numpy(S[j]))):
            assert torch.equal(a[j], b)
    if J > 1:  # pooled normalization is not the per-job one
        pooled = prompt_normalized_scores(torch.from_numpy(S.reshape(J * n, m)))[0]
        assert not torch.allclose(pooled[:n], out[0][0])
    with pytest.raises(ValueError, match="jobs"):
        jobwise_prompt_normalized_scores(torch.zeros(4, 3))


@pytest.mark.parametrize("jobs", [[(0.05, 2.0, 2), (0.08, 1.5, 2)], [(0.07, 1.0, 3), (1 / 3, 0.3, 5), (0.01, 1, 4)],
                                  [(0.013, 2.5, 7)]])
def test_fleet_scalar_args_match_jax(jobs):
    tcs = [TrainConfig(sigma=s, lr_scale=lr, egg_rank=r) for s, lr, r in jobs]
    jtcs = [JTrainConfig(sigma=s, lr_scale=lr, egg_rank=r) for s, lr, r in jobs]
    for a, b in zip(trainer.fleet_scalar_args(tcs), jfleet_scalar_args(jtcs)):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shape", [(4, 2), (8, 4), (3, 1)])
def test_reward_rows_digest_matches_jax(shape):
    rows = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    rows[0, 0] = np.nan
    d = jfleet.reward_rows_digest(rows)
    assert fleet.reward_rows_digest(rows) == d == fleet.reward_rows_digest(torch.from_numpy(rows))
    assert fleet.reward_rows_digest(rows.astype(np.float64)) == d  # f32 bytes whatever the input dtype
    assert fleet.reward_rows_digest(rows + 1) != d


@pytest.mark.parametrize("width, pop", [(1, 4), (2, 4), (3, 8), (4, 16)])
def test_job_lane_spans_match_jax(width, pop):
    assert fleet.job_lane_spans(width, pop) == jfleet.job_lane_spans(width, pop)
    with pytest.raises(ValueError):
        fleet.job_lane_spans(0, pop)


def test_cohort_mismatches_and_geometry_parse_match_jax():
    assert fleet.COHORT_FIELDS == jfleet.COHORT_FIELDS
    for change in (dict(pop_size=8, member_batch=8), dict(sigma=0.5, lr_scale=9.0, seed=999), dict(quality=False),
                   dict(pop_fuse=True, base_quant="int8"), dict(num_epochs=3, save_every=2)):
        a = fleet.cohort_mismatches(dataclasses.replace(TrainConfig(), **change), TrainConfig())
        b = jfleet.cohort_mismatches(dataclasses.replace(JTrainConfig(), **change), JTrainConfig())
        assert a == b
    for spec in ("flagship:2", " tiny : 4 "):
        assert fleet.parse_fleet_geometry(spec) == jfleet.parse_fleet_geometry(spec)
    for bad in ("flagship", "flagship:x", "flagship:0"):
        with pytest.raises(ValueError):
            fleet.parse_fleet_geometry(bad)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

SANA = "sana-int8-fused"


@pytest.fixture(scope="module")
def sana(tmp_path_factory):
    jb, tb = _backends(SANA, tmp_path_factory.mktemp("sched"))
    return jb, tb


def _job_tc(sigma, lr, seed, epochs, cls=TrainConfig):
    return cls(num_epochs=epochs, sigma=sigma, lr_scale=lr, seed=seed, save_every=1, **GEOMETRY[SANA])


def test_fleet_scheduler_end_to_end(sana, tmp_path, stubbed):
    jb, tb = sana
    reg = MetricsRegistry()
    specs = {"a": _job_tc(0.05, 2.0, 3, 3), "b": _job_tc(0.07, 1.5, 9, 2), "c": _job_tc(0.03, 1.0, 5, 3)}
    sched = fleet.FleetScheduler(tb, brightness, specs["a"], tmp_path / "fleet", max_width=2, device="cpu",
                                 registry=reg)
    sched.submit(fleet.FleetJobSpec("a", specs["a"]))
    sched.submit(fleet.FleetJobSpec("b", specs["b"]))
    with pytest.raises(fleet.FleetAdmissionError, match="pop_size"):
        sched.submit(fleet.FleetJobSpec("bad", dataclasses.replace(specs["a"], pop_size=8)))
    with pytest.raises(fleet.FleetAdmissionError, match="duplicate"):
        sched.submit(fleet.FleetJobSpec("a", specs["a"]))
    assert sched.tick()
    sched.submit(fleet.FleetJobSpec("c", specs["c"]))  # joins at the next boundary
    assert sched.run() == 3
    lines = read_jsonl_rows(tmp_path / "fleet" / "metrics.jsonl")
    assert [ln["fleet_width"] for ln in lines] == [2, 2, 2, 2]
    # fair share: c (epoch 0) runs with a at tick 1; b leaves after tick 2
    assert [sorted(k[:4] for k in ln if k.endswith("/job_id")) for ln in lines] == [
        ["job0", "job1"], ["job0", "job2"], ["job1", "job2"], ["job0", "job2"]]
    # one program for every job mix at width 2: a join and a leave captured nothing
    snap = reg.snapshot()
    assert len(stubbed) == 1 and snap["obs/fleet_compiles"] == 1 and snap["obs/fleet_leaves"] == 3
    assert snap["obs/fleet_traces"] == 1 + 1 + 3  # the warm-up, the capture, three stubbed replays
    assert snap["obs/fleet_width"] == 2 and snap["obs/job2/epoch"] == 3
    # each job's trajectory is its solo steps, bitwise
    for jid, tc in specs.items():
        st = sched.job_state(jid)
        assert st["done"] and st["epoch"] == tc.num_epochs
        theta = trainer._init_theta(tb, tc, CPU)
        delta = tree_map(torch.zeros_like, theta)
        for e in range(tc.num_epochs):
            ids = tb.step_info(e, 2, 1).flat_ids
            rows, theta, delta, _, _ = [tree_map(torch.clone, x) if isinstance(x, dict) else x
                                        for x in port_solo(tb, tc, theta, delta, ids, epoch_key(tc.seed, e, CPU))]
            assert st["rows_digests"][e] == fleet.reward_rows_digest(rows), (jid, e)
        assert torch.equal(_flat(sched.job_theta(jid)[0]), _flat(theta)), jid
        assert torch.equal(_flat(sched.job_theta(jid)[1]), _flat(delta)), jid
        # the job's slot, read by the JAX store
        res = JStore(tmp_path / "fleet" / "jobs" / jid).restore(_np(_jtheta(jb, tc)), with_delta=True)
        assert res.epoch == tc.num_epochs
        np.testing.assert_array_equal(_jflat(res.theta), _flat(theta).numpy())
    assert set(sched.registry_store.ids()) == {"a", "b", "c"}


def _jtheta(jb, tc):
    return jb.init_theta(jax.random.fold_in(jax.random.PRNGKey(tc.seed), 17))


def test_scheduler_line_and_slots_as_the_jax_scheduler(sana, tmp_path):
    """One tick of two jobs in each package: the ``metrics.jsonl`` line has
    the JAX keys and values; each package restores the other's job slots."""
    jb, tb = sana
    tcs = [_job_tc(0.05, 2.0, 3, 1), _job_tc(0.07, 1.5, 9, 1)]
    jtcs = [_job_tc(0.05, 2.0, 3, 1, JTrainConfig), _job_tc(0.07, 1.5, 9, 1, JTrainConfig)]
    jsched = jfleet.FleetScheduler(jb, jax_brightness, jtcs[0], tmp_path / "jax", max_width=2)
    sched = fleet.FleetScheduler(tb, brightness, tcs[0], tmp_path / "port", max_width=2, device="cpu",
                                 registry=MetricsRegistry())
    for jid, jtc, tc in zip("ab", jtcs, tcs):
        jsched.submit(jfleet.FleetJobSpec(jid, jtc))
        sched.submit(fleet.FleetJobSpec(jid, tc))
    assert jsched.run() == sched.run() == 1
    jline = read_jsonl_rows(tmp_path / "jax" / "metrics.jsonl")[0]
    line = read_jsonl_rows(tmp_path / "port" / "metrics.jsonl")[0]
    assert set(line) == set(jline)
    for k, v in jline.items():
        if k == "ts" or k.endswith("reward_rows_sha256"):
            continue
        if isinstance(v, str):
            assert line[k] == v, k
        else:
            np.testing.assert_allclose(line[k], v, err_msg=k, **TOL)
    for jid, tc in zip("ab", tcs):
        # the JAX job's slot through the port's restore, and the reverse
        port_res = sched.restore_job(jid, trainer._init_theta(tb, tc, CPU))
        jax_res = jsched.restore_job(jid, _jtheta(jb, tc))
        via_port = CheckpointStore(tmp_path / "jax" / "jobs" / jid).restore(trainer._init_theta(tb, tc, CPU),
                                                                            with_delta=True)
        via_jax = JStore(tmp_path / "port" / "jobs" / jid).restore(_np(_jtheta(jb, tc)), with_delta=True)
        assert port_res.epoch == jax_res.epoch == via_port.epoch == via_jax.epoch == 1
        np.testing.assert_array_equal(_flat(via_port.theta).numpy(), _jflat(jax_res.theta))
        np.testing.assert_array_equal(_jflat(via_jax.theta), _flat(port_res.theta).numpy())
        np.testing.assert_allclose(_flat(port_res.theta).numpy(), _jflat(jax_res.theta), **TOL)
        assert json.loads((tmp_path / "port" / "jobs" / jid / "ckpt" / "step_00000001" / "manifest.json")
                          .read_text())["topology"]["fleet_job"] == jid


def test_admission_refuses_under_an_override_budget_before_building(sana, tmp_path):
    _, tb = sana
    tc = _job_tc(0.05, 2.0, 3, 2)
    sched = fleet.FleetScheduler(tb, brightness, tc, tmp_path / "f", max_width=2, hbm_budget_bytes=1e3,
                                 peak_bytes_hint=1e6, device="cpu", registry=MetricsRegistry())
    with pytest.raises(fleet.FleetAdmissionError, match="memory no-fit"):
        sched.submit(fleet.FleetJobSpec("a", tc))
    assert not sched.programs.entries and not sched._pending and not (tmp_path / "f" / "jobs").exists()
    assert not sched.tick()
    # a measured width arms the gate without a hint
    sched = fleet.FleetScheduler(tb, brightness, tc, tmp_path / "g", max_width=2, hbm_budget_bytes=1e12,
                                 device="cpu", registry=MetricsRegistry())
    assert sched.submit(fleet.FleetJobSpec("a", tc))["armed"] is False  # nothing measured yet
    sched.submit(fleet.FleetJobSpec("b", dataclasses.replace(tc, seed=4)))
    sched.tick()
    measured = sched._peaks[2]
    assert measured > 0 and len(sched.programs.entries) == 1
    sched.hbm_budget_bytes = measured - 1
    with pytest.raises(fleet.FleetAdmissionError, match="memory no-fit"):
        sched.submit(fleet.FleetJobSpec("c", dataclasses.replace(tc, seed=6)))
    sched.hbm_budget_bytes = measured
    assert sched.submit(fleet.FleetJobSpec("c", dataclasses.replace(tc, seed=6)))["armed"] is True


def test_analyze_fleet_geometry_on_the_cpu():
    rec = fleet.analyze_fleet_geometry("tiny", 2, "cpu")
    assert rec["site"] == "fleet" and rec["fleet_width"] == 2 and rec["imgs_per_step"] == 2 * 4 * 4
    assert rec["peak_bytes"] == rec["base_bytes"] + rec["program_bytes"] > 0
    assert fleet.fleet_fit_verdict(rec)["verdict"] == "unverdicted"
    assert fleet.fleet_fit_verdict(rec, hbm_budget_bytes=rec["peak_bytes"])["verdict"] == "admitted"
    assert fleet.fleet_fit_verdict(rec, hbm_budget_bytes=rec["peak_bytes"] - 1)["verdict"] == "REFUSED"


def test_fleet_step_refusals(sana):
    _, tb = sana
    tc = _job_tc(0.05, 2.0, 3, 1)
    with pytest.raises(ValueError, match="width"):
        trainer.make_fleet_step(tb, brightness, tc, 2, 1, 0, CPU)
    with pytest.raises(RuntimeError):
        trainer.make_fleet_step(tb, brightness, tc, 2, 1, 2, "cuda")
    step = trainer.make_fleet_step(tb, brightness, tc, 2, 1, 2, CPU)
    th = stack_adapters([trainer._init_theta(tb, tc, CPU)] * 2)
    rows = [torch.from_numpy(x) for x in trainer.fleet_scalar_args([tc, tc])]
    with pytest.raises(ValueError, match="keys"):
        step(th, tree_map(torch.zeros_like, th), torch.zeros(2, 2, dtype=torch.long),
             torch.stack([epoch_key(0, 0, CPU)] * 3), *rows)
