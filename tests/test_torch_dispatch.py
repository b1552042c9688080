"""One program per step, on the CPU: chained dispatch (``steps_per_dispatch``)
in the port's ``run_training``, the graph cache's bookkeeping
(``utils.graphs``), serving's padded partial batches and
``tools/dispatch_tax.py``.

- ``run_training`` with ``steps_per_dispatch=4`` against the JAX package's,
  nothing injected, on the tiny Sana one-step backend (the chained run of
  ``tests/test_trainer.py``: 7 epochs, pop 6, member_batch 3, seed 11) and
  the tiny VAR backend (the seeded run of ``tests/test_torch_var_step.py``:
  pop 4, member_batch 2, seed 3, for 7 epochs), each package's backend
  built from its seed: chains [1, 4, 2] at epochs
  [0, 4, 6], θ and every shared value of the chain-end rows within 3e-4
  (the golden bound; the JAX package's ``obs/compiles`` counts its chained
  programs, the port's its one graph per plan). The port chained against
  its own ``steps_per_dispatch=1``: θ and the rows' values bitwise.
- Due boundaries: ``save_every=3`` breaks the chains as the JAX loop does.
- The cache, with the capture stubbed by a recording function here: an
  entry per key, a new argument value replays it, and the launch counters
  see the warm-up only: the cache adds nothing for a capture or a replay
  (on the card a replay's launches are counted on the device).
- A partial serving batch pads to the geometry's lanes; each request's
  image equals its solo image bitwise.
- ``dispatch_tax --rung tiny --device cpu`` prints a row with the JAX row's
  fields for the variants it runs.
"""

import json

import jax
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.var_backend import VarBackend as JVarBackend
from hyperscalees_t2i_tpu.backends.var_backend import VarBackendConfig as JVarConfig
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import run_training as jrun_training
from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_serve_backend
from hyperscalees_t2i_tpu_torch.backends.var_backend import VarBackend
from hyperscalees_t2i_tpu_torch.obs.metrics import MetricsRegistry
from hyperscalees_t2i_tpu_torch.ops.attention import decode_attention
from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul
from hyperscalees_t2i_tpu_torch.rungs import sana_rung_model, var_rung_model
from hyperscalees_t2i_tpu_torch.serve import ServeConfig, ServeEngine
from hyperscalees_t2i_tpu_torch.tools import dispatch_tax
from hyperscalees_t2i_tpu_torch.train import cli, trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils import graphs
from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves

from test_torch_serve import _adapters
from test_torch_trainer import CLOCK_KEYS, _jax_backend, brightness, jax_brightness, port_backend
from test_torch_var import _jax_cfg

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
# tests/test_trainer.py::test_steps_per_dispatch_chained_parity's run
CHAINED = dict(num_epochs=7, pop_size=6, sigma=0.05, lr_scale=1.5, egg_rank=2, antithetic=True, promptnorm=True,
               prompts_per_gen=2, batches_per_gen=1, member_batch=3, save_every=0, log_hist_every=0, seed=11,
               resume=False, run_name="chain")
# tests/test_torch_var_step.py::test_run_training_from_a_seed_matches_jax's
# run, for 7 epochs without slots
VAR_CHAINED = dict(CHAINED, pop_size=4, sigma=0.05, lr_scale=1.0, egg_rank=2, member_batch=2, seed=3)
# per-package counts of programs, not of work
PROGRAM_KEYS = {"obs/compiles", "obs/compile_cache_entries"}


def _flat(theta):
    return torch.cat([t.reshape(-1) for t in tree_leaves(theta)])


def _jax_flat(theta):
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(theta)])


def _backends(kind, tmp_path):
    """(the JAX backend, a maker of the port's, the run's settings)."""
    if kind == "sana":
        return _jax_backend(tmp_path), port_backend, CHAINED
    jb = JVarBackend(JVarConfig(model=_jax_cfg()))
    jb.setup()
    return jb, lambda: VarBackend(var_rung_model("tiny")["bcfg"], "cpu"), VAR_CHAINED


def _port_run(make_backend, tmp_path, base=CHAINED, **kw):
    history = []
    state = trainer.run_training(make_backend(), brightness,
                                 TrainConfig(run_dir=str(tmp_path), **{**base, **kw}),
                                 on_epoch_end=lambda e, s: history.append(s), device="cpu")
    return state, history


@pytest.fixture(scope="module", params=["sana", "var"])
def chained(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"chained_{request.param}")
    jb, make_port, base = _backends(request.param, root)
    jhist = []
    jstate = jrun_training(jb, jax_brightness, JTrainConfig(run_dir=str(root / "jax"), steps_per_dispatch=4,
                                                           **base), on_epoch_end=lambda e, s: jhist.append(s))
    p4 = _port_run(make_port, root / "port4", base, steps_per_dispatch=4)
    p1 = _port_run(make_port, root / "port1", base, steps_per_dispatch=1)
    return dict(jax=(jstate, jhist), port4=p4, port1=p1)


def _shared_values(a, b):
    return sorted(k for k in set(a) & set(b)
                  if k not in CLOCK_KEYS | PROGRAM_KEYS and k != "prompts" and not isinstance(a[k], dict))


def test_chained_run_training_matches_jax(chained):
    (jstate, jhist), (state, hist) = chained["jax"], chained["port4"]
    assert [h["epochs_chained"] for h in hist] == [h["epochs_chained"] for h in jhist] == [1, 4, 2]
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in jhist] == [0, 4, 6]
    assert state.epoch == jstate.epoch == 7
    np.testing.assert_allclose(_flat(state.theta).numpy(), _jax_flat(jstate.theta), **TOL)
    for h, jh in zip(hist, jhist):
        keys = _shared_values(h, jh)
        assert {"opt_score_mean", "theta_norm", "es/update_cosine", "obs/epochs_dispatched"} <= set(keys)
        assert h["prompts"] == jh["prompts"] and h["images_scored"] == jh["images_scored"]
        for k in keys:
            np.testing.assert_allclose(np.asarray(h[k], np.float64), np.asarray(jh[k], np.float64), err_msg=k,
                                       **TOL)
    assert hist[-1]["obs/dispatches"] == 3 and hist[-1]["obs/epochs_dispatched"] == 7


def test_chained_equals_unchained_bitwise(chained):
    (s4, h4), (s1, h1) = chained["port4"], chained["port1"]
    assert torch.equal(_flat(s4.theta), _flat(s1.theta))
    by_epoch = {h["epoch"]: h for h in h1}
    assert [h["epochs_chained"] for h in h1] == [1] * 7
    for h in h4:
        ref = by_epoch[h["epoch"]]
        for k in _shared_values(h, ref):
            if not k.startswith(("obs/", "resilience/")) and k not in ("epochs_chained", "images_scored"):
                assert h[k] == ref[k], k


def test_chain_respects_due_boundaries(tmp_path):
    """``tests/test_trainer.py::test_chain_respects_due_boundaries`` in the
    port: a slot due at epochs 2 and 5 → 0 | 1 | 2 | 3-4 | 5."""
    state, history = _port_run(port_backend, tmp_path, num_epochs=6, pop_size=4, lr_scale=1.0, egg_rank=1,
                               promptnorm=False, member_batch=2, save_every=3, seed=5, steps_per_dispatch=8)
    assert [h["epoch"] for h in history] == [0, 1, 2, 4, 5]
    assert [h["epochs_chained"] for h in history] == [1, 1, 1, 2, 1]
    assert state.epoch == 6 and (tmp_path / "chain" / "latest_theta.npz").exists()


def test_steps_per_dispatch_from_the_command_line():
    args = cli.build_parser().parse_args(["--backend", "sana_one_step", "--steps_per_dispatch", "4"])
    assert cli.train_config(args).steps_per_dispatch == 4


@pytest.fixture
def stubbed(monkeypatch):
    """Graphs "on" the CPU, the capture a recording function: it runs the
    function with the counters put back after, as a wrapper counts no
    capture, and ``replay`` reruns it into the captured outputs the same
    way, as a real replay runs no wrapper."""
    captures = []

    def uncounted(fn, args):
        before = (int8_matmul.launches, decode_attention.launches)
        out = fn(*args)
        int8_matmul.launches, decode_attention.launches = before
        return out

    def capture(fn, static_args, stream):
        captures.append(static_args)
        outputs = uncounted(fn, static_args)

        def replay():
            fresh = uncounted(fn, static_args)
            for out, new in zip(graphs._flatten(outputs)[0], graphs._flatten(fresh)[0]):
                out.copy_(new)

        return graphs.Captured(replay, outputs, 0.0, 0.0, 0)

    monkeypatch.setattr(graphs, "graphs_on", lambda device: True)
    monkeypatch.setattr(graphs, "capture", capture)
    return captures


def _program(adapter, ids):
    int8_matmul.launches += 2
    decode_attention.launches += 1
    return {"images": adapter["w"] * ids.sum(), "ids": ids + 1}


def test_graph_cache_keys_and_launch_counts(stubbed):
    registry = MetricsRegistry()
    cache = graphs.GraphCache("cpu", registry=registry)
    start = (int8_matmul.launches, decode_attention.launches)

    def counted():
        return (int8_matmul.launches - start[0], decode_attention.launches - start[1])

    ids = torch.arange(3)
    first = cache((2, 1), _program, {"w": torch.ones(4)}, ids)  # the warm-up's result, then the capture
    assert len(stubbed) == 1 and len(cache.entries) == 1 and counted() == (2, 1)  # the warm-up's launches
    assert torch.equal(first["images"], torch.full((4,), 3.0))
    assert set(cache.stats()["(2, 1)"]) == {"warmup_s", "capture_s", "instantiate_s", "pool_bytes",
                                            "workspace_bytes", "replays"}
    # a new adapter value is a new argument: a replay, no new entry
    out = cache((2, 1), _program, {"w": torch.full((4,), 2.0)}, torch.tensor([1, 1, 1]))
    assert torch.equal(out["images"], torch.full((4,), 6.0)) and torch.equal(out["ids"], torch.tensor([2, 2, 2]))
    again = cache((2, 1), _program, {"w": torch.full((4,), 5.0)}, ids)
    assert again["images"] is out["images"]  # the output buffers, overwritten by each replay
    assert torch.equal(again["images"], torch.full((4,), 15.0))
    assert len(stubbed) == 1 and counted() == (2, 1)  # a replay adds nothing to the counters
    assert cache.stats()["(2, 1)"]["replays"] == 2
    snap = registry.snapshot()
    assert snap["obs/compiles"] == 1 and snap["obs/compile_cache_entries"] == 1
    with pytest.raises(ValueError, match="structure, shape or dtype"):
        cache((2, 1), _program, {"w": torch.ones(5)}, ids)
    cache((4, 1), _program, {"w": torch.ones(4)}, ids)  # another plan: its own entry
    assert len(stubbed) == 2 and registry.snapshot()["obs/compiles"] == 2 and counted() == (4, 2)
    cache.clear()
    assert len(cache.entries) == 0 and registry.snapshot()["obs/compile_cache_entries"] == 0


def test_cpu_cache_runs_eagerly():
    """No graphs on the CPU: every call runs the function, which counts as
    a compile once per key."""
    registry = MetricsRegistry()
    cache = graphs.GraphCache("cpu", registry=registry)
    start = int8_matmul.launches
    for w in (1.0, 2.0, 3.0):
        out = cache("k", _program, {"w": torch.full((2,), w)}, torch.arange(2))
        assert torch.equal(out["images"], torch.full((2,), w))
    assert int8_matmul.launches - start == 6 and cache.stats() == {}
    assert registry.snapshot()["obs/compiles"] == 1


def test_graphed_step_carries_theta_through_its_buffers(stubbed, tmp_path):
    """``run_training`` over a stubbed graph: the chained run and the
    unchained one end at the same θ as eager runs, bitwise."""
    kw = dict(num_epochs=5, pop_size=4, member_batch=2, steps_per_dispatch=4)
    graphed, gh = _port_run(port_backend, tmp_path / "g", **kw)
    assert [h["epochs_chained"] for h in gh] == [1, 4] and gh[-1]["obs/compiles"] == 1
    graphs_off = pytest.MonkeyPatch()
    graphs_off.setattr(graphs, "graphs_on", lambda device: False)
    try:
        eager, _ = _port_run(port_backend, tmp_path / "e", **kw)
    finally:
        graphs_off.undo()
    assert len(stubbed) == 1 and torch.equal(_flat(graphed.theta), _flat(eager.theta))


@pytest.fixture(scope="module")
def serve_backend():
    return build_serve_backend(sana_rung_model("tiny")["bcfg"], "off", device="cpu",
                               prompts=["a red cube", "a blue sphere", "a green cone"])


def test_partial_batch_pads_and_equals_solo(serve_backend):
    eng = ServeEngine(serve_backend, ServeConfig(adapter_batch=3, member_batch=0, device="cpu"))
    for aid, th in _adapters(serve_backend, 2).items():
        eng.put_adapter(aid, th)
    reqs = [eng.submit("t0", [0], seed=7), eng.submit("t1", [1], seed=8)]
    res = eng.flush()
    assert [r.request.request_id for r in res] == [r.request_id for r in reqs]
    assert [r.batch_size for r in res] == [2, 2]
    for r in res:
        solo = eng.generate(r.request.adapter_id, r.request.prompt_ids, r.request.seed)
        np.testing.assert_array_equal(solo, r.images)
    assert not np.array_equal(res[0].images, res[1].images)
    st = eng.stats()
    # one slot padded in the batch, two in each solo dispatch; one program for the geometry
    assert st["serve_padded_slots"] == 1 + 2 + 2 and st["serve_compiles"] == 1


def test_dispatch_tax_tiny_row_on_the_cpu(capsys):
    assert dispatch_tax.main(["--rung", "tiny", "--device", "cpu", "--steps", "1", "--chain", "2"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the JAX row's fields for the eager and chained variants
    jax_fields = {"metric", "rung", "pop", "prompts", "member_batch", "base_quant", "steps_timed", "chain",
                  "platform", "device_kind", "sync", "step_time_chained_s", "dispatch_tax_s"}
    assert jax_fields <= set(row) and {"step_time_eager_s", "git_sha", "card", "torch_version"} <= set(row)
    assert row["metric"] == "dispatch_tax" and row["platform"] == "cpu" and row["chain"] == 2
    assert row["step_time_eager_s"] > 0 and row["step_time_chained_s"] > 0
    assert "step_time_single_s" not in row  # no graphs on the CPU
