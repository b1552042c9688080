"""The host-sharded epoch (``train.trainer.make_host_sharded_programs``) and
its settings in one process, against the JAX package on the CPU.

- The port's eval-slice and update programs, run slice by slice in one
  process (members [0, 2) and [2, 4) of a population of 4) with the
  slices' reward rows concatenated, against the JAX programs run the same
  way, on ``tests/test_torch_trainer.py``'s tiny Sana backend (weights and
  prompt embeddings carried across by ``weights.from_jax``; θ₀, the ES
  noise and the latents the port's own draws of the JAX stream): reward
  rows, θ′, Δθ and scores within 3e-4. The port's concatenated rows and θ′
  are bitwise its one-program ``make_es_step`` (``member_batch`` 2 divides
  the slices). A slice out of range raises with the JAX text.
- ``pop_host_shard=on`` in one process trains through the split programs
  (the gather is the identity) bitwise as the one-program loop, and records
  ``pop_host_shard`` in its slot; ``pop_shard_update=on`` in one process
  raises (no pop axis to shard over), as the JAX plan does.
- The launch's refusals through ``tools.launch_local`` at 2 CPU
  processes: a population that 2 does not divide (both numbers named) and
  ``--pop_host_shard off``.
- Hosts of several processes (``launch_local --devices_per_process 2``):
  one host of two processes on the data axis trains bitwise as one
  process (three images padded to four), two hosts of two within 3e-4 of
  it (chunks of one member where one process runs two); both commit every
  process's slot store with the topology's ``pop_shards``, write a trace
  segment a process, ``pod_summary.json`` and the reports' Pod section and
  panel; the data-axis slot reshards into one process; ``--pop_shards``
  above a host's processes or not dividing them (the JAX CLI's warning,
  then a refusal: a process cannot sit out) and a population the hosts do
  not divide are refused with the JAX CLI's texts.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.base import make_frozen as jmake_frozen
from hyperscalees_t2i_tpu.es.sampling import epoch_key as jepoch_key
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import make_host_sharded_programs as jmake_host_sharded_programs
from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key
from hyperscalees_t2i_tpu_torch.parallel.pop_eval import make_population_evaluator
from hyperscalees_t2i_tpu_torch.tools import launch_local
from hyperscalees_t2i_tpu_torch.train import trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils import pytree
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows

from test_torch_trainer import PARITY, TOL, _jax_backend, _np, brightness, jax_brightness, port_backend

torch.set_num_threads(1)
SLICES = [(0, 2), (2, 2)]


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree_util.tree_leaves(tree)])


def test_programs_slice_by_slice_match_jax(tmp_path):
    jb = _jax_backend(tmp_path)
    jb.setup()
    jtc = JTrainConfig(run_dir=str(tmp_path), **PARITY)
    tc = TrainConfig(run_dir=str(tmp_path), **PARITY)
    pb = port_backend(jb)
    pb.setup()
    info = jb.step_info(0, tc.prompts_per_gen, tc.batches_per_gen)
    m, r = len(info.unique_ids), info.repeats
    ids = list(info.flat_ids)
    # the JAX programs, slice by slice
    frozen = jmake_frozen(jb, jax_brightness)
    jtheta = jb.init_theta(jax.random.fold_in(jax.random.PRNGKey(jtc.seed), 17))
    jkey = jepoch_key(jtc.seed, 0)
    jids = jnp.asarray(np.asarray(ids, np.int32))
    jrows, upd = [], None
    for sl in SLICES:
        ev, upd = jmake_host_sharded_programs(jb, jax_brightness, jtc, m, r, None, sl)
        jrows.append(_np(ev(frozen, jtheta, jids, jkey)))
    jfull = {k: np.concatenate([rw[k] for rw in jrows]) for k in jrows[0]}
    jzeros = jax.tree_util.tree_map(jnp.zeros_like, jtheta)
    jtheta_new, jdelta, jmetrics, jscores = upd(jax.tree_util.tree_map(jnp.copy, jtheta), jzeros,
                                                {k: jnp.asarray(v) for k, v in jfull.items()}, jkey)
    # the port's, the same way
    theta = trainer._init_theta(pb, tc, torch.device("cpu"))
    key = epoch_key(tc.seed, 0, "cpu")
    rows, up = [], None
    for sl in SLICES:
        ev, up = trainer.make_host_sharded_programs(pb, brightness, tc, m, r, sl, "cpu")
        rows.append({k: v.numpy() for k, v in ev(theta, ids, key).items()})
        assert all(v.shape == (sl[1], m * r) for v in rows[-1].values())
    full = {k: np.concatenate([rw[k] for rw in rows]) for k in rows[0]}
    assert set(full) == set(jfull)
    for k in full:
        np.testing.assert_allclose(full[k], jfull[k], err_msg=k, **TOL)
    zeros = pytree.tree_map(torch.zeros_like, theta)
    theta_new, delta, metrics, scores = up(theta, zeros, full, key)
    assert not up.sharded
    np.testing.assert_allclose(_flat(pytree.tree_map(lambda t: t.numpy(), theta_new)), _flat(jtheta_new), **TOL)
    np.testing.assert_allclose(_flat(pytree.tree_map(lambda t: t.numpy(), delta)), _flat(jdelta), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), **TOL)
    for k in ("opt_score_mean", "theta_norm", "delta_norm", "reward/combined_mean"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, **TOL)
    # the one-program step on the same θ and key: bitwise
    step = trainer.make_es_step(pb, brightness, tc, m, r, "cpu", stateful_delta=True)
    one_theta, one_delta, one_metrics, one_scores = step(theta, zeros, ids, key)
    assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(one_theta), pytree.tree_leaves(theta_new)))
    assert torch.equal(one_scores, scores) and torch.equal(one_metrics["theta_norm"], metrics["theta_norm"])


def test_a_slice_out_of_range_raises_with_the_jax_text():
    with pytest.raises(ValueError, match=r"host_slice=\(3, 2\) out of range for pop_size=4"):
        make_population_evaluator(None, None, 4, TrainConfig().es_config(), 1, host_slice=(3, 2))


def _tc(tmp_path, **kw):
    return TrainConfig(**{**PARITY, "run_dir": str(tmp_path / "runs"), "run_name": "r", "quality": False, **kw})


def test_pop_host_shard_on_alone_trains_as_the_one_program_loop(tmp_path):
    plain = trainer.run_training(port_backend(), brightness, _tc(tmp_path / "plain"), device="cpu")
    split = trainer.run_training(port_backend(), brightness, _tc(tmp_path / "split", pop_host_shard="on"),
                                 device="cpu")
    assert split.epoch == plain.epoch == 2
    assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(split.theta), pytree.tree_leaves(plain.theta)))
    run = tmp_path / "split/runs/r"
    manifest = json.loads((run / "ckpt/step_00000002/manifest.json").read_text())
    assert manifest["topology"] == {"process_count": 1, "pop_shards": 1, "pop_size": 4, "pop_host_shard": True}
    rows = read_jsonl_rows(run / "metrics.jsonl")
    assert [r["epoch"] for r in rows] == [0, 1] and "process_count" not in rows[-1]
    labels = [r["label"] for r in read_jsonl_rows(run / "programs.jsonl")]
    assert labels == ["es_eval_slice_m2r1", "es_update_m2r1"]
    assert json.loads((run / "resilience.host0.json").read_text())["epoch"] == 2


def test_pop_shard_update_on_alone_raises_as_the_jax_plan(tmp_path):
    with pytest.raises(ValueError, match="pop_shard_update=on needs a pop axis of size > 1"):
        trainer.run_training(port_backend(), brightness, _tc(tmp_path, pop_shard_update="on"), device="cpu")


TINY = ["--backend", "sana_one_step", "--model_scale", "tiny", "--device", "cpu", "--num_epochs", "1",
        "--allow_random_rewards", "true", "--prompts_per_gen", "2"]


@pytest.mark.parametrize("extra, want", [
    (["--pop_size", "5"], "needs --pop_size divisible by the process count (5 % 2 != 0)"),
    (["--pop_size", "4", "--pop_host_shard", "off"], "--pop_host_shard off with 2 processes"),
])
def test_two_process_refusals(tmp_path, capfd, extra, want):
    rc = launch_local.main(["--num_processes", "2", "--timeout_s", "100", "--",
                            *TINY, "--run_dir", str(tmp_path), *extra])
    err = capfd.readouterr().err
    assert rc == 1, err[-2000:]
    assert f"[p0] ERROR: " in err and f"[p1] ERROR: " in err and want in err
    assert not (tmp_path / "sana_one_step_pop5_sig0.01_lr1.0_r4_m2x1_anti_pn").exists()


# --devices_per_process: hosts of several processes (the data axis)
HOSTS_ARGV = ["--backend", "sana_one_step", "--model_scale", "tiny", "--device", "cpu", "--num_epochs", "2",
              "--allow_random_rewards", "true", "--pop_size", "4", "--prompts_per_gen", "3", "--member_batch", "2",
              "--save_every", "1", "--run_name", "cli", "--resume", "false", "--trace", "true",
              "--pop_shard_update", "off"]
# name: (hosts, processes a host, extra flags)
HOST_LAUNCHES = {"one": (1, 1, []), "data2": (1, 2, ["--pop_shards", "1"]), "hosts2x2": (2, 2, [])}
SLOT2 = "ckpt/step_00000002"


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def host_launches(tmp_path_factory):
    """One process, one host of two processes on the data axis (``--pop_shards
    1``: pop 1 × data 2, three images padded to four) and two hosts of two
    (pop 2 × data 1 each), at once, each with a time limit; then one process
    resumes the data-axis launch's slot for a third epoch (``--resume auto
    --on_topology_mismatch reshard``)."""
    import threading

    root = tmp_path_factory.mktemp("hosts")
    rcs = {}

    def run(name, hosts, per_host, extra):
        rcs[name] = launch_local.run_pod(hosts, [*HOSTS_ARGV, "--run_dir", str(root / name), *extra],
                                         timeout_s=150, devices_per_process=per_host)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        threads = [threading.Thread(target=run, args=(name, *spec)) for name, spec in HOST_LAUNCHES.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert all(not t.is_alive() for t in threads)
        assert rcs == {name: 0 for name in HOST_LAUNCHES}, rcs
        resumed = list(HOSTS_ARGV)
        resumed[resumed.index("--num_epochs") + 1] = "3"
        resumed[resumed.index("--resume") + 1] = "auto"
        rcs["resume"] = launch_local.run_pod(1, [*resumed, "--run_dir", str(root / "data2"), "--on_topology_mismatch",
                                                 "reshard"], timeout_s=120)
    assert rcs["resume"] == 0
    return root


@pytest.mark.parametrize("name", ["data2", "hosts2x2"])
def test_hosts_of_processes_train_as_one_process(host_launches, name):
    one = _npz(host_launches / "one" / "cli" / SLOT2 / "theta.npz")
    got = _npz(host_launches / name / "cli" / SLOT2 / "theta.npz")
    assert set(got) == set(one)
    gap = max(float(np.abs(got[k] - one[k]).max()) for k in one)
    print(f"{name}: θ after 2 epochs, max |launch - one process| {gap:.3g}")
    if name == "data2":  # the same member chunks; each image in its global position
        assert all(got[k].tobytes() == one[k].tobytes() for k in one)
    else:  # one member a process: chunks of one lane where one process runs two
        for k in one:
            np.testing.assert_allclose(got[k], one[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name, procs, pop_shards", [("data2", 2, 1), ("hosts2x2", 4, 2)])
def test_hosts_of_processes_commit_trace_and_report(host_launches, capsys, name, procs, pop_shards):
    from hyperscalees_t2i_tpu_torch.tools import run_report, trace_report

    run = host_launches / name / "cli"
    topo = json.loads((run / SLOT2 / "manifest.json").read_text())["topology"]
    assert topo["process_count"] == procs and topo["pop_shards"] == pop_shards
    # the coordinated commit: every process's store
    assert all((run / (f"ckpt.host{i}" if i else "ckpt") / "step_00000002").is_dir() for i in range(procs))
    assert (run / SLOT2).is_dir()
    assert sorted(p.name for p in run.glob("trace*.jsonl")) == sorted(
        ["trace.jsonl"] + [f"trace.{i}.jsonl" for i in range(1, procs)])
    summary = json.loads((run / "pod_summary.json").read_text())
    assert summary["n_hosts"] == procs and summary["n_epochs_aligned"] >= 2
    assert trace_report.main([str(run)]) == 0
    assert "## pod" in capsys.readouterr().out
    assert run_report.main([str(run), "--out", str(run.parent / "report.html")]) == 0
    assert "<h2>Pod</h2>" in (run.parent / "report.html").read_text()


def test_a_data_axis_slot_reshards_into_one_process(host_launches):
    run = host_launches / "data2" / "cli"
    assert json.loads((run / "ckpt/step_00000003/manifest.json").read_text())["topology"]["process_count"] == 1
    transitions = json.loads((run / "elastic.json").read_text())
    assert transitions[-1]["kind"] == "reshard_restore"
    assert transitions[-1]["from"]["process_count"] == 2 and transitions[-1]["to"]["process_count"] == 1
    assert [r["epoch"] for r in read_jsonl_rows(run / "metrics.jsonl")][-1] == 2


@pytest.mark.parametrize("hosts, per_host, extra, want", [
    (1, 2, ["--pop_shards", "3"], "ERROR: --pop_shards 3 > 2 available devices"),
    (1, 3, ["--pop_shards", "2"], "WARNING: pop_shards=2 does not divide 3 devices; 1 devices idle"),
    (2, 2, ["--pop_size", "5"], "needs --pop_size divisible by the process count (5 % 2 != 0)"),
])
def test_hosts_of_processes_refusals(tmp_path, capfd, hosts, per_host, extra, want):
    rc = launch_local.main(["--num_processes", str(hosts), "--devices_per_process", str(per_host), "--timeout_s",
                            "100", "--", *TINY, "--run_dir", str(tmp_path), *extra])
    err = capfd.readouterr().err
    assert rc == 1 and want in err, err[-2000:]
