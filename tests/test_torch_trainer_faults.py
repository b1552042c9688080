"""One-process ``run_training`` under injected faults, against the JAX
``run_training`` with the same faults on the CPU.

The tiny Sana backend of ``tests/test_torch_trainer.py`` (its weights and
prompt embeddings carried across), 3 epochs, a slot every epoch, the port
from its seed alone (nothing injected: its θ₀ and draws are the JAX
stream's). One plan, ``io_error:ckpt_write*2;nan_theta@1;preempt@1``: the
first slot's write fails twice and is retried, epoch 1's θ turns NaN and
rolls back to slot 1 (σ halved, programs built again), the replayed epoch
1 ends preempted (slot 2, ``preempted.json``). Every row's shared keys, the
slots' θ and the final θ agree within 3e-4; the markers, the slot lists and
every ``resilience/*`` counter are the JAX run's. ``crash@1`` with
``torn_write@1``, then a resume, is ``tests/test_torch_trainer_crash.py``.
"""

import json

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.resilience.checkpoints import flatten_with_paths as jflatten_with_paths
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import run_training as jrun_training
from hyperscalees_t2i_tpu_torch.train import trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows
from hyperscalees_t2i_tpu_torch.utils.pytree import flatten_with_paths

from test_torch_trainer import CLOCK_KEYS, TOL, _jax_backend, brightness, jax_brightness, port_backend

torch.set_num_threads(1)
FAULT_RUN = dict(num_epochs=3, pop_size=4, sigma=0.05, lr_scale=1.0, egg_rank=2, prompts_per_gen=2, member_batch=2,
                 save_every=1, quality=True, seed=3, run_name="faults")


def run_both(tmp_path, monkeypatch, runs):
    """Each ``(config overrides, expected exception or None)`` of ``runs``
    in turn, in the JAX package and in the port, on one run dir each."""
    monkeypatch.setenv("HYPERSCALEES_RETRY_BASE_S", "0")
    jb = _jax_backend(tmp_path)
    out = {}
    for pkg in ("jax", "port"):
        states = []
        for over, exc in runs:
            cfg = {**FAULT_RUN, **over, "run_dir": str(tmp_path / pkg)}
            if pkg == "jax":
                go = lambda: jrun_training(jb, jax_brightness, JTrainConfig(**cfg))  # noqa: E731
            else:
                go = lambda: trainer.run_training(port_backend(jb), brightness, TrainConfig(**cfg),  # noqa: E731
                                                  device="cpu")
            if exc is None:
                states.append(go())
            else:
                with pytest.raises(exc[0], match=exc[1]):
                    go()
        out[pkg] = (tmp_path / pkg / FAULT_RUN["run_name"], states)
    return out


def assert_runs_match(jdir, pdir):
    jrows, prows = read_jsonl_rows(jdir / "metrics.jsonl"), read_jsonl_rows(pdir / "metrics.jsonl")
    assert [r["epoch"] for r in prows] == [r["epoch"] for r in jrows]
    worst = 0.0
    for jr, pr in zip(jrows, prows):
        res = {k for k in set(jr) | set(pr) if k.startswith("resilience/")}
        assert {k: pr.get(k) for k in res} == {k: jr.get(k) for k in res}, pr["epoch"]
        for k in sorted(set(jr) & set(pr)):
            if k in CLOCK_KEYS or k == "prompts" or isinstance(jr[k], dict) or k.startswith("resilience/"):
                continue
            a, b = np.asarray(pr[k], np.float64), np.asarray(jr[k], np.float64)
            np.testing.assert_allclose(a, b, err_msg=f"epoch {pr['epoch']} {k}", **TOL)
            worst = max(worst, float(np.nanmax(np.abs(a - b))) if a.size and not np.isnan(a).all() else 0.0)
    for store in ("ckpt",):
        jslots = sorted(p.name for p in (jdir / store).iterdir())
        assert sorted(p.name for p in (pdir / store).iterdir()) == jslots
        for slot in (s for s in jslots if s.startswith("step_")):
            try:
                np.load(jdir / store / slot / "theta.npz").close()
            except Exception:  # torn in the JAX run: torn the same way in the port's
                with pytest.raises(Exception):
                    np.load(pdir / store / slot / "theta.npz").close()
                continue
            with np.load(jdir / store / slot / "theta.npz") as jz, np.load(pdir / store / slot / "theta.npz") as pz:
                assert set(jz.files) == set(pz.files)
                for k in jz.files:
                    np.testing.assert_allclose(pz[k], jz[k], err_msg=f"{slot} {k}", **TOL)
                    worst = max(worst, float(np.abs(pz[k] - jz[k]).max()))
            jm = json.loads((jdir / store / slot / "manifest.json").read_text())
            pm = json.loads((pdir / store / slot / "manifest.json").read_text())
            assert (pm["epoch"], pm["topology"], pm["config"]["sigma"], pm["config"]["_rollbacks"]) == \
                (jm["epoch"], jm["topology"], jm["config"]["sigma"], jm["config"]["_rollbacks"])
    for marker in ("preempted.json", "halted.json"):
        assert (pdir / marker).exists() == (jdir / marker).exists()
        if (jdir / marker).exists():
            jmk, pmk = json.loads((jdir / marker).read_text()), json.loads((pdir / marker).read_text())
            assert {k: v for k, v in pmk.items() if k != "wall_time"} == \
                {k: v for k, v in jmk.items() if k != "wall_time"}
    jsnap = json.loads((jdir / "resilience.host0.json").read_text())
    psnap = json.loads((pdir / "resilience.host0.json").read_text())
    drop = ("wall_time",)
    assert {k: v for k, v in psnap.items() if k not in drop} == {k: v for k, v in jsnap.items() if k not in drop}
    print(f"max abs error over the rows and slots: {worst:.3g}")
    return worst


def test_retry_rollback_and_preempt_faults_match_jax(tmp_path, monkeypatch):
    out = run_both(tmp_path, monkeypatch, [(dict(faults="io_error:ckpt_write*2;nan_theta@1;preempt@1"), None)])
    (jdir, (jstate,)), (pdir, (pstate,)) = out["jax"], out["port"]
    assert (pstate.epoch, pstate.preempted, pstate.halted, pstate.rollbacks) == \
        (jstate.epoch, jstate.preempted, jstate.halted, jstate.rollbacks) == (2, True, False, 1)
    assert assert_runs_match(jdir, pdir) < 3e-4
    row = read_jsonl_rows(pdir / "metrics.jsonl")[-1]
    assert row["resilience/faults_injected"] == 4 and row["resilience/retry/ckpt_write"] == 2
    assert row["resilience/rollbacks"] == 1 and [r["epoch"] for r in read_jsonl_rows(pdir / "metrics.jsonl")] == \
        [0, 1, 1]
    assert json.loads((pdir / "preempted.json").read_text())["reason"] == "fault-injection preempt@1"
    assert_theta_close(pstate, jstate)


def assert_theta_close(pstate, jstate):
    jflat, pflat = jflatten_with_paths(jstate.theta), flatten_with_paths(pstate.theta)
    assert jflat.keys() == pflat.keys()
    for k in jflat:
        np.testing.assert_allclose(pflat[k], jflat[k], err_msg=k, **TOL)
