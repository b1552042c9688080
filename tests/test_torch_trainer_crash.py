"""A one-process run that dies, then resumes, against the JAX
``run_training`` on the CPU (the helpers of
``tests/test_torch_trainer_faults.py``).

``torn_write@1;crash@1``: slot 1 is torn between its rename and its
publication, and epoch 1 dies before slot 2 (``SimulatedCrash``, in both
packages). The resume, with no faults, rejects the torn slot
(``restore_rejected``), falls back to the legacy mirror (θ of epoch 1, no
Δθ) and runs epochs 1 and 2. The rows of both runs, every slot's θ and the
final θ agree within 3e-4; the slot lists, the markers and every
``resilience/*`` counter are the JAX run's.
"""

import torch

from hyperscalees_t2i_tpu.resilience.faultinject import SimulatedCrash as JSimulatedCrash
from hyperscalees_t2i_tpu_torch.resilience.faultinject import SimulatedCrash
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows

from test_torch_trainer_faults import assert_runs_match, assert_theta_close, run_both

torch.set_num_threads(1)


def test_torn_write_and_crash_then_resume_match_jax(tmp_path, monkeypatch):
    crash = (JSimulatedCrash, SimulatedCrash)
    out = run_both(tmp_path, monkeypatch, [(dict(faults="torn_write@1;crash@1"), (crash, "injected crash at epoch 1")),
                                           (dict(), None)])
    (jdir, (jstate,)), (pdir, (pstate,)) = out["jax"], out["port"]
    assert (pstate.epoch, pstate.preempted, pstate.rollbacks) == (jstate.epoch, jstate.preempted, jstate.rollbacks) \
        == (3, False, 0)
    assert assert_runs_match(jdir, pdir) < 3e-4
    rows = read_jsonl_rows(pdir / "metrics.jsonl")
    assert [(r["epoch"], r["incarnation"]) for r in rows] == [(0, 0), (1, 0), (1, 1), (2, 1)]
    assert rows[-1]["resilience/restore_rejected"] == 1
    assert (pdir / "ckpt/latest").read_text().strip() == "step_00000003"
    assert_theta_close(pstate, jstate)
