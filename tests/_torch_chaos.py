"""Launches of the port's train CLI under injected faults on the CPU, for
the two-process resilience tests (``tests/test_torch_chaos_*.py``).

The tiny Sana rung (``--model_scale tiny --device cpu``), population 4,
``member_batch`` 2 (it divides each process's slice), a slot every epoch,
the desync check every epoch, seed 7. Each launch is a
``tools.launch_local.run_pod`` with its own time limit: a stuck rank is
killed, not waited on. The launches of a module run at once, one thread
each."""

import json
import threading
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import pytest

from hyperscalees_t2i_tpu_torch.tools import launch_local

COMMON = ["--backend", "sana_one_step", "--model_scale", "tiny", "--device", "cpu", "--allow_random_rewards", "true",
          "--pop_size", "4", "--member_batch", "2", "--prompts_per_gen", "2", "--save_every", "1",
          "--log_hist_every", "0", "--seed", "7", "--desync_check_every", "1", "--resume", "false"]
# a wall-clock bound for each launch, far above what one takes (seconds)
LAUNCH_S = 240
# keys of a metrics row that read a clock, count what differs between a
# launch and one process by design, or accumulate over the rows a process
# has logged (a resumed or replayed epoch has another history)
CLOCK_KEYS = {"ts", "step_time_s", "images_per_sec", "process_count", "incarnation", "quality/images_cum",
              "quality/hack_streak_max"}


def launch(root: Path, name: str, n: int, *extra: str, grace_s: float = 0.0) -> int:
    return launch_local.run_pod(n, [*COMMON, "--run_dir", str(root), "--run_name", name, *extra],
                                timeout_s=LAUNCH_S, grace_s=grace_s)


def run_all(root: Path, jobs: Dict[str, Callable[[], object]], env: Dict[str, str]) -> Dict[str, object]:
    """Each job at once on a thread of its own, with ``env`` set for the
    children; returns each job's result (an exception is its result)."""
    out: Dict[str, object] = {}

    def run(name, fn):
        try:
            out[name] = fn()
        except Exception as e:  # reported by the test that reads it
            out[name] = e

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("HYPERSCALEES_RETRY_BASE_S", "0")
        mp.delenv("HYPERSCALEES_FAULTS", raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        threads = [threading.Thread(target=run, args=item) for item in jobs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=3 * LAUNCH_S)
    assert all(not t.is_alive() for t in threads)
    return out


def slot(run: Path, epoch: int, store: str = "ckpt", name: str = "theta.npz") -> Dict[str, np.ndarray]:
    with np.load(run / store / f"step_{epoch:08d}" / name) as z:
        return {k: z[k] for k in z.files}


def assert_bitwise(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray], what: str) -> None:
    assert a.keys() == b.keys(), what
    bad = [k for k in a if a[k].tobytes() != b[k].tobytes()]
    assert not bad, f"{what}: differs at {bad[:3]}"


def snapshot(run: Path, rank: int) -> Dict[str, object]:
    return json.loads((run / f"resilience.host{rank}.json").read_text())


def latest(run: Path, store: str = "ckpt") -> str:
    return (run / store / "latest").read_text().strip()


def invalid(run: Path, store: str):
    return sorted(p.name.rsplit("-", 1)[0] for p in (run / store).iterdir() if p.name.startswith(".invalid-"))


def rows_equal(a: dict, b: dict, what: str) -> None:
    """Two metrics rows bitwise on every number both carry (clock readings,
    counters and gauges aside)."""
    keys = {k for k in set(a) & set(b) if k not in CLOCK_KEYS and not k.startswith(("obs/", "resilience/", "anomaly/"))}
    assert {"theta_norm", "delta_norm", "opt_score_mean", "es/update_cosine"} <= keys, what
    bad = [k for k in sorted(keys) if a[k] != b[k]]
    assert not bad, f"{what}: rows differ at {bad[:5]}"
